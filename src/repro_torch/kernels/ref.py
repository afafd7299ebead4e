"""The literal paper computation (Algorithm 1) and its VJP as oracles for
tests: scatter the n coefficients into a dense spectral matrix, `ifft2`,
real part, scale by α; the gradient is the real part of `fft2` of the
cotangent sampled at the entries. The kernels and the plain versions must
match them up to float tolerance."""
from __future__ import annotations

import torch


def deltaw_ref(c: torch.Tensor, entries: torch.Tensor, d1: int, d2: int,
               alpha: float) -> torch.Tensor:
    """c (n,) or stacked (L, n) f32, entries (2, n) int -> ΔW (d1, d2) or
    (L, d1, d2) f32."""
    e = entries.to(device=c.device, dtype=torch.int64)
    dense = torch.zeros(c.shape[:-1] + (d1, d2), dtype=torch.complex64,
                        device=c.device)
    dense[..., e[0], e[1]] = c.to(torch.complex64)
    return (alpha * torch.fft.ifft2(dense).real).to(torch.float32)


def dc_ref(g: torch.Tensor, entries: torch.Tensor,
           alpha: float) -> torch.Tensor:
    """VJP oracle: dL/dc_i = α/(d1·d2) Σ_jk g[j,k]·cos(2π(j·u_i/d1 + k·v_i/d2)),
    i.e. the real part of the forward FFT of g at the entries.
    g (d1, d2) or stacked (L, d1, d2) -> (n,) or (L, n) f32."""
    d1, d2 = g.shape[-2:]
    e = entries.to(device=g.device, dtype=torch.int64)
    spec = torch.fft.fft2(g.to(torch.complex64))
    return (alpha / (d1 * d2)) * spec[..., e[0], e[1]].real.to(torch.float32)
