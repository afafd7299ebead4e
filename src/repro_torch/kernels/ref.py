"""The literal paper computation (Algorithm 1) as an oracle for tests:
scatter the n coefficients into a dense spectral matrix, `ifft2`, real
part, scale by α. The kernels and the plain versions must match it up to
float tolerance."""
from __future__ import annotations

import torch


def deltaw_ref(c: torch.Tensor, entries: torch.Tensor, d1: int, d2: int,
               alpha: float) -> torch.Tensor:
    """c (n,) f32, entries (2, n) int -> ΔW (d1, d2) f32."""
    dense = torch.zeros((d1, d2), dtype=torch.complex64, device=c.device)
    e = entries.to(device=c.device, dtype=torch.int64)
    dense[e[0], e[1]] = c.to(torch.complex64)
    return (alpha * torch.fft.ifft2(dense).real).to(torch.float32)
