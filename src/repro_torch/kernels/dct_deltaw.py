"""DCT ΔW materialization (K4) and its VJP with respect to the coefficients
(K5): the hand-written Hopper kernels and their plain PyTorch versions.

Replaces the TPU kernels `deltaw_pallas` and `dc_pallas` in
src/repro/kernels/dct_deltaw.py (the LoCA-style `dct` method). Both kernels
live in `csrc/dct_deltaw.cu`, whose header says what bounds them on the
card; they read their cosines from K1's twiddle table at length 4d
(`fourier_deltaw.twiddles`). This module holds the wrappers and the plain
versions they are held against. The contract is `fourier_deltaw`'s:

    deltaw(c, u, v, d1, d2, alpha) -> (L, d1, d2) f32
        c (L, n) f32 with n a multiple of NC (zero-padded, c = 0 there),
        u, v (n,) int32 entries on c's device (the kernels reduce them
        modulo 4d, so the phase is exact for any integer entry);
        ΔW[l,j,k] = alpha/(d1·d2) · Σ_e c[l,e]·C1[j,e]·C2[k,e].
    dc(g, u, v, d1, d2, alpha) -> (L, n) f32
        g (L, d1, d2) f32 cotangent of ΔW, contiguous and unpadded;
        dc[l,e] = alpha/(d1·d2) · Σ_j C1[j,e] · (g[l] @ C2)[j,e].

C1 (d1, n) and C2 (d2, n) are `core.adapter.dct_bases`. For a CPU tensor a
wrapper computes the plain version; for a CUDA tensor it launches the
kernel or raises. `kernels.ops.DCTDeltaW` is the autograd Function whose
forward is `deltaw` and whose backward is `dc`.
"""
from __future__ import annotations

import torch

from repro_torch.core.adapter import dct_bases, dct_delta
from repro_torch.kernels import fourier_deltaw as fdk

NC = 16                 # the kernels' chunk of entries: n must divide by it
MAX_DIM = 1 << 28       # the kernels' phase walk: 4d and p + 2u stay < 2^31

launches = 0            # kernel launches made by `deltaw` (chip_smoke reads it)
dc_launches = 0         # kernel launches made by `dc`


def deltaw_reference(c: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     d1: int, d2: int, alpha: float) -> torch.Tensor:
    """The plain version: the bases, then one f32 `torch.matmul` per
    stack, (C1 ⊙ c) @ C2ᵀ."""
    return dct_delta(c, torch.stack([u, v]), d1, d2, alpha)


def dc_reference(g: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 d1: int, d2: int, alpha: float) -> torch.Tensor:
    """The plain version of `dc`: the bases, one f32 `torch.matmul`
    contracting k, then the C1-weighted sum over j."""
    c1, c2 = dct_bases(torch.stack([u, v]), d1, d2)
    dc = ((g.to(torch.float32) @ c2) * c1).sum(dim=-2)
    return dc * (alpha / (d1 * d2))


def _check_dims(d1: int, d2: int) -> None:
    if max(d1, d2) > MAX_DIM:
        raise ValueError(f"grid {d1}x{d2}: the DCT kernels take d ≤ "
                         f"{MAX_DIM} (their 32-bit phase walk)")


def _tables(d1: int, d2: int, dev: torch.device):
    """cos(π p / 2d) for p < 4d, both axes: K1's cos table at length 4d."""
    return fdk.twiddles(4 * d1, dev)[0], fdk.twiddles(4 * d2, dev)[0]


def deltaw(c: torch.Tensor, u: torch.Tensor, v: torch.Tensor, d1: int,
           d2: int, alpha: float) -> torch.Tensor:
    """ΔW (L, d1, d2) f32 for stacked coefficients c (L, n): the plain
    version on the CPU, the CUDA kernel (one launch for the stack) on the
    card."""
    fdk.check_coefficients(c, u, v, d1, d2, NC)
    if c.device.type == "cpu":
        return deltaw_reference(c, u, v, d1, d2, alpha)
    if c.device.type != "cuda":
        raise ValueError(f"no DCT deltaw kernel for device {c.device}")
    _check_dims(d1, d2)
    from repro_torch.kernels import build
    lib = build.library("dct_deltaw")
    global launches
    L, n = c.shape
    dev = c.device
    out = torch.empty((L, d1, d2), dtype=torch.float32, device=dev)
    cos1, cos2 = _tables(d1, d2, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dct_deltaw_launch(
            c.data_ptr(), u.data_ptr(), v.data_ptr(), cos1.data_ptr(),
            cos2.data_ptr(), out.data_ptr(), L, n, d1, d2,
            float(alpha / (d1 * d2)), stream)
    build.check(code, "dct_deltaw_launch")
    launches += 1
    return out


def dc(g: torch.Tensor, u: torch.Tensor, v: torch.Tensor, d1: int, d2: int,
       alpha: float) -> torch.Tensor:
    """dc (L, n) f32 for the stacked cotangent g (L, d1, d2): the plain
    version on the CPU, the CUDA kernel (one launch for the stack: partial
    sums per 128-row block, then a fixed-order reduction) on the card."""
    fdk.check_cotangent(g, u, v, d1, d2, NC)
    if g.device.type == "cpu":
        return dc_reference(g, u, v, d1, d2, alpha)
    if g.device.type != "cuda":
        raise ValueError(f"no DCT dc kernel for device {g.device}")
    _check_dims(d1, d2)
    from repro_torch.kernels import build
    lib = build.library("dct_deltaw")
    global dc_launches
    L, n = g.shape[0], u.shape[0]
    dev = g.device
    out = torch.empty((L, n), dtype=torch.float32, device=dev)
    partial = torch.empty((-(-d1 // 128), L, n), dtype=torch.float32,
                          device=dev)
    cos1, cos2 = _tables(d1, d2, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dct_dc_launch(
            g.data_ptr(), u.data_ptr(), v.data_ptr(), cos1.data_ptr(),
            cos2.data_ptr(), partial.data_ptr(), out.data_ptr(), L, n, d1,
            d2, float(alpha / (d1 * d2)), stream)
    build.check(code, "dct_dc_launch")
    dc_launches += 1
    return out
