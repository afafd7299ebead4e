"""DCT ΔW materialization (K4) and its VJP with respect to the coefficients
(K5): the hand-written Hopper kernels and their plain PyTorch versions.

Replaces the TPU kernels `deltaw_pallas` and `dc_pallas` in
src/repro/kernels/dct_deltaw.py (the LoCA-style `dct` method). Both kernels
live in `csrc/dct_deltaw.cu`. They are FFT-structured like K1 and K2 and
share their passes (`csrc/fft_rows.cuh`), their in-place transform of
length d2 per pair of rows (`csrc/fft_smem.cuh`) and their host plan
(`fft_plan`, the same plan for a site): a DCT of length d2 is a complex
transform of length d2 with a permutation and the twiddle exp(iπv/2d2)
(the source's header says how), so each kernel reads or writes ΔW or g
once. Their row factors and twiddles come from K1's table at length 4d
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
wrapper computes the plain version, at any shape. For any other tensor it
first takes the plan, which raises ValueError naming the limit a shape
breaks (`fft_plan`: d2 ≤ 29056 with odd prime factors ≤ 63, d1 ≤ 65535,
and for K4 n ≤ 16384), then launches the kernel on a CUDA tensor or
raises: nothing falls back to the plain version off the CPU.
`kernels.ops.DCTDeltaW` is the autograd Function whose forward is `deltaw`
and whose backward is `dc`.
"""
from __future__ import annotations

import torch

from repro_torch.core.adapter import dct_bases, dct_delta
from repro_torch.kernels import custom_ops
from repro_torch.kernels import fft_plan as fp
from repro_torch.kernels import fourier_deltaw as fdk

NC = 16                 # the kernels' chunk of entries: n must divide by it

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


def _tables(d1: int, d2: int, dev: torch.device):
    """The row factors' cos table cos(πp/2d1), p < 4d1; the (cos, sin) of
    exp(iπv/2d2), v < 4d2; the transform's positions and stage twiddles."""
    return (fdk.twiddles(4 * d1, dev)[0], *fdk.twiddles(4 * d2, dev),
            *fdk.fft_tables(d2, dev))


def deltaw(c: torch.Tensor, u: torch.Tensor, v: torch.Tensor, d1: int,
           d2: int, alpha: float) -> torch.Tensor:
    """ΔW (L, d1, d2) f32 for stacked coefficients c (L, n): the plain
    version on the CPU, the CUDA kernel (one launch for the stack: the
    scatter plan, then the row transforms) on the card."""
    fdk.check_coefficients(c, u, v, d1, d2, NC)
    if c.device.type == "cpu":
        return deltaw_reference(c, u, v, d1, d2, alpha)
    plan = fp.fft_plan(d1, d2, c.shape[1])
    if c.device.type != "cuda":
        raise ValueError(f"no DCT deltaw kernel for device {c.device}")
    if custom_ops.is_fake(c, u, v):
        return custom_ops.op("dct_deltaw")(c, u, v, d1, d2, alpha)
    return _deltaw_launch(c, u, v, d1, d2, alpha, plan)


def _deltaw_launch(c, u, v, d1: int, d2: int, alpha: float, plan=None):
    L, n = c.shape
    plan = plan or fp.fft_plan(d1, d2, n)
    from repro_torch.kernels import build
    lib = build.library("dct_deltaw")
    global launches
    dev = c.device
    out = torch.empty((L, d1, d2), dtype=torch.float32, device=dev)
    # pass 0's bins, rounds and slots, then each slot's s·c·φ per layer
    # (`Scatter` in csrc/fft_rows.cuh)
    scratch = torch.empty((2 * d2 + 12 * n + 8 + 4 * L * n,),
                          dtype=torch.int32, device=dev)
    cos1, phic, phis, pos, tw = _tables(d1, d2, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dct_deltaw_launch(
            c.data_ptr(), u.data_ptr(), v.data_ptr(), cos1.data_ptr(),
            phic.data_ptr(), phis.data_ptr(), tw.data_ptr(), pos.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), fdk.plan_ints(plan), L, n,
            d1, d2, float(alpha / (d1 * d2)), stream)
    build.check(code, "dct_deltaw_launch")
    launches += 1
    return out


def dc(g: torch.Tensor, u: torch.Tensor, v: torch.Tensor, d1: int, d2: int,
       alpha: float) -> torch.Tensor:
    """dc (L, n) f32 for the stacked cotangent g (L, d1, d2): the plain
    version on the CPU, the CUDA kernel (one launch for the stack: partial
    sums per row block, then a fixed-order reduction) on the card."""
    fdk.check_cotangent(g, u, v, d1, d2, NC)
    if g.device.type == "cpu":
        return dc_reference(g, u, v, d1, d2, alpha)
    plan = fp.fft_plan(d1, d2)          # K5, like K2, takes any n
    if g.device.type != "cuda":
        raise ValueError(f"no DCT dc kernel for device {g.device}")
    if custom_ops.is_fake(g, u, v):
        return custom_ops.op("dct_dc")(g, u, v, d1, d2, alpha)
    return _dc_launch(g, u, v, d1, d2, alpha)


def _dc_launch(g, u, v, d1: int, d2: int, alpha: float):
    L, n = g.shape[0], u.shape[0]
    plan = fp.fft_plan(d1, d2)
    from repro_torch.kernels import build
    lib = build.library("dct_deltaw")
    global dc_launches
    dev = g.device
    out = torch.empty((L, n), dtype=torch.float32, device=dev)
    # the row blocks' partial sums, then the entry table (places, u, s·φ)
    partial = torch.empty((plan.k2_row_blocks * L * n + 4 * n,),
                          dtype=torch.float32, device=dev)
    cos1, phic, phis, pos, tw = _tables(d1, d2, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dct_dc_launch(
            g.data_ptr(), u.data_ptr(), v.data_ptr(), cos1.data_ptr(),
            phic.data_ptr(), phis.data_ptr(), tw.data_ptr(), pos.data_ptr(),
            partial.data_ptr(), out.data_ptr(), fdk.plan_ints(plan), L, n,
            d1, d2, float(alpha / (d1 * d2)), stream)
    build.check(code, "dct_dc_launch")
    dc_launches += 1
    return out


custom_ops.define_deltaw_pair("dct", _deltaw_launch, _dc_launch)
