"""FourierFT ΔW materialization (K1) and its VJP with respect to the
coefficients (K2): the hand-written Hopper kernels and their plain PyTorch
versions.

Replaces the TPU kernels `deltaw_pallas` and `dc_pallas` in
src/repro/kernels/fourier_deltaw.py. Both kernels live in
`csrc/fourier_deltaw.cu`; they are FFT-structured (one in-place transform
of length d2 per pair of rows, in shared memory, `csrc/fft_smem.cuh`; the
passes in `csrc/fft_rows.cuh`, shared with the DCT pair), so each reads or
writes ΔW or g once. The sources' headers say what bounds them and how
they keep their bits fixed; `fft_plan` holds their host-side plan
(radices, rows per block, the digit-reversed positions, the stage
twiddles) and the shape limits. This module holds the wrappers and the
plain versions they are held against.

    deltaw(c, u, v, d1, d2, alpha) -> (L, d1, d2) f32
        c (L, n) f32 with n a multiple of NC (zero-padded, c = 0 there),
        u, v (n,) int32 entries (the kernels reduce them modulo d1 and d2,
        so the phase is exact for any integer entry and no call reads
        anything back to the host).
    dc(g, u, v, d1, d2, alpha) -> (L, n) f32
        g (L, d1, d2) f32 cotangent of ΔW, contiguous and unpadded;
        dc[l, i] = alpha/(d1·d2) · Σ_jk g[l,j,k]·cos(2π(j·u_i/d1 + k·v_i/d2)).

For a CPU tensor a wrapper computes the plain version; for a CUDA tensor it
launches the kernel or raises, also for a shape beyond the kernels' limits
(`fft_plan`: d2 ≤ 29056 with odd prime factors ≤ 63, d1 ≤ 65535,
n ≤ 16384). `kernels.ops.FourierDeltaW` is the autograd Function whose
forward is `deltaw` and whose backward is `dc`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.fourierft import fourier_bases, materialize_delta
from repro_torch.devices import to_device
from repro_torch.kernels import custom_ops
from repro_torch.kernels import fft_plan as fp

NC = 16                 # the kernels' chunk of entries: n must divide by it

launches = 0            # kernel launches made by `deltaw` (chip_smoke reads it)
dc_launches = 0         # kernel launches made by `dc`


def deltaw_reference(c: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     d1: int, d2: int, alpha: float) -> torch.Tensor:
    """The plain version: `materialize_delta` (bases, then two f32
    `torch.matmul`s per layer) on the same (L, n) inputs."""
    return materialize_delta(c, torch.stack([u, v]), d1, d2, alpha)


def dc_reference(g: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 d1: int, d2: int, alpha: float) -> torch.Tensor:
    """The plain version of `dc`: the bases of `core.fourierft`, two f32
    `torch.matmul`s contracting k, then the θ-weighted sum over j."""
    cos_t, sin_t, cos_p, sin_p = fourier_bases(torch.stack([u, v]), d1, d2)
    g = g.to(torch.float32)
    dc = (cos_t * (g @ cos_p) - sin_t * (g @ sin_p)).sum(dim=-2)
    return dc * (alpha / (d1 * d2))


def check_entries(u, v, n, device, nc=NC):
    """Raise unless u, v are contiguous int32 (n,) on `device` and n is a
    multiple of the kernel's chunk `nc` (shared with `dct_deltaw`)."""
    for name, e in (("u", u), ("v", v)):
        if e.shape != (n,) or e.dtype != torch.int32 or not e.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 ({n},), got "
                             f"{tuple(e.shape)} {e.dtype}")
        if e.device != device:
            raise ValueError(f"{name} on {e.device}, the data on {device}")
    if n % nc:
        raise ValueError(f"n={n} is not a multiple of {nc} (pad with zero "
                         "entries and c = 0, as kernels.ops does)")


def check_coefficients(c, u, v, d1, d2, nc=NC):
    """Raise unless c is contiguous f32 (L, n) with entries `check_entries`
    accepts and the grid is not empty."""
    if c.ndim != 2 or c.dtype != torch.float32 or not c.is_contiguous():
        raise ValueError(f"c must be contiguous f32 (L, n), got "
                         f"{tuple(c.shape)} {c.dtype}")
    check_entries(u, v, c.shape[1], c.device, nc)
    if d1 < 1 or d2 < 1:
        raise ValueError(f"bad grid {d1}x{d2}")


def check_cotangent(g, u, v, d1, d2, nc=NC):
    """Raise unless g is contiguous f32 (L, d1, d2) with entries
    `check_entries` accepts."""
    if g.ndim != 3 or g.shape[1:] != (d1, d2) or g.dtype != torch.float32 \
            or not g.is_contiguous():
        raise ValueError(f"g must be contiguous f32 (L, {d1}, {d2}), got "
                         f"{tuple(g.shape)} {g.dtype}")
    check_entries(u, v, u.shape[0], g.device, nc)


_TWIDDLES = {}          # (d, device) -> (cos, sin) tables on the card


def twiddles(d: int, dev: torch.device):
    """The (cos, sin) table cos(2πp/d), sin(2πp/d), p < d, on `dev`, built
    by the twiddle kernel at its first use and kept: every later call of a
    kernel with this d reuses it (K1 and K2 at length d; the DCT kernels'
    row factors and φ at length 4d, `dct_deltaw`). The build waits for its
    stream once, so a table is complete before any stream reads it."""
    from repro_torch.kernels import build
    key = (d, dev)
    if key not in _TWIDDLES:
        lib = build.library("fourier_deltaw")
        cos = torch.empty((d,), dtype=torch.float32, device=dev)
        sin = torch.empty((d,), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            code = lib.fourier_twiddles_launch(cos.data_ptr(), sin.data_ptr(),
                                               d, stream.cuda_stream)
            build.check(code, "fourier_twiddles_launch")
            # repro: allow(host-sync) — once a table, at its first use
            stream.synchronize()
        _TWIDDLES[key] = (cos, sin)
    return _TWIDDLES[key]


_FFT_TABLES = {}        # (d2, device) -> (positions, stage twiddles)


def fft_tables(d2: int, dev: torch.device):
    """The transform's tables for length d2 on `dev`, built at first use and
    kept (like `twiddles`): the digit-reversed positions (d2,) int32
    (`fft_plan.digit_reverse`) and the stage twiddles, (cos, sin) f32 pairs
    gathered from `twiddles(d2)` (`fft_plan.stage_twiddles`)."""
    key = (d2, dev)
    if key not in _FFT_TABLES:
        radices = fp.factor(d2)
        cos, sin = twiddles(d2, dev)
        idx = to_device(fp.stage_twiddles(radices), dev)
        tw = torch.stack([cos[idx], sin[idx]], dim=-1).contiguous()
        pos = to_device(fp.digit_reverse(radices), dev)
        _FFT_TABLES[key] = (pos, tw)
    return _FFT_TABLES[key]


_PLAN_INTS = {}         # FftPlan -> its ints as a ctypes array


def plan_ints(plan: fp.FftPlan):
    """The plan's ints (`FftPlan.as_ints`) as the C entry points take them,
    built once per plan (shared with `dct_deltaw`)."""
    if plan not in _PLAN_INTS:
        ints = plan.as_ints()
        _PLAN_INTS[plan] = (ctypes.c_int * len(ints))(*ints)
    return _PLAN_INTS[plan]


def deltaw(c: torch.Tensor, u: torch.Tensor, v: torch.Tensor, d1: int,
           d2: int, alpha: float) -> torch.Tensor:
    """ΔW (L, d1, d2) f32 for stacked coefficients c (L, n): the plain
    version on the CPU, the CUDA kernel (one launch for the stack: the
    scatter plan, then the row transforms) on the card."""
    check_coefficients(c, u, v, d1, d2)
    if c.device.type == "cpu":
        return deltaw_reference(c, u, v, d1, d2, alpha)
    if c.device.type != "cuda":
        raise ValueError(f"no deltaw kernel for device {c.device}")
    if custom_ops.is_fake(c, u, v):
        return custom_ops.op("fourier_deltaw")(c, u, v, d1, d2, alpha)
    return _deltaw_launch(c, u, v, d1, d2, alpha)


def _deltaw_launch(c, u, v, d1: int, d2: int, alpha: float):
    from repro_torch.kernels import build
    lib = build.library("fourier_deltaw")
    global launches
    L, n = c.shape
    plan = fp.fft_plan(d1, d2, n)
    dev = c.device
    out = torch.empty((L, d1, d2), dtype=torch.float32, device=dev)
    # pass 0's bins, rounds and slots, then each slot's c per layer
    # (`Scatter` in csrc/fft_rows.cuh)
    scratch = torch.empty((2 * d2 + 12 * n + 8 + 2 * L * n,),
                          dtype=torch.int32, device=dev)
    cos1, sin1 = twiddles(d1, dev)
    pos, tw = fft_tables(d2, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fourier_deltaw_launch(
            c.data_ptr(), u.data_ptr(), v.data_ptr(), cos1.data_ptr(),
            sin1.data_ptr(), tw.data_ptr(), pos.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), plan_ints(plan), L, n, d1,
            d2, float(alpha / (d1 * d2)), stream)
    build.check(code, "fourier_deltaw_launch")
    launches += 1
    return out


def dc(g: torch.Tensor, u: torch.Tensor, v: torch.Tensor, d1: int, d2: int,
       alpha: float) -> torch.Tensor:
    """dc (L, n) f32 for the stacked cotangent g (L, d1, d2): the plain
    version on the CPU, the CUDA kernel (one launch for the stack: partial
    sums per row block, then a fixed-order reduction) on the card."""
    check_cotangent(g, u, v, d1, d2)
    if g.device.type == "cpu":
        return dc_reference(g, u, v, d1, d2, alpha)
    if g.device.type != "cuda":
        raise ValueError(f"no dc kernel for device {g.device}")
    if custom_ops.is_fake(g, u, v):
        return custom_ops.op("fourier_dc")(g, u, v, d1, d2, alpha)
    return _dc_launch(g, u, v, d1, d2, alpha)


def _dc_launch(g, u, v, d1: int, d2: int, alpha: float):
    from repro_torch.kernels import build
    lib = build.library("fourier_deltaw")
    global dc_launches
    L, n = g.shape[0], u.shape[0]
    plan = fp.fft_plan(d1, d2)
    dev = g.device
    out = torch.empty((L, n), dtype=torch.float32, device=dev)
    # the row blocks' partial sums, then the entry table (2n words)
    partial = torch.empty((plan.k2_row_blocks * L * n + 2 * n,),
                          dtype=torch.float32, device=dev)
    cos1, sin1 = twiddles(d1, dev)
    pos, tw = fft_tables(d2, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fourier_dc_launch(
            g.data_ptr(), u.data_ptr(), v.data_ptr(), cos1.data_ptr(),
            sin1.data_ptr(), tw.data_ptr(), pos.data_ptr(),
            partial.data_ptr(), out.data_ptr(), plan_ints(plan), L, n, d1,
            d2, float(alpha / (d1 * d2)), stream)
    build.check(code, "fourier_dc_launch")
    dc_launches += 1
    return out


custom_ops.define_deltaw_pair("fourier", _deltaw_launch, _dc_launch)
