"""FourierFT ΔW materialization (K1) and its VJP with respect to the
coefficients (K2): the hand-written Hopper kernels and their plain PyTorch
versions.

Replaces the TPU kernels `deltaw_pallas` and `dc_pallas` in
src/repro/kernels/fourier_deltaw.py. Both kernels live in
`csrc/fourier_deltaw.cu`, whose header says what bounds them on the card and
how the designs keep the bases out of device memory; this module holds the
wrappers and the plain versions they are held against.

    deltaw(c, u, v, d1, d2, alpha) -> (L, d1, d2) f32
        c (L, n) f32 with n a multiple of NC (zero-padded, c = 0 there),
        u, v (n,) int32 entries (the kernels reduce them modulo d1 and d2,
        so the phase is exact for any integer entry and no call reads
        anything back to the host).
    dc(g, u, v, d1, d2, alpha) -> (L, n) f32
        g (L, d1, d2) f32 cotangent of ΔW, contiguous and unpadded;
        dc[l, i] = alpha/(d1·d2) · Σ_jk g[l,j,k]·cos(2π(j·u_i/d1 + k·v_i/d2)).

For a CPU tensor a wrapper computes the plain version; for a CUDA tensor it
launches the kernel or raises. `kernels.ops.FourierDeltaW` is the autograd
Function whose forward is `deltaw` and whose backward is `dc`.
"""
from __future__ import annotations

import torch

from repro_torch.core.fourierft import fourier_bases, materialize_delta

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
    kernel with this d reuses it (K1 and K2 at length d; the DCT kernels at
    length 4d, `dct_deltaw`). The build waits for its stream once, so a
    table is complete before any stream reads it."""
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
            stream.synchronize()
        _TWIDDLES[key] = (cos, sin)
    return _TWIDDLES[key]


def deltaw(c: torch.Tensor, u: torch.Tensor, v: torch.Tensor, d1: int,
           d2: int, alpha: float) -> torch.Tensor:
    """ΔW (L, d1, d2) f32 for stacked coefficients c (L, n): the plain
    version on the CPU, the CUDA kernel (one launch for the stack) on the
    card."""
    check_coefficients(c, u, v, d1, d2)
    if c.device.type == "cpu":
        return deltaw_reference(c, u, v, d1, d2, alpha)
    if c.device.type != "cuda":
        raise ValueError(f"no deltaw kernel for device {c.device}")
    from repro_torch.kernels import build
    lib = build.library("fourier_deltaw")
    global launches
    L, n = c.shape
    dev = c.device
    out = torch.empty((L, d1, d2), dtype=torch.float32, device=dev)
    (cos1, sin1), (cos2, sin2) = twiddles(d1, dev), twiddles(d2, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fourier_deltaw_launch(
            c.data_ptr(), u.data_ptr(), v.data_ptr(), cos1.data_ptr(),
            sin1.data_ptr(), cos2.data_ptr(), sin2.data_ptr(), out.data_ptr(),
            L, n, d1, d2, float(alpha / (d1 * d2)), stream)
    build.check(code, "fourier_deltaw_launch")
    launches += 1
    return out


def dc(g: torch.Tensor, u: torch.Tensor, v: torch.Tensor, d1: int, d2: int,
       alpha: float) -> torch.Tensor:
    """dc (L, n) f32 for the stacked cotangent g (L, d1, d2): the plain
    version on the CPU, the CUDA kernel (one launch for the stack: partial
    sums per 128-row block, then a fixed-order reduction) on the card."""
    check_cotangent(g, u, v, d1, d2)
    if g.device.type == "cpu":
        return dc_reference(g, u, v, d1, d2, alpha)
    if g.device.type != "cuda":
        raise ValueError(f"no dc kernel for device {g.device}")
    from repro_torch.kernels import build
    lib = build.library("fourier_deltaw")
    global dc_launches
    L, n = g.shape[0], u.shape[0]
    dev = g.device
    out = torch.empty((L, n), dtype=torch.float32, device=dev)
    partial = torch.empty((-(-d1 // 128), L, n), dtype=torch.float32,
                          device=dev)
    (cos1, sin1), (cos2, sin2) = twiddles(d1, dev), twiddles(d2, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fourier_dc_launch(
            g.data_ptr(), u.data_ptr(), v.data_ptr(), cos1.data_ptr(),
            sin1.data_ptr(), cos2.data_ptr(), sin2.data_ptr(),
            partial.data_ptr(), out.data_ptr(), L, n, d1, d2,
            float(alpha / (d1 * d2)), stream)
    build.check(code, "fourier_dc_launch")
    dc_launches += 1
    return out
