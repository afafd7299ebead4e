"""FourierFT ΔW materialization: the hand-written Hopper kernel (K1) and its
plain PyTorch version.

Replaces the TPU kernel `deltaw_pallas` in
src/repro/kernels/fourier_deltaw.py. The kernel is `csrc/fourier_deltaw.cu`
(its header says what bounds it on the card — FP32 operations — and how the
design keeps the bases out of device memory); this module holds the wrapper
and the plain version it is held against.

    deltaw(c, u, v, d1, d2, alpha) -> (L, d1, d2) f32
        c (L, n) f32 with n a multiple of NC (zero-padded, c = 0 there),
        u, v (n,) int32 entries with 0 <= u < d1, 0 <= v < d2.

For a CPU tensor the wrapper computes the plain version; for a CUDA tensor
it launches the kernel or raises. The VJP with respect to c (the TPU's
`dc_pallas`, K2) comes with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.fourierft import materialize_delta

NC = 16                 # the kernel's chunk of entries: n must divide by it

launches = 0            # kernel launches made by `deltaw` (chip_smoke reads it)


def deltaw_reference(c: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     d1: int, d2: int, alpha: float) -> torch.Tensor:
    """The plain version: `materialize_delta` (bases, then two f32
    `torch.matmul`s per layer) on the same (L, n) inputs."""
    return materialize_delta(c, torch.stack([u, v]), d1, d2, alpha)


def _check(c, u, v, d1, d2):
    if c.ndim != 2 or c.dtype != torch.float32 or not c.is_contiguous():
        raise ValueError(f"c must be contiguous f32 (L, n), got "
                         f"{tuple(c.shape)} {c.dtype}")
    n = c.shape[1]
    for name, e in (("u", u), ("v", v)):
        if e.shape != (n,) or e.dtype != torch.int32 or not e.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 ({n},), got "
                             f"{tuple(e.shape)} {e.dtype}")
        if e.device != c.device:
            raise ValueError(f"{name} on {e.device}, c on {c.device}")
    if n % NC:
        raise ValueError(f"n={n} is not a multiple of {NC} (pad with zero "
                         "entries and c = 0, as kernels.ops does)")
    if d1 < 1 or d2 < 1:
        raise ValueError(f"bad grid {d1}x{d2}")


def deltaw(c: torch.Tensor, u: torch.Tensor, v: torch.Tensor, d1: int,
           d2: int, alpha: float) -> torch.Tensor:
    """ΔW (L, d1, d2) f32 for stacked coefficients c (L, n): the plain
    version on the CPU, the CUDA kernel (one launch for the stack) on the
    card."""
    _check(c, u, v, d1, d2)
    if c.device.type == "cpu":
        return deltaw_reference(c, u, v, d1, d2, alpha)
    if c.device.type != "cuda":
        raise ValueError(f"no deltaw kernel for device {c.device}")
    # the kernel's running phase needs 0 <= u < d1 and 0 <= v < d2 (one
    # host check per call; a merge calls this once per site)
    bad = ((u < 0) | (u >= d1)).any() | ((v < 0) | (v >= d2)).any()
    if bool(bad):
        raise ValueError(f"entries outside the {d1}x{d2} grid")
    from repro_torch.kernels import build
    lib = build.library("fourier_deltaw")
    global launches
    L, n = c.shape
    dev = c.device
    out = torch.empty((L, d1, d2), dtype=torch.float32, device=dev)
    cos1 = torch.empty((d1,), dtype=torch.float32, device=dev)
    sin1 = torch.empty_like(cos1)
    cos2 = torch.empty((d2,), dtype=torch.float32, device=dev)
    sin2 = torch.empty_like(cos2)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fourier_deltaw_launch(
            c.data_ptr(), u.data_ptr(), v.data_ptr(), cos1.data_ptr(),
            sin1.data_ptr(), cos2.data_ptr(), sin2.data_ptr(), out.data_ptr(),
            L, n, d1, d2, float(alpha / (d1 * d2)), stream)
    build.check(code, "fourier_deltaw_launch")
    launches += 1
    return out
