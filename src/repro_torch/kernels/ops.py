"""The differentiable padding harness around the ΔW kernels, and the
standalone registry-dispatched `fourier_deltaw` entry.

`make_deltaw_function(kernels)` is the JAX package's `make_deltaw_harness`
as a `torch.autograd.Function` factory, instantiated for both kernel pairs:
`FourierDeltaW` (forward K1, backward K2, `fourier_deltaw`) and `DCTDeltaW`
(forward K4, backward K5, `dct_deltaw`). Each is one launch per stacked
(L, n) site and direction.

- Forward: n is padded to the kernels' chunk (`NC`) with zero entries whose
  coefficients are 0 — those columns drop out of the sums exactly. The
  kernel writes ΔW at exactly (d1, d2) (its ragged tile edges are masked at
  the store), so nothing is sliced. Only the padded entries are saved.
- Backward: the cotangent is cast to contiguous f32 and handed to the dc
  kernel unpadded (it masks its own edges); the padded entries' dc is
  dropped, and the gradient takes c's shape ((n,) or (L, n)) and dtype.
  Only c receives a gradient.

On CPU tensors both halves run the kernels' plain versions; on CUDA tensors
they launch the kernels or raise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import dct_deltaw as ddk
from repro_torch.kernels import fourier_deltaw as fdk


def make_deltaw_function(kernels, name: str):
    """An autograd Function `name` for c (n,) -> (d1, d2), or stacked
    c (L, n) -> (L, d1, d2), f32, differentiable with respect to c. The
    `kernels` module provides `NC`, `deltaw(c, u, v, d1, d2, alpha)` and
    `dc(g, u, v, d1, d2, alpha)` with the stacked contract of
    `fourier_deltaw`."""

    class DeltaW(torch.autograd.Function):
        @staticmethod
        def forward(ctx, c, entries, d1: int, d2: int, alpha: float):
            n = c.shape[-1]
            c2 = c.reshape(-1, n).to(torch.float32)
            npad = -(-n // kernels.NC) * kernels.NC
            e = entries.to(device=c.device, dtype=torch.int32)
            if npad != n:
                c2 = F.pad(c2, (0, npad - n))
                e = F.pad(e, (0, npad - n))
            u, v = e[0].contiguous(), e[1].contiguous()
            out = kernels.deltaw(c2.contiguous(), u, v, d1, d2, alpha)
            ctx.save_for_backward(u, v)
            ctx.meta = (c.shape, c.dtype, n, d1, d2, alpha)
            return out.reshape(c.shape[:-1] + (d1, d2))

        @staticmethod
        def backward(ctx, g):
            u, v = ctx.saved_tensors
            shape, dtype, n, d1, d2, alpha = ctx.meta
            g3 = g.reshape(-1, d1, d2).to(torch.float32).contiguous()
            dc = kernels.dc(g3, u, v, d1, d2, alpha)[:, :n]
            return dc.reshape(shape).to(dtype), None, None, None, None

    DeltaW.__name__ = DeltaW.__qualname__ = name
    return DeltaW


FourierDeltaW = make_deltaw_function(fdk, "FourierDeltaW")
DCTDeltaW = make_deltaw_function(ddk, "DCTDeltaW")


def fourier_deltaw_forward(c: torch.Tensor, entries: torch.Tensor, d1: int,
                           d2: int, alpha: float) -> torch.Tensor:
    """FourierFT ΔW for c (n,) -> (d1, d2), or stacked c (L, n) ->
    (L, d1, d2), f32, through `FourierDeltaW` (K1/K2 on CUDA tensors)."""
    return FourierDeltaW.apply(c, entries, d1, d2, alpha)


def dct_deltaw_forward(c: torch.Tensor, entries: torch.Tensor, d1: int,
                       d2: int, alpha: float) -> torch.Tensor:
    """DCT ΔW for c (n,) -> (d1, d2), or stacked c (L, n) -> (L, d1, d2),
    f32, through `DCTDeltaW` (K4/K5 on CUDA tensors)."""
    return DCTDeltaW.apply(c, entries, d1, d2, alpha)


def fourier_deltaw(c: torch.Tensor, entries: torch.Tensor, d1: int, d2: int,
                   alpha: float, *, backend: str = "auto",
                   out_dtype=None) -> torch.Tensor:
    """ΔW for c (n,) -> (d1, d2), or stacked c (L, n) -> (L, d1, d2).

    `backend`: auto | pallas | einsum — resolved through the kernel
    registry for c's device exactly like `AdapterMethod.site_delta`."""
    from repro_torch.configs.base import PEFTConfig
    from repro_torch.kernels import api
    peft = PEFTConfig(method="fourierft", alpha=alpha, kernel_backend=backend)
    op = api.resolve_op("deltaw", "fourierft", peft, d1, d2, device=c.device)
    out = op.fn({"c": c}, {"entries": entries}, d1, d2, peft)
    return out.to(out_dtype) if out_dtype is not None else out
