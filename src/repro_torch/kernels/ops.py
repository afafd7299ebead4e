"""The padding harness around the ΔW kernel, and the standalone
registry-dispatched `fourier_deltaw` entry.

`fourier_deltaw_forward` is the forward half of the JAX package's
`make_deltaw_harness`: n is padded to the kernel's chunk (`NC`) with zero
entries whose coefficients are 0 — those columns drop out of the sums
exactly — and a stacked (L, n) input is ONE launch over the kernel's layer
grid dimension, not L launches. The kernel writes ΔW at exactly (d1, d2)
(its ragged tile edges are masked at the store), so nothing is sliced.

The backward half — a `torch.autograd.Function` whose backward is the dc
kernel (the TPU's `dc_pallas`, K2) — comes with the training slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import fourier_deltaw as fdk


def fourier_deltaw_forward(c: torch.Tensor, entries: torch.Tensor, d1: int,
                           d2: int, alpha: float) -> torch.Tensor:
    """ΔW for c (n,) -> (d1, d2), or stacked c (L, n) -> (L, d1, d2), f32,
    through `fourier_deltaw.deltaw` (the kernel on CUDA tensors)."""
    single = c.ndim == 1
    c2 = c.reshape(-1, c.shape[-1]).to(torch.float32)
    n = c2.shape[1]
    npad = -(-n // fdk.NC) * fdk.NC
    e = entries.to(device=c.device, dtype=torch.int32)
    if npad != n:
        c2 = F.pad(c2, (0, npad - n))
        e = F.pad(e, (0, npad - n))
    out = fdk.deltaw(c2.contiguous(), e[0].contiguous(), e[1].contiguous(),
                     d1, d2, alpha)
    return out[0] if single else out


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
