"""Adapter-method API (the JAX package's `core/adapter.py` protocol).

Every PEFT method is an `AdapterMethod` registered under its config string
(`PEFTConfig.method`). Per adapted 2-D weight site, stacked over layers on
axis 0:

    init_site(gen, site, peft, device)  -> adapter dict (trainable + frozen)
    trainable_leaves(peft)              -> names of the trainable leaves
    kernel_ops()                        -> KernelOp implementations
    site_delta(adapter, site, peft)     -> dense ΔW (stack, d1, d2)
    merge_site(eff, key, adapter, ...)  -> fold the site into eff layer tree
    count_trainable(site, peft)         -> |Θ| contribution (paper Table 1)

`site_delta` dispatches through the kernel registry (kernels/api.py) for
the device the adapter lives on, so the merge runs the CUDA ΔW kernel on
the card without this module branching on it.

Registered: FourierFT (Fourier basis), `dct` (the LoCA-style cosine basis
on FourierFT's entries) and `none`. The factored and bank applies, the
other methods (circulant, lora, bitfit, full) and the Table-6 random /
orthogonal bases come with later slices (ROADMAP queue 1).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import PEFTConfig
from repro_torch.core import fourierft
from repro_torch.kernels import api as kernel_api
from repro_torch.kernels.api import KernelOp

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a config dtype string ("bfloat16", ...)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; one of "
                         f"{sorted(_DTYPES)}") from None


@dataclass(frozen=True)
class AdapterSite:
    name: str          # matches the stacked weight key in base params
    d_in: int
    d_out: int
    stack: int         # number of layers stacked on axis 0


def entry_seed_for(peft: PEFTConfig, site: AdapterSite) -> int:
    """Paper: one shared seed (2024) for all layers. Distinct (d1, d2) grids
    cannot share integer entries, so the seed is offset per site shape only
    when shapes differ; equal-shaped sites share entries exactly as the paper
    prescribes."""
    return peft.entry_seed + hash((site.d_in, site.d_out)) % 1000


# ---------------------------------------------------------------------------
# Protocol
# ---------------------------------------------------------------------------

class AdapterMethod:
    """Base class: one instance per method, registered by `name`."""

    name: str = ""
    mergeable: bool = True        # ΔW can be folded into the base weight
    has_site_params: bool = True  # owns per-site adapter state

    # ---- state ------------------------------------------------------------
    def init_site(self, gen: torch.Generator, site: AdapterSite,
                  peft: PEFTConfig, device) -> Dict:
        raise ValueError(f"no per-site params for method {self.name!r}")

    def trainable_leaves(self, peft: PEFTConfig) -> Tuple[str, ...]:
        return ()

    def split_adapter(self, adapter: Dict,
                      peft: PEFTConfig) -> Tuple[Dict, Dict]:
        """-> (trainable, aux) views of one site's adapter dict."""
        names = set(self.trainable_leaves(peft))
        tr = {k: v for k, v in adapter.items() if k in names}
        aux = {k: v for k, v in adapter.items() if k not in names}
        return tr, aux

    # ---- kernels ----------------------------------------------------------
    def kernel_ops(self) -> Tuple[KernelOp, ...]:
        """KernelOp implementations this method provides, collected lazily
        into the kernel registry on first dispatch. Every op needs an
        `einsum` plain version; a `cuda` kernel is optional."""
        return ()

    def _kernel(self, op: str, peft: PEFTConfig, d1: int, d2: int,
                device) -> Optional[KernelOp]:
        return kernel_api.resolve_op(op, self, peft, d1, d2, device=device,
                                     missing_ok=True)

    # ---- math (registry-dispatched) ----------------------------------------
    def site_delta(self, adapter: Dict, site: AdapterSite, peft: PEFTConfig,
                   out_dtype=None) -> torch.Tensor:
        tr, aux = self.split_adapter(adapter, peft)
        device = next(iter(tr.values())).device
        op = self._kernel("deltaw", peft, site.d_in, site.d_out, device)
        if op is None:
            raise NotImplementedError(f"{self.name} has no dense ΔW form")
        dw = op.fn(tr, aux, site.d_in, site.d_out, peft)
        return dw.to(out_dtype) if out_dtype is not None else dw

    def merge_site(self, eff: Dict, key: str, adapter: Dict,
                   site: AdapterSite, peft: PEFTConfig) -> None:
        """Fold one site into the (stacked) layer tree `eff`: ΔW is cast to
        the weight's dtype BEFORE the add, as the JAX package does."""
        dw = self.site_delta(adapter, site, peft, eff[key].dtype)
        eff[key] = eff[key] + dw

    # ---- accounting (paper Table 1 / §3.2) --------------------------------
    def count_trainable(self, site: AdapterSite, peft: PEFTConfig) -> int:
        return 0


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, AdapterMethod] = {}


def register(method: AdapterMethod) -> AdapterMethod:
    if not method.name:
        raise ValueError("AdapterMethod.name must be set before registration")
    if method.name in _REGISTRY:
        raise ValueError(f"adapter method {method.name!r} already registered")
    _REGISTRY[method.name] = method
    return method


def resolve(name: str) -> AdapterMethod:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown adapter method {name!r}; registered: "
                       f"{sorted(_REGISTRY)} (the other methods come with a "
                       "later slice, ROADMAP queue 1)") from None


def registered_methods() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# FourierFT (the paper): spectral coefficients on frozen Fourier entries
# ---------------------------------------------------------------------------

def _fourier_basis_only(peft: PEFTConfig) -> bool:
    return getattr(peft, "basis", "fourier") == "fourier"


def _fourier_deltaw_einsum(tr, aux, d1, d2, peft):
    return fourierft.materialize_delta(tr["c"], aux["entries"], d1, d2,
                                       peft.alpha)


def _fourier_deltaw_cuda(tr, aux, d1, d2, peft):
    # the autograd Function: K1 forward, K2 (the dc kernel) backward, so a
    # merge on the card carries the coefficients' gradient
    from repro_torch.kernels import ops as kops
    return kops.fourier_deltaw_forward(tr["c"], aux["entries"], d1, d2,
                                       peft.alpha)


class FourierFT(AdapterMethod):
    name = "fourierft"

    def init_site(self, gen, site, peft, device):
        if peft.basis != "fourier":
            raise NotImplementedError(
                f"basis {peft.basis!r} (Table 6 ablation) comes with a later "
                "slice (ROADMAP queue 1)")
        entries = fourierft.sample_entries(
            site.d_in, site.d_out, peft.n, entry_seed_for(peft, site),
            freq_bias=peft.freq_bias, fc=peft.fc, bandwidth=peft.bandwidth)
        c = torch.randn((site.stack, peft.n), generator=gen, device=device,
                        dtype=torch.float32).to(torch_dtype(peft.param_dtype))
        return {"c": c, "entries": entries.to(device)}

    def trainable_leaves(self, peft):
        return ("c",)

    def kernel_ops(self):
        return (
            KernelOp("deltaw", self.name, "einsum", _fourier_deltaw_einsum),
            KernelOp("deltaw", self.name, "cuda", _fourier_deltaw_cuda,
                     devices=("cuda",), requires=_fourier_basis_only,
                     note="integer-phase FP32 tiles "
                          "(csrc/fourier_deltaw.cu)"),
        )

    def count_trainable(self, site, peft):
        return peft.n * site.stack


# ---------------------------------------------------------------------------
# DCT (LoCA-style, arXiv:2502.06820): real cosine basis on frozen entries —
# ΔW[j,k] = α/(d1·d2) Σ_l c_l cos(π(2j+1)u_l/2d1) cos(π(2k+1)v_l/2d2),
# rank-n factored as ΔW = (C1 ⊙ c) @ C2ᵀ; the same wire format as FourierFT
# (one coefficient vector per layer + 2n integer entries per site shape).
# ---------------------------------------------------------------------------

def dct_bases(entries: torch.Tensor, d1: int, d2: int):
    """C1 (d1, n) and C2 (d2, n) f32 for the entries (2, n):
    C1[j,l] = cos(π·((2j+1)·u_l mod 4d1)/(2d1)), C2 likewise with k, v, d2.

    cos(π(2j+1)u/2d) has period 4d in the integer product (2j+1)·u, which is
    reduced exactly in int64 before the float conversion, as the CUDA
    kernels reduce it, so cos sees arguments in [0, 2π) at any dimension.
    (The JAX package forms (2j+1)·u in float32, inexact once it passes 2^24:
    ROADMAP queue 3.)"""
    dev = entries.device
    u = entries[0].to(torch.int64)
    v = entries[1].to(torch.int64)
    j = torch.arange(d1, dtype=torch.int64, device=dev)[:, None]
    k = torch.arange(d2, dtype=torch.int64, device=dev)[:, None]
    p1 = ((2 * j + 1) * u[None, :]) % (4 * d1)
    p2 = ((2 * k + 1) * v[None, :]) % (4 * d2)
    return (torch.cos(p1.to(torch.float32) * (math.pi / (2 * d1))),
            torch.cos(p2.to(torch.float32) * (math.pi / (2 * d2))))


def dct_delta(c: torch.Tensor, entries: torch.Tensor, d1: int, d2: int,
              alpha: float) -> torch.Tensor:
    """ΔW for one layer (c: (n,)) or a stack (c: (L, n) -> (L, d1, d2)), in
    f32 with one `torch.matmul` (callers on the card keep TF32 off)."""
    c1, c2 = dct_bases(entries.to(c.device), d1, d2)
    c = c.to(torch.float32)
    if c.ndim == 1:
        dw = (c1 * c) @ c2.T
    else:
        dw = (c1[None] * c[:, None, :]) @ c2.T
    return dw * (alpha / (d1 * d2))


def _dct_deltaw_einsum(tr, aux, d1, d2, peft):
    return dct_delta(tr["c"], aux["entries"], d1, d2, peft.alpha)


def _dct_deltaw_cuda(tr, aux, d1, d2, peft):
    # the autograd Function: K4 forward, K5 (the dc kernel) backward
    from repro_torch.kernels import ops as kops
    return kops.dct_deltaw_forward(tr["c"], aux["entries"], d1, d2,
                                   peft.alpha)


class DCTAdapter(AdapterMethod):
    name = "dct"

    def init_site(self, gen, site, peft, device):
        entries = fourierft.sample_entries(
            site.d_in, site.d_out, peft.n, entry_seed_for(peft, site),
            freq_bias=peft.freq_bias, fc=peft.fc, bandwidth=peft.bandwidth)
        c = torch.randn((site.stack, peft.n), generator=gen, device=device,
                        dtype=torch.float32).to(torch_dtype(peft.param_dtype))
        return {"c": c, "entries": entries.to(device)}

    def trainable_leaves(self, peft):
        return ("c",)

    def kernel_ops(self):
        return (
            KernelOp("deltaw", self.name, "einsum", _dct_deltaw_einsum),
            KernelOp("deltaw", self.name, "cuda", _dct_deltaw_cuda,
                     devices=("cuda",),
                     note="cosine-only integer-phase FP32 tiles "
                          "(csrc/dct_deltaw.cu)"),
        )

    def count_trainable(self, site, peft):
        return peft.n * site.stack


class NoAdapter(AdapterMethod):
    name = "none"
    has_site_params = False


register(FourierFT())
register(DCTAdapter())
register(NoAdapter())
