"""Adapter-method API (the JAX package's `core/adapter.py` protocol).

Every PEFT method is an `AdapterMethod` registered under its config string
(`PEFTConfig.method`). Per adapted 2-D weight site, stacked over layers on
axis 0:

    init_site(gen, site, peft, device)  -> adapter dict (trainable + frozen)
    trainable_leaves(peft)              -> names of the trainable leaves
    kernel_ops()                        -> KernelOp implementations
    site_delta(adapter, site, peft)     -> dense ΔW (stack, d1, d2)
    factored_apply(x, tr, aux, d1, d2)  -> y-contribution without ΔW
    bank_apply(x, tr, aux, d1, d2)      -> row-batched factored_apply (the
                                           serving adapter bank: tr leaves
                                           carry a leading per-request dim)
    frozen_tables(aux, d1, d2)          -> the frozen tables the factored
                                           and bank applies read (built once)
    merge_site(eff, key, adapter, ...)  -> fold the site into eff layer tree
    count_trainable(site, peft)         -> |Θ| contribution (paper Table 1)
    shared_storage_numbers(sites, peft) -> frozen numbers a checkpoint must
                                           carry beyond Θ (e.g. 2n entries)

`site_delta`, `factored_apply` and `bank_apply` dispatch through the kernel
registry (kernels/api.py) for the device the tensors live on, so the merge
runs the CUDA ΔW kernel on the card without this module branching on it.

Contract the serving adapter bank needs: the factored contribution is
linear in the trainable leaves, so an all-zero row contributes exactly
zero (every request gathers a row from every method group; a request of
another method gathers the reserved zero row).

Frozen tables: the factored and bank applies of FourierFT and `dct` read
f32 (d, n) cosine/sine tables of their entries. The JAX package rebuilds
them inside every traced call; here `frozen_tables` builds them once and
the caller keeps them beside the entries in the aux dict (the adapter
bank per group and site, `peft.with_frozen_tables` for factored params),
where the ops find them. Without them an op builds its own, with the same
function: the same numbers either way.

Registered: FourierFT (the Fourier basis, and the Table-6 random and
orthogonal bases of `core/basis.py`), `dct` (the LoCA-style cosine basis on
FourierFT's entries), `circulant`, `lora`, `bitfit`, `none` and `full` (the
FF baseline: no adapter state, the whole base trains).

On CUDA tensors FourierFT's ΔW has two routes under one key: the Fourier
basis runs the hand-written K1 (its autograd Function runs K2 backward),
and the random and orthogonal bases one `torch.matmul` of (B1 ⊙ c) by B2ᵀ,
a library product as in the JAX package, where the basis ΔW is a plain
product outside any Pallas kernel. `KernelPolicy.explain()` names the route
each site resolved to.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import PEFTConfig
from repro_torch.core import basis as basis_mod
from repro_torch.core import fourierft, lora
from repro_torch.kernels import api as kernel_api
from repro_torch.kernels import fft_plan
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


def _per_row(v: torch.Tensor, x_ndim: int) -> torch.Tensor:
    """Align a per-request leaf (B, k...) against x (B, ..., d): insert
    broadcast axes so row b of the leaf meets row b of x."""
    return v.reshape(v.shape[:1] + (1,) * (x_ndim - v.ndim) + v.shape[1:])


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
    linear_delta: bool = True     # contribution is x @ ΔW (BitFit: a bias)
    has_site_params: bool = True  # owns per-site adapter state
    trains_base: bool = False     # "full": the base weights are the trainables

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

    def factored_apply(self, x: torch.Tensor, trainable: Dict, aux: Dict,
                       d1: int, d2: int, peft: PEFTConfig) -> torch.Tensor:
        """Additive output contribution for one layer slice, x (..., d1) ->
        (..., d2), in f32. Equals x @ site_delta(...) (up to float error)
        whenever `linear_delta`."""
        op = self._kernel("factored_apply", peft, d1, d2, x.device)
        if op is None:
            raise NotImplementedError(f"{self.name} has no factored form")
        return op.fn(x, trainable, aux, d1, d2, peft)

    def bank_apply(self, x: torch.Tensor, trainable: Dict, aux: Dict,
                   d1: int, d2: int, peft: PEFTConfig) -> torch.Tensor:
        """Row-batched factored apply: x (B, ..., d1); every trainable leaf
        carries a leading (B,) per-request dim. Methods that register no
        bank op run the per-row factored apply row by row."""
        op = self._kernel("bank_apply", peft, d1, d2, x.device)
        if op is not None:
            return op.fn(x, trainable, aux, d1, d2, peft)
        return torch.stack([
            self.factored_apply(x[b], {k: v[b] for k, v in trainable.items()},
                                aux, d1, d2, peft)
            for b in range(x.shape[0])])

    def frozen_tables(self, aux: Dict, d1: int, d2: int) -> Dict:
        """The frozen tables the factored and bank applies read, built from
        the aux leaves (module docstring). None by default."""
        return {}

    def merge_site(self, eff: Dict, key: str, adapter: Dict,
                   site: AdapterSite, peft: PEFTConfig) -> None:
        """Fold one site into the (stacked) layer tree `eff`: ΔW is cast to
        the weight's dtype BEFORE the add, as the JAX package does. A
        weight placed on a mesh (a DTensor) takes its shard of the ΔW each
        rank materializes from the replicated adapter leaves
        (`dist.dtensor.sharded_delta`: the kernel runs on local tensors)."""
        w = eff[key]
        from repro_torch.dist.dtensor import is_dtensor, sharded_delta
        if is_dtensor(w):
            dw = sharded_delta(
                lambda ad: self.site_delta(ad, site, peft, w.dtype),
                adapter, w)
        else:
            dw = self.site_delta(adapter, site, peft, w.dtype)
        eff[key] = w + dw

    # ---- accounting (paper Table 1 / §3.2) --------------------------------
    def count_trainable(self, site: AdapterSite, peft: PEFTConfig) -> int:
        return 0

    def shared_storage_numbers(self, sites: Sequence[AdapterSite],
                               peft: PEFTConfig) -> int:
        """Frozen numbers stored once per checkpoint beyond the trainables
        (regenerable-from-seed state counts 0)."""
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
                       f"{sorted(_REGISTRY)}") from None


def registered_methods(site_params_only: bool = False) -> Tuple[str, ...]:
    names = sorted(_REGISTRY)
    if site_params_only:
        names = [n for n in names if _REGISTRY[n].has_site_params]
    return tuple(names)


# ---------------------------------------------------------------------------
# FourierFT (the paper): spectral coefficients on frozen Fourier entries,
# with the Table-6 random/orthogonal basis ablation folded in via peft.basis
# ---------------------------------------------------------------------------

def _fourier_basis_only(peft: PEFTConfig) -> bool:
    return getattr(peft, "basis", "fourier") == "fourier"


def _other_basis(peft: PEFTConfig) -> bool:
    return not _fourier_basis_only(peft)


def _fft_plan_accepts(d1, d2, peft, dtype=None):
    """The FFT-structured ΔW kernels' shape limits (K1/K2 and K4/K5 share
    `kernels.fft_plan`): the plan's own checks, at n padded to the
    kernels' chunk as the autograd harness pads it."""
    from repro_torch.kernels.fourier_deltaw import NC
    n = -(-peft.n // NC) * NC if peft is not None else 0
    try:
        fft_plan.fft_plan(d1, d2, n)
    except ValueError as e:
        return False, str(e)
    return True, ""


def _fourier_deltaw_einsum(tr, aux, d1, d2, peft):
    if "entries" in aux:
        return fourierft.materialize_delta(tr["c"], aux["entries"], d1, d2,
                                           peft.alpha)
    return basis_mod.materialize_delta_basis(tr["c"], aux["b1"], aux["b2"],
                                             peft.basis, peft.alpha)


_FOURIER_TABLES = ("cos_t", "sin_t", "cos_p", "sin_p")


def _fourier_tables(aux, d1, d2):
    """cos θ, sin θ (d1, n), cos φ, sin φ (d2, n): the cached tables, else
    built from the entries."""
    if _FOURIER_TABLES[0] in aux:
        return tuple(aux[k] for k in _FOURIER_TABLES)
    return fourierft.fourier_bases(aux["entries"], d1, d2)


def _fourier_factored_einsum(x, tr, aux, d1, d2, peft):
    if "b1" in aux:
        scale = basis_mod.basis_scale(peft.basis, d1, d2, peft.alpha)
        proj = (x.to(torch.float32) @ aux["b1"]) \
            * tr["c"].to(torch.float32)
        return proj @ aux["b2"].T * scale
    return fourierft.factored_apply(x.to(torch.float32), tr["c"], None, d1,
                                    d2, peft.alpha,
                                    bases=_fourier_tables(aux, d1, d2))


def _fourier_bank_einsum(x, tr, aux, d1, d2, peft):
    xf = x.to(torch.float32)
    c = _per_row(tr["c"].to(torch.float32), x.ndim)
    if "b1" in aux:
        scale = basis_mod.basis_scale(peft.basis, d1, d2, peft.alpha)
        return ((xf @ aux["b1"]) * c) @ aux["b2"].T * scale
    cos_t, sin_t, cos_p, sin_p = _fourier_tables(aux, d1, d2)
    pc = (xf @ cos_t) * c
    ps = (xf @ sin_t) * c
    return (pc @ cos_p.T - ps @ sin_p.T) * (peft.alpha / (d1 * d2))


def _fourier_deltaw_cuda(tr, aux, d1, d2, peft):
    # the autograd Function: K1 forward, K2 (the dc kernel) backward, so a
    # merge on the card carries the coefficients' gradient
    from repro_torch.kernels import ops as kops
    return kops.fourier_deltaw_forward(tr["c"], aux["entries"], d1, d2,
                                       peft.alpha)


def _basis_deltaw_matmul(tr, aux, d1, d2, peft):
    # the random/orthogonal bases on the card: materialize_delta_basis's
    # one batched torch.matmul; autograd gives c its gradient
    return basis_mod.materialize_delta_basis(tr["c"], aux["b1"], aux["b2"],
                                             peft.basis, peft.alpha)


class FourierFT(AdapterMethod):
    name = "fourierft"

    def init_site(self, gen, site, peft, device):
        if peft.basis == "fourier":
            entries = fourierft.sample_entries(
                site.d_in, site.d_out, peft.n, entry_seed_for(peft, site),
                freq_bias=peft.freq_bias, fc=peft.fc,
                bandwidth=peft.bandwidth)
            aux = {"entries": entries.to(device)}
        else:
            # the JAX package's draw, on the host once per (seed, shape)
            b1, b2 = basis_mod.site_basis(peft.entry_seed, peft.basis,
                                          site.d_in, site.d_out, peft.n)
            aux = {"b1": torch.tensor(b1, device=device),
                   "b2": torch.tensor(b2, device=device)}
        c = torch.randn((site.stack, peft.n), generator=gen, device=device,
                        dtype=torch.float32).to(torch_dtype(peft.param_dtype))
        return {"c": c, **aux}

    def trainable_leaves(self, peft):
        return ("c",)

    def kernel_ops(self):
        return (
            KernelOp("deltaw", self.name, "einsum", _fourier_deltaw_einsum),
            KernelOp("deltaw", self.name, "cuda", _fourier_deltaw_cuda,
                     devices=("cuda",), requires=_fourier_basis_only,
                     accepts=_fft_plan_accepts, caps=fft_plan.FOURIER_CAPS,
                     note="K1: row FFTs in shared memory "
                          "(csrc/fourier_deltaw.cu)"),
            KernelOp("deltaw", self.name, "cuda", _basis_deltaw_matmul,
                     devices=("cuda",), requires=_other_basis,
                     note="torch.matmul of the random/orthogonal basis: "
                          "a library product, not a hand-written kernel"),
            KernelOp("factored_apply", self.name, "einsum",
                     _fourier_factored_einsum),
            KernelOp("bank_apply", self.name, "einsum",
                     _fourier_bank_einsum),
        )

    def frozen_tables(self, aux, d1, d2):
        if "entries" not in aux:
            return {}           # b1/b2 are the random/orthogonal tables
        return dict(zip(_FOURIER_TABLES,
                        fourierft.fourier_bases(aux["entries"], d1, d2)))

    def count_trainable(self, site, peft):
        return peft.n * site.stack

    def shared_storage_numbers(self, sites, peft):
        if peft.basis != "fourier":
            return 0        # b1/b2 regenerate from entry_seed
        shapes = {(s.d_in, s.d_out) for s in sites}
        return 2 * peft.n * len(shapes)


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
    ROADMAP's notes on the reference.)"""
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


def _dct_tables(aux, d1, d2):
    """C1 (d1, n), C2 (d2, n): the cached tables, else built."""
    if "c1" in aux:
        return aux["c1"], aux["c2"]
    return dct_bases(aux["entries"], d1, d2)


def _dct_factored_einsum(x, tr, aux, d1, d2, peft):
    c1, c2 = _dct_tables(aux, d1, d2)
    proj = (x.to(torch.float32) @ c1) * tr["c"].to(torch.float32)
    return proj @ c2.T * (peft.alpha / (d1 * d2))


def _dct_bank_einsum(x, tr, aux, d1, d2, peft):
    c1, c2 = _dct_tables(aux, d1, d2)
    c = _per_row(tr["c"].to(torch.float32), x.ndim)
    return ((x.to(torch.float32) @ c1) * c) @ c2.T * (peft.alpha / (d1 * d2))


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
                     devices=("cuda",), accepts=_fft_plan_accepts,
                     caps=fft_plan.DCT_CAPS,
                     note="DCT rows as FFTs in shared memory "
                          "(csrc/dct_deltaw.cu on fft_rows.cuh)"),
            KernelOp("factored_apply", self.name, "einsum",
                     _dct_factored_einsum),
            KernelOp("bank_apply", self.name, "einsum", _dct_bank_einsum),
        )

    def frozen_tables(self, aux, d1, d2):
        return dict(zip(("c1", "c2"), dct_bases(aux["entries"], d1, d2)))

    def count_trainable(self, site, peft):
        return peft.n * site.stack

    def shared_storage_numbers(self, sites, peft):
        shapes = {(s.d_in, s.d_out) for s in sites}
        return 2 * peft.n * len(shapes)


# ---------------------------------------------------------------------------
# Circulant (arXiv:2505.00580 family): one kernel g per layer, ΔW[j,k] =
# α/(d1·d2) · g[(k−j) mod M], M = max(d1, d2). The einsum ops materialize
# the (d1, d2) gather; on CUDA tensors the factored and bank applies are a
# circular convolution through `torch.fft` (kernels/ops.py
# circulant_apply_fft), as the JAX package registers XLA's FFT for them.
# ---------------------------------------------------------------------------

def _circulant_idx(d1: int, d2: int, device) -> torch.Tensor:
    m = max(d1, d2)
    j = torch.arange(d1, device=device)[:, None]
    k = torch.arange(d2, device=device)[None, :]
    return (k - j) % m


def _circ_delta(g: torch.Tensor, d1: int, d2: int, peft) -> torch.Tensor:
    g = g.to(torch.float32)
    return g[..., _circulant_idx(d1, d2, g.device)] * (peft.alpha / (d1 * d2))


def _circ_deltaw_einsum(tr, aux, d1, d2, peft):
    return _circ_delta(tr["kernel"], d1, d2, peft)


def _circ_factored_einsum(x, tr, aux, d1, d2, peft):
    return x.to(torch.float32) @ _circ_delta(tr["kernel"], d1, d2, peft)


def _circ_bank_einsum(x, tr, aux, d1, d2, peft):
    dw = _circ_delta(tr["kernel"], d1, d2, peft)           # (B, d1, d2)
    return torch.einsum("b...d,bdf->b...f", x.to(torch.float32), dw)


def _circ_fft(x, kernel, d1: int, d2: int, alpha: float, rows: bool):
    """circulant_apply_fft; on a mesh on each rank's batch rows (DTensor
    has no strategy for the FFT in torch 2.11)."""
    from repro_torch.dist.dtensor import batch_local
    from repro_torch.kernels import ops as kops
    return batch_local(lambda xl, kl: kops.circulant_apply_fft(
        xl, kl, d1, d2, alpha), x, kernel, rows)


def _circ_factored_fft(x, tr, aux, d1, d2, peft):
    return _circ_fft(x, tr["kernel"], d1, d2, peft.alpha, rows=False)


def _circ_bank_fft(x, tr, aux, d1, d2, peft):
    return _circ_fft(x, _per_row(tr["kernel"], x.ndim), d1, d2, peft.alpha,
                     rows=True)


class CirculantAdapter(AdapterMethod):
    name = "circulant"

    def init_site(self, gen, site, peft, device):
        # zero-init: fine-tuning starts at the base model (cf. LoRA's B)
        m = max(site.d_in, site.d_out)
        return {"kernel": torch.zeros((site.stack, m), device=device,
                                      dtype=torch_dtype(peft.param_dtype))}

    def trainable_leaves(self, peft):
        return ("kernel",)

    def kernel_ops(self):
        fft_note = ("torch.fft rfft circular convolution (a library call, "
                    "not a hand-written kernel)")
        return (
            KernelOp("deltaw", self.name, "einsum", _circ_deltaw_einsum),
            KernelOp("factored_apply", self.name, "einsum",
                     _circ_factored_einsum),
            KernelOp("factored_apply", self.name, "cuda", _circ_factored_fft,
                     devices=("cuda",), note=fft_note),
            KernelOp("bank_apply", self.name, "einsum", _circ_bank_einsum),
            KernelOp("bank_apply", self.name, "cuda", _circ_bank_fft,
                     devices=("cuda",), note=fft_note),
        )

    def count_trainable(self, site, peft):
        return max(site.d_in, site.d_out) * site.stack


# ---------------------------------------------------------------------------
# LoRA baseline
# ---------------------------------------------------------------------------

def _lora_deltaw_einsum(tr, aux, d1, d2, peft):
    return lora.lora_delta(tr["lora_a"], tr["lora_b"], peft.lora_alpha,
                           peft.lora_r)


def _lora_factored_einsum(x, tr, aux, d1, d2, peft):
    y = (x.to(torch.float32) @ tr["lora_a"].to(torch.float32)) \
        @ tr["lora_b"].to(torch.float32)
    return y * (peft.lora_alpha / peft.lora_r)


def _lora_bank_einsum(x, tr, aux, d1, d2, peft):
    p = torch.einsum("b...d,bdr->b...r", x.to(torch.float32),
                     tr["lora_a"].to(torch.float32))
    y = torch.einsum("b...r,brf->b...f", p, tr["lora_b"].to(torch.float32))
    return y * (peft.lora_alpha / peft.lora_r)


class LoRA(AdapterMethod):
    name = "lora"

    def init_site(self, gen, site, peft, device):
        return lora.init_lora(gen, site.d_in, site.d_out, peft.lora_r,
                              stack=site.stack,
                              dtype=torch_dtype(peft.param_dtype),
                              device=device)

    def trainable_leaves(self, peft):
        return ("lora_a", "lora_b")

    def kernel_ops(self):
        return (
            KernelOp("deltaw", self.name, "einsum", _lora_deltaw_einsum),
            KernelOp("factored_apply", self.name, "einsum",
                     _lora_factored_einsum),
            KernelOp("bank_apply", self.name, "einsum", _lora_bank_einsum),
        )

    def count_trainable(self, site, peft):
        return peft.lora_r * (site.d_in + site.d_out) * site.stack


# ---------------------------------------------------------------------------
# BitFit baseline: a bias shift, not a weight delta (linear_delta=False);
# merging adds to (or creates) the site's `__b` bias leaf. No deltaw op, so
# site_delta raises through the base class's registry miss.
# ---------------------------------------------------------------------------

def _bitfit_factored_einsum(x, tr, aux, d1, d2, peft):
    return tr["delta_b"].to(torch.float32).expand(*x.shape[:-1], d2)


def _bitfit_bank_einsum(x, tr, aux, d1, d2, peft):
    b = _per_row(tr["delta_b"].to(torch.float32), x.ndim)   # (B, 1.., d2)
    return b.expand(*x.shape[:-1], d2)


class BitFit(AdapterMethod):
    name = "bitfit"
    linear_delta = False

    def init_site(self, gen, site, peft, device):
        return {"delta_b": torch.zeros((site.stack, site.d_out),
                                       device=device,
                                       dtype=torch_dtype(peft.param_dtype))}

    def trainable_leaves(self, peft):
        return ("delta_b",)

    def kernel_ops(self):
        return (
            KernelOp("factored_apply", self.name, "einsum",
                     _bitfit_factored_einsum),
            KernelOp("bank_apply", self.name, "einsum", _bitfit_bank_einsum),
        )

    def merge_site(self, eff, key, adapter, site, peft):
        bkey = key + "__b"
        db = adapter["delta_b"]
        eff[bkey] = (eff[bkey] + db) if bkey in eff else db

    def count_trainable(self, site, peft):
        return site.d_out * site.stack


# ---------------------------------------------------------------------------
# Degenerate methods: no adapter state
# ---------------------------------------------------------------------------

class NoAdapter(AdapterMethod):
    name = "none"
    has_site_params = False


class FullFinetune(AdapterMethod):
    name = "full"
    has_site_params = False
    trains_base = True


register(FourierFT())
register(DCTAdapter())
register(CirculantAdapter())
register(LoRA())
register(BitFit())
register(NoAdapter())
register(FullFinetune())
