"""Kernel-op registry and backend policy.

Every adapter hot-spot computation is a `KernelOp` keyed by
``(op, method, backend)``, as in the JAX package:

    op      — "deltaw" (dense ΔW materialization), "factored_apply"
              (the y-contribution without ΔW), "bank_apply" (its row-batched
              form for the serving adapter bank), "paged_attention"
    method  — the owning `AdapterMethod.name` (model-side ops are owned by a
              shim with the same `name`/`kernel_ops()` surface,
              kernels/paged_attention.OWNER)
    backend — "cuda" (the accelerated version for CUDA tensors: a
              hand-written Hopper kernel, or circulant's `torch.fft` apply,
              whose note says so) or "einsum" (the plain PyTorch version)

Methods declare their implementations through `AdapterMethod.kernel_ops()`;
declarations are collected lazily on first dispatch (`ensure_method`). One
key may hold several routes told apart by their `requires` predicates
(FourierFT's `cuda` ΔW: K1 for the Fourier basis, a `torch.matmul` for the
random and orthogonal bases); resolution takes the first that passes, and
`KernelPolicy.explain()` prints the chosen route's note.

Resolution keys on the device of the tensors the op will see, not on a
platform string. `PEFTConfig.kernel_backend` keeps the JAX names:

    auto, pallas — the CUDA kernel for CUDA tensors, the plain version for
                   CPU tensors (the kernel does not run there);
    einsum       — the plain version everywhere (an explicit choice);
    interpret    — rejected: Pallas interpret mode has no meaning here.

Unlike the TPU registry, a CUDA-resident site that the kernel cannot take
(its config predicate or its shape limits fail) RAISES at resolution, so
`KernelPolicy.build` refuses it before any launch, instead of degrading
silently to the plain version. An op registered only as `einsum` (the
factored and bank applies of most methods: plain matrix products in the
JAX package too) resolves to `einsum` on CUDA tensors as well: that is its
only implementation, not a degrade.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

OPS = ("deltaw", "factored_apply", "bank_apply", "paged_attention")
BACKENDS = ("cuda", "einsum")

# candidate chain per requested policy; first supported op wins
CANDIDATES: Dict[str, Tuple[str, ...]] = {
    "auto": ("cuda", "einsum"),
    "pallas": ("cuda", "einsum"),
    "einsum": ("einsum",),
}


class KernelUnavailableError(KeyError):
    """No registered backend for (op, method) satisfies the constraints."""


@dataclass(frozen=True)
class KernelOp:
    """One backend implementation of one op for one adapter method.

    fn signatures (the adapter ops return f32; the dispatch site casts):
        deltaw:          fn(trainable, aux, d1, d2, peft) -> (stack?, d1, d2)
        factored_apply:  fn(x, trainable, aux, d1, d2, peft) -> (..., d2)
        bank_apply:      fn(x, trainable, aux, d1, d2, peft) -> (B, ..., d2)
        paged_attention: fn(q, k_pages, v_pages, block_table, kv_len)

    Constraints: `devices` (device types the op runs on; None = any),
    `requires` (predicate on the PEFTConfig) and `accepts`, the kernel's
    shape limits: `accepts(d1, d2, peft, dtype) -> (ok, why)`, where
    (d1, d2) is the site (deltaw) or (kv heads, head_dim) (paged_attention),
    `peft` may be None and `dtype` is the tensors' dtype or None (not
    known). A CUDA-resident site beyond them is refused at resolution,
    naming the limit; nothing degrades to the plain version.

    `caps` is the hand-written kernel's capability record: what its C side
    assumes (the width and signedness of its phase products, the shared
    memory a block may request, what sits in it, the sizes of its register
    arrays and template instances). `analysis.kernel_audit` re-derives the
    shape limits `accepts` enforces from it and checks it against the
    sources; an op without caps has nothing to verify."""
    op: str
    method: str
    backend: str
    fn: Callable
    devices: Optional[Tuple[str, ...]] = None
    requires: Optional[Callable] = None
    accepts: Optional[Callable] = None
    note: str = ""
    caps: Optional[Dict] = None

    def supports(self, d1: int, d2: int, peft=None, device: str = "cpu",
                 dtype: Optional[torch.dtype] = None) -> Tuple[bool, str]:
        """-> (ok, reason-if-not). `peft=None` skips config predicates."""
        if self.devices is not None and device not in self.devices:
            return False, f"device {device!r} not in {self.devices}"
        if self.requires is not None and peft is not None \
                and not self.requires(peft):
            return False, "config constraint (requires)"
        if self.accepts is not None:
            return self.accepts(d1, d2, peft, dtype)
        return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# (op, method, backend) -> its routes, in registration order
_OPS: Dict[Tuple[str, str, str], Tuple[KernelOp, ...]] = {}
_ENSURED: set = set()


def register_kernel_op(op: KernelOp) -> KernelOp:
    """Add `op` as a route of its key. A key takes a second route only
    when every route of it carries a `requires` predicate, and never the
    same fn or note twice."""
    if op.op not in OPS:
        raise ValueError(f"unknown kernel op {op.op!r}; one of {OPS}")
    if op.backend not in BACKENDS:
        raise ValueError(f"unknown backend {op.backend!r}; one of {BACKENDS}")
    key = (op.op, op.method, op.backend)
    old = _OPS.get(key, ())
    routes = old + (op,)
    if len(routes) > 1 and (
            any(r.requires is None for r in routes)
            or any(r.fn is op.fn or r.note == op.note for r in old)):
        raise ValueError(f"kernel op {key} already registered")
    _OPS[key] = routes
    return op


def _method_obj(method):
    """Accept an AdapterMethod instance or its registry name (resolved
    lazily — api.py must not import core.adapter at module level)."""
    if isinstance(method, str):
        from repro_torch.core import adapter as adapter_api
        return adapter_api.resolve(method)
    return method


def ensure_method(method) -> None:
    """Collect `method.kernel_ops()` into the registry, once per method."""
    m = _method_obj(method)
    if m.name in _ENSURED:
        return
    ops = tuple(m.kernel_ops())
    for op in ops:
        if (op.op, op.method, op.backend) in _OPS:
            raise ValueError(f"kernel op {(op.op, op.method, op.backend)} "
                             "already registered")
    for op in ops:
        register_kernel_op(op)
    _ENSURED.add(m.name)


def all_ops() -> Tuple[KernelOp, ...]:
    """Every registered route, after collecting the declarations of every
    registered adapter method and of the paged-attention owner."""
    from repro_torch.core import adapter as adapter_api
    from repro_torch.kernels import paged_attention
    for name in adapter_api.registered_methods():
        ensure_method(name)
    ensure_method(paged_attention.OWNER)
    return tuple(op for routes in _OPS.values() for op in routes)


def ops_for(method) -> Tuple[str, ...]:
    """Op names the method has any backend registered for."""
    m = _method_obj(method)
    ensure_method(m)
    return tuple(o for o in OPS
                 if any((o, m.name, b) in _OPS for b in BACKENDS))


def backends_for(op: str, method) -> Tuple[str, ...]:
    m = _method_obj(method)
    ensure_method(m)
    return tuple(b for b in BACKENDS if (op, m.name, b) in _OPS)


def requested_backend(peft) -> str:
    return _validated(getattr(peft, "kernel_backend", None) or "auto")


def _validated(requested: str) -> str:
    if requested == "interpret":
        raise ValueError(
            "kernel_backend='interpret' selects Pallas interpret mode, which "
            "has no meaning in the PyTorch port: use 'auto'/'pallas' (the "
            "CUDA kernel on the card) or 'einsum' (the plain version)")
    if requested not in CANDIDATES:
        raise ValueError(f"unknown kernel backend {requested!r}; one of "
                         f"{sorted(CANDIDATES) + ['interpret']}")
    return requested


def _device_type(device: Union[str, torch.device]) -> str:
    return torch.device(device).type


def resolve_op(op: str, method, peft=None, d1: int = 0, d2: int = 0, *,
               device: Union[str, torch.device], backend: Optional[str] = None,
               dtype: Optional[torch.dtype] = None,
               missing_ok: bool = False) -> Optional[KernelOp]:
    """First registered route along the requested policy's candidate
    chain whose constraints pass for tensors of `dtype` on `device`.
    `backend` overrides `peft.kernel_backend`. When the `cuda` routes that
    exist all refuse a CUDA-resident site, it raises KernelUnavailableError
    naming each route's reason (no silent degrade on the card)."""
    m = _method_obj(method)
    ensure_method(m)
    requested = _validated(backend) if backend else requested_backend(peft)
    dev = _device_type(device)
    for b in CANDIDATES[requested]:
        whys = []
        for cand in _OPS.get((op, m.name, b), ()):
            ok, why = cand.supports(d1, d2, peft, dev, dtype)
            if ok:
                return cand
            whys.append(why)
        if whys and b == "cuda" and dev == "cuda":
            raise KernelUnavailableError(
                f"the CUDA kernel for ({op!r}, {m.name!r}) cannot take this "
                f"{d1}x{d2} site on {dev}: {'; '.join(whys)}")
    if missing_ok:
        return None
    raise KernelUnavailableError(
        f"no kernel op for ({op!r}, {m.name!r}) under backend={requested!r} "
        f"on {dev}; registered backends: {backends_for(op, m)}")


# ---------------------------------------------------------------------------
# Policy: per-model resolution snapshot
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Resolution:
    site: str
    d1: int
    d2: int
    op: str
    backend: str          # "" when nothing resolved (validate() rejects)
    bank: str = ""        # the adapter-bank group's method, for its ops
    note: str = ""        # the chosen route's note (which kernel or call)


@dataclass(frozen=True)
class KernelPolicy:
    """Backend choice for every targeted (site, op) pair of one model on
    one device."""
    method: str
    requested: str
    device: str
    resolutions: Tuple[Resolution, ...] = ()

    @classmethod
    def build(cls, method, sites: Sequence, peft,
              device: Union[str, torch.device],
              bank_profiles: Optional[Dict] = None) -> "KernelPolicy":
        """`bank_profiles` ({method name: PEFTConfig}, the serving adapter
        bank's groups) adds each group's `bank_apply` at its targeted
        `layers/` sites, resolved under the group's own profile."""
        m = _method_obj(method)
        ensure_method(m)
        requested = requested_backend(peft)
        dev = _device_type(device)
        res = []

        def targeted(prof):
            targets = getattr(prof, "target_modules", ())
            return [s for s in sites if s.name.split("/")[-1] in targets]

        if getattr(m, "has_site_params", True):
            for s in targeted(peft):
                for op in ops_for(m):
                    chosen = resolve_op(op, m, peft, s.d_in, s.d_out,
                                        device=dev, missing_ok=True)
                    res.append(Resolution(s.name, s.d_in, s.d_out, op,
                                          chosen.backend if chosen else "",
                                          note=chosen.note if chosen
                                          else ""))
        for name, prof in sorted((bank_profiles or {}).items()):
            for s in targeted(prof):
                if not s.name.startswith("layers/"):
                    continue
                chosen = resolve_op("bank_apply", name, prof, s.d_in,
                                    s.d_out, device=dev, missing_ok=True)
                res.append(Resolution(s.name, s.d_in, s.d_out, "bank_apply",
                                      chosen.backend if chosen else "",
                                      bank=name,
                                      note=chosen.note if chosen else ""))
        return cls(m.name, requested, dev, tuple(res))

    def backend_for(self, site: str, op: str,
                    bank: str = "") -> Optional[str]:
        for r in self.resolutions:
            if r.site == site and r.op == op and r.bank == bank:
                return r.backend or None
        return None

    def validate(self) -> "KernelPolicy":
        dead = [f"{r.op}@{r.site}" + (f" (bank {r.bank})" if r.bank else "")
                for r in self.resolutions if not r.backend]
        if dead:
            raise KernelUnavailableError(
                f"method {self.method!r}: no backend resolved for {dead} "
                f"under kernel_backend={self.requested!r} on {self.device}")
        return self

    def explain(self) -> str:
        """Human-readable per-site resolution report."""
        head = (f"kernel policy: method={self.method} "
                f"requested={self.requested} device={self.device}")
        if not self.resolutions:
            return head + "\n  (no registered kernel ops for this method)"
        return "\n".join([head] + [
            f"  {r.site} ({r.d1}x{r.d2}) {r.op}"
            + (f" [bank {r.bank}]" if r.bank else "")
            + f" -> {r.backend or 'UNRESOLVED'}"
            + (f" ({r.note})" if r.note else "") for r in self.resolutions])
