"""Dispatch lint: the port's counterpart of the JAX package's
`src/repro/analysis/hlo_lint.py`.

Eager PyTorch has no HLO; the graph a step runs is what the dispatcher
sees. `DispatchRecorder` is a `TorchDispatchMode` that records every aten
op a region of code dispatches (forward, backward and optimizer alike),
with its dtypes and devices, region by region: a train step, one
scheduler round. It works on the CPU as on the card. The checks keep the
JAX rule ids:

- **host transfers** (`host-transfer`, `host-transfer-in-loop`): the ops
  that make the host wait for the device: `aten._local_scalar_dense`
  (`.item()`, `int()`/`float()`/`bool()` of a tensor), blocking copies
  between the card and the host (`_to_copy`/`copy_` without
  `non_blocking`, either way: the host waits for the stream), and the ops
  whose output shape depends on the data (`nonzero`, `masked_select`,
  `unique`, indexing by a bool mask, ...), on tensors of the linted
  device. Regions recorded as loop iterations (`region(loop=True)`: a
  train step, a decode round) give `host-transfer-in-loop` with `mult` the
  count per iteration, as the HLO trip count was; one-off regions give
  `host-transfer`. Each finding names the source lines behind it. On the
  CPU there are no copies to count, only the scalar reads and the
  data-dependent ops.
- **f32-literal upcasts** (`upcast-f32-literal`): a binary arithmetic op
  that takes a 0-dim f32 tensor constant and an operand the region upcast
  from bf16/f16 (a Python float stays weak and never trips this).
- **donation** (`donation-miss`): `donation_findings` compares the
  `data_ptr()` of every parameter and optimizer-state tensor before and
  after a step: a changed pointer means the update was not done in place,
  so peak memory holds one copy more.
- **recompiles** (`recompile-budget`): `recompile_findings(counts,
  bounds, label)` and `scheduler_recompile_findings(sched, label)` keep
  JAX's signatures, over the scheduler's recorded dispatch signatures
  (`ContinuousScheduler.compiled_signatures`).
"""
from __future__ import annotations

import contextlib
import os
import traceback
import weakref
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Mapping, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.report import Finding

SECTION = "dispatch"
# ops whose output shape depends on the data: the host reads a count back
_DATA_DEPENDENT = {"nonzero", "masked_select", "unique", "_unique",
                   "_unique2", "unique_consecutive", "unique_dim",
                   "argwhere", "nonzero_static"}
_BINARY_ARITH = {"add", "sub", "mul", "div", "maximum", "minimum", "rsub"}
_SMALL_FLOATS = (torch.bfloat16, torch.float16)
_PKG = "repro_torch"


_TORCH_DIR = os.path.dirname(torch.__file__)
_HERE = os.path.dirname(os.path.abspath(__file__))


def _source_line() -> str:
    """The innermost frame outside torch, this package and the standard
    library's context managers that led to the op, port paths from the
    package root: 'repro_torch/serve/engine.py:560'."""
    for frame in reversed(traceback.extract_stack()):
        path = frame.filename
        if path.startswith((_TORCH_DIR, _HERE)) \
                or path.endswith("contextlib.py"):
            continue
        norm = path.replace("\\", "/")
        if f"/{_PKG}/" in norm:
            norm = _PKG + "/" + norm.split(f"/{_PKG}/", 1)[1]
        else:
            norm = norm.rsplit("/", 1)[-1]
        return f"{norm}:{frame.lineno}"
    return "?"


@dataclass
class Region:
    """What one region dispatched: op counts by aten name, host transfers
    by kind (each with the source lines behind it), upcast literals by
    op."""
    label: str
    loop: bool
    ops: Counter = field(default_factory=Counter)
    transfers: Dict[str, Counter] = field(default_factory=dict)
    upcasts: Counter = field(default_factory=Counter)

    @property
    def n_transfers(self) -> int:
        return sum(sum(c.values()) for c in self.transfers.values())


class DispatchRecorder(TorchDispatchMode):
    """Records the aten ops dispatched inside `region(...)` blocks. Enter
    it once around the whole run (`with recorder:`), then mark regions;
    ops outside a region are not recorded. `device` is the device whose
    tensors count as the device side (the card, or the CPU when the run
    rehearses there)."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device)
        self.regions: List[Region] = []
        self._cur: Optional[Region] = None
        self._upcast: Dict[int, weakref.ref] = {}

    @contextlib.contextmanager
    def region(self, label: str, loop: bool = False) -> Iterator[Region]:
        """Record the ops of the block as one region. The label may be set
        on the yielded Region before the block ends (a scheduler round is
        named by what it did)."""
        if self._cur is not None:
            raise RuntimeError("regions do not nest")
        self._cur = Region(label, loop)
        try:
            yield self._cur
        finally:
            self.regions.append(self._cur)
            self._cur = None
            self._upcast.clear()

    # ---- classification ----------------------------------------------------
    def _on_device(self, t) -> bool:
        return isinstance(t, torch.Tensor) \
            and t.device.type == self.device.type

    def _transfer(self, name: str, args, kwargs) -> Optional[str]:
        if name == "_local_scalar_dense":
            return name if self._on_device(args[0]) else None
        if name in _DATA_DEPENDENT:
            return name if args and self._on_device(args[0]) else None
        if name == "index" and len(args) > 1 and self._on_device(args[0]):
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in (args[1] or ())):
                return "index[bool]"
            return None
        if self.device.type == "cpu":
            return None          # no copy crosses to a host from the host
        if name == "_to_copy":
            src = args[0]
            dst = kwargs.get("device")
            if dst is None or kwargs.get("non_blocking", False):
                return None
            return self._direction(src.device, torch.device(dst))
        if name == "copy_":
            dst, src = args[0], args[1]
            non_blocking = args[2] if len(args) > 2 \
                else kwargs.get("non_blocking", False)
            if non_blocking or not isinstance(src, torch.Tensor):
                return None
            return self._direction(src.device, dst.device)
        return None

    def _direction(self, src: torch.device, dst: torch.device
                   ) -> Optional[str]:
        if src.type == dst.type:
            return None
        if src.type == self.device.type and dst.type == "cpu":
            return "copy_d2h"
        if src.type == "cpu" and dst.type == self.device.type:
            return "copy_h2d"
        return None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # DTensor runs it; its local ops and collectives come back
            # through this mode, and those are what run on the device
            return NotImplemented
        out = func(*args, **kwargs)
        region = self._cur
        if region is None:
            return out
        name = func.overloadpacket.__name__
        region.ops[name] += 1
        what = self._transfer(name, args, kwargs)
        if what is not None:
            region.transfers.setdefault(what, Counter())[_source_line()] += 1
        if name == "_to_copy" and isinstance(out, torch.Tensor) \
                and out.dtype == torch.float32 \
                and isinstance(args[0], torch.Tensor) \
                and args[0].dtype in _SMALL_FLOATS:
            self._upcast[id(out)] = weakref.ref(out)
        elif name in _BINARY_ARITH and len(args) >= 2:
            a, b = args[0], args[1]
            for lit, other in ((a, b), (b, a)):
                if (isinstance(lit, torch.Tensor) and lit.ndim == 0
                        and lit.dtype == torch.float32
                        and not lit.requires_grad
                        and isinstance(other, torch.Tensor)
                        and self._is_upcast(other)):
                    region.upcasts[name] += 1
                    break
        return out

    def _is_upcast(self, t: torch.Tensor) -> bool:
        ref = self._upcast.get(id(t))
        return ref is not None and ref() is t

    # ---- reading ------------------------------------------------------------
    def labels(self) -> List[str]:
        return sorted({r.label for r in self.regions})

    def summary(self, label: str) -> Dict:
        """{"regions", "ops" per region, "transfers": {kind: {"per_region",
        "sites": {source line: count}}}, "transfers_per_region"} of one
        label's regions."""
        regs = [r for r in self.regions if r.label == label]
        n = max(1, len(regs))
        kinds: Dict[str, Counter] = {}
        for r in regs:
            for what, sites in r.transfers.items():
                kinds.setdefault(what, Counter()).update(sites)
        return {
            "regions": len(regs),
            "ops_per_region": sum(sum(r.ops.values()) for r in regs) / n,
            "transfers_per_region": sum(r.n_transfers for r in regs) / n,
            "transfers": {what: {"per_region": sum(s.values()) / n,
                                 "sites": dict(s.most_common())}
                          for what, s in sorted(kinds.items())},
        }

    def findings(self, prefix: str = "") -> List[Finding]:
        """Host-transfer and upcast findings aggregated per (label, kind):
        `mult` is the count per region of that label."""
        out: List[Finding] = []
        for label in self.labels():
            regs = [r for r in self.regions if r.label == label]
            loop = any(r.loop for r in regs)
            s = self.summary(label)
            where = f"{prefix}{label}"
            for what, t in s["transfers"].items():
                sites = ", ".join(f"{k} x{v}" for k, v in t["sites"].items())
                rule = "host-transfer-in-loop" if loop else "host-transfer"
                detail = ("inside the loop — it stalls every iteration"
                          if loop else "a device→host wait per call")
                out.append(Finding(
                    SECTION, rule, f"{where}/{what}",
                    f"'{what}' makes the host wait for the device, {detail}; "
                    f"from {sites}", mult=t["per_region"]))
            ups = Counter()
            for r in regs:
                ups.update(r.upcasts)
            for op, count in sorted(ups.items()):
                out.append(Finding(
                    SECTION, "upcast-f32-literal", f"{where}/{op}",
                    "0-dim f32 constant combined with a value upcast from "
                    "bf16/f16 — this op runs in f32; keep the constant a "
                    "Python float, or baseline if the f32 region is "
                    "deliberate", mult=count / len(regs)))
        return out


# ---------------------------------------------------------------------------
# donation / recompiles
# ---------------------------------------------------------------------------

def state_leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{leaf path: tensor} of a nested dict."""
    out: Dict[str, torch.Tensor] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(state_leaves(v, f"{prefix}{k}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix.rstrip("/")] = tree
    return out


def data_ptrs(tree) -> Dict[str, int]:
    """{leaf path: data_ptr()} of every tensor in a nested dict."""
    return {k: t.data_ptr() for k, t in state_leaves(tree).items()}


def donation_findings(before: Mapping[str, int], after_tree,
                      label: str) -> List[Finding]:
    """Leaves of `after_tree` (the state a step returned) whose storage is
    not the one `before` (`data_ptrs` of the state it took) recorded: each
    was rebuilt out of place, so the step held both copies."""
    after = state_leaves(after_tree)
    moved = sorted(k for k in before
                   if k in after and after[k].data_ptr() != before[k])
    if not moved:
        return []
    nbytes = sum(after[k].numel() * after[k].element_size() for k in moved)
    return [Finding(
        SECTION, "donation-miss", label,
        f"{len(moved)} of {len(before)} state tensors ({nbytes} bytes) "
        f"were replaced, not updated in place (e.g. "
        f"{', '.join(moved[:3])}): peak memory holds the old and the new "
        "copy", mult=float(len(moved)))]


def recompile_findings(counts: Mapping[str, int],
                       bounds: Mapping[str, int],
                       label: str) -> List[Finding]:
    """Flag every dispatch point whose signature count exceeds its declared
    bound (see ContinuousScheduler.expected_compile_bounds)."""
    out: List[Finding] = []
    for name in sorted(counts):
        bound = bounds.get(name)
        if bound is not None and counts[name] > bound:
            out.append(Finding(
                SECTION, "recompile-budget", f"{label}/{name}",
                f"{counts[name]} dispatch signatures for '{name}' exceeds "
                f"the declared bound {bound} — a shape leaked past the pow2 "
                "bucketing (serve/scheduler/runtime.py _bucket)"))
    return out


def scheduler_recompile_findings(sched, label: str = "serve"
                                 ) -> List[Finding]:
    """Recompile audit of a live ContinuousScheduler after it has served
    traffic: its recorded signature counts vs its own declared bounds."""
    return recompile_findings(sched.compiled_signatures(),
                              sched.expected_compile_bounds(), label)
