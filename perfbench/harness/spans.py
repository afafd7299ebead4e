"""The program's spans in a traced stretch, and the device time each one
caused.

The program opens `torch.profiler.record_function` ranges named
`repro_torch/<name>` (`repro_torch/core/spans.py`): `step`, `adapter`,
`layer` and `attention/<path>`, forward and backward alike. They are host
events of the `Trace`, on the device's clock. A device operation is
charged to the chain of ranges that were open when its launch was called:

- its launch is the host's launch call (`cudaLaunchKernel`,
  `cuLaunchKernelEx`, `cudaMemcpyAsync`, ...) that carries the same
  correlation id as the operation. (Pairing by order, the k-th
  operation of a kind with the k-th launch of that kind, slips: one
  launch stamped after its operation's start shifts every later pairing
  by one.) A trace without correlation ids is attributed nothing;
- its chain is every program range open at the launch's start. In the
  forward and the recompute that is the range the launching thread is
  in. The backward runs on the autograd engine's thread; the program
  opens a node's forward range around the node while it runs (the
  forward op and its backward node share a sequence number), so the same
  rule holds there. The main thread's `step` stays open meanwhile;
- a `layer` range that opens inside an `autograd::engine::evaluate_function`
  event is a recompute (`torch.utils.checkpoint` re-entering the layer in
  the backward);
- an operation launched outside every range has an empty chain: it is
  unattributed, and so is one with no launch to pair.

The `Trace` keeps names, intervals and correlation ids (no thread or
sequence number), which is why the chain goes by time.
"""
from __future__ import annotations

import bisect
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from harness.trace import Trace

PREFIX = "repro_torch/"
BACKWARD_NODE = "autograd::engine::evaluate_function"
STEP = PREFIX + "step"
LAYER = PREFIX + "layer"
ADAPTER = PREFIX + "adapter"
ATTENTION = PREFIX + "attention/"


def launch_kind(name: str) -> Optional[str]:
    """The kind of device operation a host call launches, or None."""
    if name.startswith(("cudaLaunchHostFunc", "cudaGraph")):
        return None
    if name.startswith(("cudaLaunch", "cuLaunch")):
        return "kernel"
    if name.startswith(("cudaMemcpy", "cuMemcpy")):
        return "memcpy"
    if name.startswith(("cudaMemset", "cuMemset")):
        return "memset"
    return None


def device_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


@dataclass(frozen=True)
class Range:
    name: str
    start: float
    end: float
    recompute: bool = False


@dataclass
class Attribution:
    device: List[Tuple[str, float, float]]      # the trace's operations
    ranges: List[Range]
    # per device operation of the trace (its order): the ranges open at its
    # launch, outermost first; () where unattributed
    chains: List[Tuple[Range, ...]]
    paired: int                      # device operations paired to a launch
    launches: Dict[str, int]         # launch calls by kind
    ops: Dict[str, int]              # device operations by kind

    def busy_s(self, pick) -> float:
        """Device busy time (the union of intervals) of the operations
        whose chain satisfies `pick(chain)`."""
        return Trace(0.0, [op for op, ch in zip(self.device, self.chains)
                           if pick(ch)]).busy_s()


def program_ranges(trace) -> List[Range]:
    """The program's ranges, each marked whether it opened inside a
    backward node (a recompute)."""
    nodes = _merged(sorted((a, b) for n, a, b in trace.host
                           if n.startswith(BACKWARD_NODE)))
    starts = [a for a, _ in nodes]
    out = []
    for n, a, b in trace.host:
        if not n.startswith(PREFIX):
            continue
        i = bisect.bisect_right(starts, a) - 1
        inside = i >= 0 and nodes[i][0] <= a <= nodes[i][1]
        out.append(Range(n, a, b, inside and n == LAYER))
    out.sort(key=lambda r: (r.start, -r.end))
    return out


def _merged(intervals):
    out: List[List[float]] = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def chains_at(ranges: List[Range], instants: List[float]
              ) -> List[Tuple[Range, ...]]:
    """For each instant, the ranges open there, outermost first."""
    order = sorted(range(len(instants)), key=instants.__getitem__)
    out: List[Tuple[Range, ...]] = [()] * len(instants)
    active: List[Range] = []
    j = 0
    for i in order:
        t = instants[i]
        while j < len(ranges) and ranges[j].start <= t:
            active.append(ranges[j])
            j += 1
        active = [r for r in active if r.end >= t]
        out[i] = tuple(active)
    return out


def has_ids(trace) -> bool:
    """Whether the trace holds a correlation id for every device operation
    and host event, some of them set."""
    return len(trace.device_ids) == len(trace.device) \
        and len(trace.host_ids) == len(trace.host) \
        and any(trace.device_ids)


def pair_launches(trace) -> Tuple[List[Optional[float]], Dict, Dict]:
    """For each device operation of the trace, the start of the launch
    call with its correlation id (None where there is none), and the
    counts of launches and operations by kind."""
    launches: Dict[str, int] = {}
    launch_at: Dict[int, float] = {}
    for (n, a, _), cid in zip(trace.host, trace.host_ids):
        kind = launch_kind(n)
        if kind is not None:
            launches[kind] = launches.get(kind, 0) + 1
            if cid:
                launch_at[cid] = a
    ops: Dict[str, int] = {}
    for name, _, _ in trace.device:
        ops[device_kind(name)] = ops.get(device_kind(name), 0) + 1
    return [launch_at.get(cid) for cid in trace.device_ids], launches, ops


def attribute(trace) -> Optional[Attribution]:
    """The attribution of a trace's device time to the program's spans;
    None where the trace holds no program span, no device operation or no
    correlation ids."""
    ranges = program_ranges(trace)
    if not ranges or not trace.device or not has_ids(trace):
        return None
    at, launches, ops = pair_launches(trace)
    found = [i for i, t in enumerate(at) if t is not None]
    chains: List[Tuple[Range, ...]] = [()] * len(at)
    for i, ch in zip(found, chains_at(ranges, [at[i] for i in found])):
        chains[i] = ch
    return Attribution(trace.device, ranges, chains, len(found), launches,
                       ops)


def has(prefix: str):
    return lambda chain: any(r.name.startswith(prefix) for r in chain)


def recomputed(chain) -> bool:
    return any(r.recompute for r in chain)


def gaps(trace) -> List[Tuple[float, float]]:
    """Every interval of the stretch in which no device operation ran (the
    gaps `Trace.idle_gaps` ranks)."""
    out, end = [], 0.0
    for _, a, b in sorted(trace.device, key=lambda e: e[1]):
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if end < trace.span_s:
        out.append((end, trace.span_s))
    return out


def per_step_ms(run, metric: str, seconds_of) -> Optional[float]:
    """`seconds_of(attribution)` over the traced steps, in ms; None where
    the run traced no program span (the line then leaves `metric` out)."""
    if run.kind != "train" or run.trace is None:
        return None
    att = attribute(run.trace)
    if att is None:
        return None
    log_unattributed(metric, att)
    return 1e3 * seconds_of(att) / run.mix["trace_steps"]


def log_unattributed(metric: str, att: Attribution) -> None:
    """The share of busy time left unattributed, on the run's log."""
    total = att.busy_s(lambda ch: True)
    left = att.busy_s(lambda ch: not ch)
    outside = att.busy_s(lambda ch: not any(r.name == STEP for r in ch))
    share = 100.0 * left / total if total > 0 else float("nan")
    print(f"perfbench: {metric}: unattributed {share:.2f} % of device busy "
          f"time ({att.paired} of {len(att.chains)} operations paired to "
          f"a launch by correlation id; launches {att.launches}, "
          f"operations {att.ops}; "
          f"outside the step {1e3 * outside:.3f} ms)",
          file=sys.stderr, flush=True)


def idle_in(att: Attribution, span_s: float, name: str) -> float:
    """Seconds of the stretch's idle gaps whose middle falls inside a range
    called `name`."""
    inside = [r for r in att.ranges if r.name == name]
    idle = gaps(Trace(span_s, att.device))
    hit = chains_at(inside, [0.5 * (a + b) for a, b in idle])
    return sum(b - a for (a, b), ch in zip(idle, hit) if ch)
