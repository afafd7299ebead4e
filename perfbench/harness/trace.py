"""The device trace of a short steady stretch of the window, from
`torch.profiler` (CUPTI), reduced in memory: the device's operations as
intervals, the host's operations beside them, and what both add up to.
Nothing is written to disk.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# device activities that are not work: annotations projected onto the
# device's timeline, and synchronisation markers
NOT_WORK = ("annotation", "sync", "overhead")


@dataclass
class Trace:
    """Intervals in seconds from the stretch's start."""
    span_s: float
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    # the profiler's correlation id of each device operation and of each
    # host event, in the order of `device` and `host` (0 where an event has
    # none; both empty where the trace was made without them): a launch
    # call and the operation it launched share one
    device_ids: List[int] = field(default_factory=list)
    host_ids: List[int] = field(default_factory=list)

    def busy_s(self) -> float:
        """Length of the union of the device's operation intervals."""
        busy, end = 0.0, 0.0
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            if b <= end:
                continue
            busy += b - max(a, end)
            end = b
        return busy

    def kernel_s(self, names) -> Tuple[float, int]:
        """Summed device seconds and count of operations whose name holds
        any of `names`."""
        hits = [b - a for n, a, b in self.device
                if any(k in n for k in names)]
        return sum(hits), len(hits)

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, a, b in self.device:
            by[short(n)] = by.get(short(n), 0.0) + (b - a)
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The longest gaps between device operations, each named by the
        host operation that began last before the gap's middle and was
        still running there (else the last one that began)."""
        gaps, end = [], 0.0
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if end < self.span_s:
            gaps.append((end, self.span_s))
        gaps.sort(key=lambda g: g[0] - g[1])
        host = sorted(self.host, key=lambda e: e[1])
        out = []
        for a, b in gaps[:k]:
            mid = 0.5 * (a + b)
            name, last = "(no host operation)", None
            for n, ha, hb in host:
                if ha > mid:
                    break
                if hb >= mid:
                    name = short(n)
                last = n
            if name == "(no host operation)" and last is not None:
                name = short(last)
            out.append([name, b - a])
        return out


def short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0][:120]


def _ns(ev, what: str) -> float:
    fn = getattr(ev, what + "_ns", None)
    if fn is not None:
        return float(fn())
    return float(getattr(ev, what + "_us")()) * 1e3


def capture(prof, t0_ns: int, t1_ns: int) -> Trace:
    """The Trace of a finished `torch.profiler.profile` over the stretch
    [t0_ns, t1_ns] of `time.time_ns()` (the profiler stamps its events on
    the same epoch clock; should it not, the first event opens the
    stretch). Intervals are clipped to the stretch."""
    events = prof.profiler.kineto_results.events()
    dev, host, starts = [], [], []
    for ev in events:
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        kind = str(ev.activity_type()).lower() \
            if hasattr(ev, "activity_type") else ""
        is_dev = "cuda" in str(ev.device_type()).lower()
        cid = int(ev.correlation_id()) \
            if hasattr(ev, "correlation_id") else 0
        if is_dev and not any(k in kind for k in NOT_WORK):
            dev.append((ev.name(), start, end, cid))
        elif not is_dev:
            host.append((ev.name(), start, end, cid))
        starts.append(start)
    origin = float(t0_ns)
    if starts and abs(min(starts) - origin) > 60e9:
        origin = min(starts)
    span = (t1_ns - t0_ns) * 1e-9

    def clip(items):
        out, ids = [], []
        for n, a, b, cid in items:
            a, b = max((a - origin) * 1e-9, 0.0), min((b - origin) * 1e-9,
                                                       span)
            if b > a:
                out.append((n, a, b))
                ids.append(cid)
        return out, ids
    (device, device_ids), (host, host_ids) = clip(dev), clip(host)
    return Trace(span_s=span, device=device, host=host,
                 device_ids=device_ids, host_ids=host_ids)
