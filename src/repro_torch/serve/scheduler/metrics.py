"""Serving metrics for the continuous runtime (a copy of the JAX package's
`serve/scheduler/metrics.py`; it is plain Python):
per-request TTFT, per-step batch occupancy, end-to-end tokens/s.

Step-denominated stamps (arrival/admit/first token/finish) use the
scheduler's decode-step clock — deterministic, replay-stable, and what the
admission policy actually trades off. Wall-clock covers the whole drain
(prefills, bank loads, dispatch overhead), so tokens_per_s is honest
end-to-end throughput, not a per-step extrapolation.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence


def nearest_rank(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank quantile: the ceil(q*N)-th smallest value (1-indexed).
    Unlike the floor-index `vals[int(q*(N-1))]`, this never under-reports
    the tail at small N — e.g. p90 of 10 samples is the 9th, not the 8th,
    and p99 of any N < 100 is the maximum."""
    if not sorted_vals:
        return 0.0
    i = max(0, min(len(sorted_vals) - 1,
                   math.ceil(q * len(sorted_vals)) - 1))
    return sorted_vals[i]


@dataclass
class RequestMetrics:
    arrival: float
    priority: str = "batch"            # serve/tiering class
    preempted: int = 0                 # times this request was evicted
    admitted: Optional[float] = None
    first_token: Optional[float] = None
    finished: Optional[float] = None
    n_tokens: int = 0
    prime_s: Optional[float] = None    # wall-clock prime-prefill latency —
                                       # the TTFT component arrival gaps
                                       # can't hide (shared-prefix reuse
                                       # shrinks exactly this)
    drafted: int = 0                   # speculative: draft tokens offered
    accepted: int = 0                  # speculative: draft tokens accepted
                                       # (the mandatory verify token is
                                       # free and not counted here)

    @property
    def ttft_steps(self) -> Optional[float]:
        """Decode steps between arrival and first emitted token (the prime
        prefill emits it, so admission == first token on this clock)."""
        if self.first_token is None:
            return None
        return self.first_token - self.arrival

    @property
    def accept_rate(self) -> Optional[float]:
        """Fraction of this request's draft tokens the verifier accepted
        (None when it never went through a speculative step)."""
        if self.drafted == 0:
            return None
        return self.accepted / self.drafted


class ServingMetrics:
    # monotonic cumulative counters: never reset within a serving process.
    # `ServingMetrics(carry=old)` copies them forward, and the runtime's
    # reset_metrics() uses exactly that — so a /metrics scrape (gateway)
    # never sees a counter dip even across per-run percentile resets.
    COUNTERS = ("requests_submitted_total", "requests_admitted_total",
                "requests_finished_total", "requests_cancelled_total",
                "requests_rejected_total", "tokens_emitted_total",
                # tiering (DESIGN.md §Tiering)
                "preemptions_total", "preempt_swap_total",
                "preempt_recompute_total", "resumed_total",
                "kv_pages_spilled_total", "kv_pages_filled_total",
                "kv_fills_degraded_total",
                "prefix_host_hits_total", "adapter_spills_total",
                "adapter_host_hits_total")

    def __init__(self, carry: Optional["ServingMetrics"] = None):
        self.requests: Dict[int, RequestMetrics] = {}
        self.occupancy: List[float] = []       # active/slots per decode step
        self.steps = 0
        self.wall_s = 0.0
        self._t0: Optional[float] = None
        # speculative counters (DESIGN.md §Speculation): one sample per
        # ACTIVE slot per verify step
        self.spec_slot_steps = 0
        self.accepted_hist: Dict[int, int] = {}  # emitted-per-step -> count
        for name in self.COUNTERS:
            setattr(self, name, getattr(carry, name, 0) if carry else 0)
        self.queue_depth = 0                   # gauge: pending admissions

    # ---- lifecycle hooks (called by the runtime) --------------------------
    def start(self) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is not None:
            self.wall_s += time.perf_counter() - self._t0
            self._t0 = None

    def on_arrival(self, rid: int, t: float,
                   priority: str = "batch") -> None:
        self.requests[rid] = RequestMetrics(arrival=t, priority=priority)
        self.requests_submitted_total += 1

    def on_admit(self, rid: int, t: float) -> None:
        self.requests[rid].admitted = t
        self.requests_admitted_total += 1

    def on_token(self, rid: int, t: float) -> None:
        r = self.requests[rid]
        r.n_tokens += 1
        self.tokens_emitted_total += 1
        if r.first_token is None:
            r.first_token = t

    def on_prime(self, rid: int, seconds: float) -> None:
        self.requests[rid].prime_s = seconds

    def on_finish(self, rid: int, t: float) -> None:
        self.requests[rid].finished = t
        self.requests_finished_total += 1

    def on_cancel(self, rid: int, t: float) -> None:
        """A queued or mid-stream request was aborted (client disconnect,
        timeout): stamp it finished so per-run aggregates stay consistent,
        and count it separately from natural completions."""
        r = self.requests.get(rid)
        if r is not None and r.finished is None:
            r.finished = t
        self.requests_cancelled_total += 1

    def on_reject(self) -> None:
        """An admission-side rejection (gateway backpressure 429) — counted
        without a request record: the request never entered the queue."""
        self.requests_rejected_total += 1

    # ---- tiering hooks (DESIGN.md §Tiering) -------------------------------
    def on_preempt(self, rid: int, t: float, mode: str) -> None:
        """A victim slot was evicted for a higher-class candidate; `mode`
        is how its KV leaves the device ("swap" or "recompute")."""
        r = self.requests.get(rid)
        if r is not None:
            r.preempted += 1
        self.preemptions_total += 1
        if mode == "swap":
            self.preempt_swap_total += 1
        else:
            self.preempt_recompute_total += 1

    def on_resume(self, rid: int, t: float) -> None:
        self.resumed_total += 1

    def on_kv_spill(self, n_pages: int) -> None:
        self.kv_pages_spilled_total += n_pages

    def on_kv_fill(self, n_pages: int) -> None:
        self.kv_pages_filled_total += n_pages

    def on_kv_fill_degraded(self, n_pages: int) -> None:
        """Planned host fills that aged out of the pool before the promote
        (displaced by the same plan's demotions) — recomputed on device
        instead; the stream stays exact, only the fill saving is lost."""
        self.kv_fills_degraded_total += n_pages

    def on_prefix_host_hit(self, n_pages: int) -> None:
        self.prefix_host_hits_total += n_pages

    def on_adapter_spill(self) -> None:
        self.adapter_spills_total += 1

    def on_adapter_host_hit(self) -> None:
        self.adapter_host_hits_total += 1

    def on_step(self, active: int, slots: int) -> None:
        self.steps += 1
        self.occupancy.append(active / slots)

    def on_spec(self, rid: int, drafted: int, accepted: int,
                emitted: int) -> None:
        """One slot's outcome of one verify step: `drafted` tokens offered,
        `accepted` of them kept, `emitted` tokens recorded (accepted + the
        mandatory verify token, clamped by budget/EOS)."""
        r = self.requests[rid]
        r.drafted += drafted
        r.accepted += accepted
        self.spec_slot_steps += 1
        self.accepted_hist[emitted] = self.accepted_hist.get(emitted, 0) + 1

    # ---- aggregates -------------------------------------------------------
    @property
    def total_tokens(self) -> int:
        return sum(r.n_tokens for r in self.requests.values())

    def summary(self) -> Dict[str, float]:
        ttfts = sorted(r.ttft_steps for r in self.requests.values()
                       if r.ttft_steps is not None)
        primes = sorted(r.prime_s for r in self.requests.values()
                        if r.prime_s is not None)
        occ = self.occupancy
        wall = self.wall_s if self._t0 is None \
            else self.wall_s + (time.perf_counter() - self._t0)
        out = {
            "n_requests": len(self.requests),
            "total_tokens": self.total_tokens,
            "steps": self.steps,
            "occupancy_mean": sum(occ) / len(occ) if occ else 0.0,
            "ttft_steps_mean": sum(ttfts) / len(ttfts) if ttfts else 0.0,
            "ttft_steps_p50": nearest_rank(ttfts, 0.50),
            "ttft_steps_p90": nearest_rank(ttfts, 0.90),
            "ttft_steps_p99": nearest_rank(ttfts, 0.99),
            "prime_s_mean": sum(primes) / len(primes) if primes else 0.0,
            "prime_s_p90": nearest_rank(primes, 0.90),
            "wall_s": wall,
            "tokens_per_s": self.total_tokens / wall if wall > 0 else 0.0,
            "queue_depth": float(self.queue_depth),
        }
        for name in self.COUNTERS:
            out[name] = float(getattr(self, name))
        # per-priority-class TTFT (only classes actually seen this run —
        # single-class traffic keeps the summary exactly as before)
        by_cls: Dict[str, List[float]] = {}
        for r in self.requests.values():
            if r.ttft_steps is not None:
                by_cls.setdefault(r.priority, []).append(r.ttft_steps)
        if len(by_cls) > 1:
            for cls, vals in by_cls.items():
                vals.sort()
                out[f"n_requests_{cls}"] = float(len(vals))
                out[f"ttft_steps_p50_{cls}"] = nearest_rank(vals, 0.50)
                out[f"ttft_steps_p90_{cls}"] = nearest_rank(vals, 0.90)
        if self.spec_slot_steps:
            drafted = sum(r.drafted for r in self.requests.values())
            accepted = sum(r.accepted for r in self.requests.values())
            emitted = sum(n * c for n, c in self.accepted_hist.items())
            out.update({
                "spec_slot_steps": float(self.spec_slot_steps),
                "spec_accept_rate": accepted / drafted if drafted else 0.0,
                "spec_tokens_per_step": emitted / self.spec_slot_steps,
                "spec_drafts_wasted": float(drafted - accepted),
            })
        return out
