"""Arrival queue + admission policy for the continuous scheduler (a copy of
the JAX package's `serve/scheduler/queue.py`)
(DESIGN.md §Scheduler, §Tiering).

Requests enter with an `arrival` stamp on the scheduler's decode-step clock
(a traffic replay: arrival 7.0 means the request becomes visible once 7
decode steps have run). Admission walks the ARRIVED requests in policy
order and offers each to an `admit` callback — the runtime's callback does
the bank work (touch resident / load_from_checkpoint with the live pin
set) and turns a request down only when its tenant cannot be made resident
right now (BankFullError), in which case the next arrived request gets the
free slot instead of head-of-line blocking it.

Priority classes (serve/tiering): every policy orders the arrived slice by
priority class FIRST (interactive before batch before best_effort), then
applies its own order within each class. Single-class traffic — including
everything submitted before tiering existed, which defaults to "batch" —
therefore sees exactly the pre-tiering order under every policy.
"""
from __future__ import annotations

import bisect
import itertools
from dataclasses import dataclass
from typing import Any, Callable, Collection, Dict, List, Optional

from repro_torch.serve.engine import Request
from repro_torch.serve.tiering.config import priority_rank


@dataclass(eq=False)               # identity equality: Request holds
class ScheduledRequest:            # arrays, and list.remove must match the
    """A queued request plus its scheduling identity/stamps."""
    request: Request
    rid: int
    arrival: float = 0.0
    resume: Optional[Any] = None   # tiering: a preempted request carries
                                   # its ResumeState back through the queue


class RequestQueue:
    """Arrival-ordered queue with a pluggable admission policy.

    policy:
      "fcfs"           arrived requests are offered strictly in arrival
                       order (ties by submission order);
      "resident_first" among arrived requests, those whose tenant is
                       already bank-resident go first (avoids checkpoint
                       loads and LRU churn under tenant-heavy traffic);
                       falls back to fcfs order within each class.
      "fair"           per-tenant fair share: within a priority class, the
                       tenant that has consumed the fewest RECENT tokens
                       (fed by `note_usage` from the runtime's emission
                       path, decayed by periodic halving) goes first, so a
                       chatty tenant cannot starve quiet ones — but a
                       historically chatty tenant is not deprioritized
                       forever; falls back to fcfs within a tenant.
    """

    POLICIES = ("fcfs", "resident_first", "fair")

    def __init__(self, policy: str = "fcfs"):
        if policy not in self.POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"one of {self.POLICIES}")
        self.policy = policy
        self._pending: List[ScheduledRequest] = []   # arrival-sorted, stable
        self._rids = itertools.count()
        self._usage: Dict[Optional[str], int] = {}   # tenant -> tokens

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def pending(self) -> List[ScheduledRequest]:
        return list(self._pending)

    def push(self, request: Request, arrival: float = 0.0) -> int:
        rid = next(self._rids)
        sr = ScheduledRequest(request, rid, float(arrival))
        # rids are monotone, so (arrival, rid) keeps insertion stable
        bisect.insort(self._pending, sr,
                      key=lambda s: (s.arrival, s.rid))
        return rid

    def requeue(self, sr: ScheduledRequest) -> None:
        """Put a preempted request back, KEEPING its rid and arrival — the
        rid is the stream identity the gateway holds a handle on, and the
        original arrival keeps the victim ahead of later same-class
        arrivals once pressure clears (preemption must not also push it to
        the back of the line)."""
        bisect.insort(self._pending, sr,
                      key=lambda s: (s.arrival, s.rid))

    # fair-policy decay: once any tenant's counter reaches this, every
    # counter halves and zeroed tenants drop out — fairness tracks recent
    # consumption (exponential decay) and the dict stays bounded by the
    # recently-active tenant set instead of growing per distinct tenant
    # for the queue's lifetime
    USAGE_HALF_AT = 1 << 14

    def note_usage(self, tenant: Optional[str], n_tokens: int) -> None:
        """Fair-share accounting: `tenant` consumed `n_tokens` more decode
        tokens (the runtime calls this on emission; None = base model).
        Tracked only under the "fair" policy — no other policy reads it."""
        if self.policy != "fair":
            return
        total = self._usage.get(tenant, 0) + n_tokens
        self._usage[tenant] = total
        if total >= self.USAGE_HALF_AT:
            self._usage = {t: n >> 1 for t, n in self._usage.items()
                           if n >> 1}

    def usage(self, tenant: Optional[str]) -> int:
        return self._usage.get(tenant, 0)

    def arrived(self, now: float) -> List[ScheduledRequest]:
        """Arrived prefix of the pending list. `_pending` is sorted by
        (arrival, rid), so the arrived set is exactly the slice before the
        first `arrival > now` — found by bisection instead of the previous
        full linear scan per admission cycle."""
        cut = bisect.bisect_right(self._pending, now,
                                  key=lambda sr: sr.arrival)
        return self._pending[:cut]

    def next_arrival(self) -> Optional[float]:
        """Earliest pending arrival stamp (the idle-skip target), or None."""
        return self._pending[0].arrival if self._pending else None

    def remove(self, rid: int) -> Optional[ScheduledRequest]:
        """Withdraw a pending (not yet admitted) request by id — the
        cancellation path for queued requests (runtime.cancel). Returns the
        removed entry, or None when `rid` is not pending (already admitted,
        finished, or unknown)."""
        for i, sr in enumerate(self._pending):
            if sr.rid == rid:
                return self._pending.pop(i)
        return None

    def _ordered(self, now: float,
                 resident: Collection[str]) -> List[ScheduledRequest]:
        """Arrived slice in policy order: priority class first, then the
        policy's tiebreak within each class. Only the ARRIVED slice is
        (stably) re-ranked — the pending tail keeps its arrival order."""
        order = self.arrived(now)
        if self.policy == "resident_first":
            resident = set(resident)
            key = lambda sr: (priority_rank(sr.request.priority),
                              sr.request.adapter_id is not None
                              and sr.request.adapter_id not in resident)
        elif self.policy == "fair":
            key = lambda sr: (priority_rank(sr.request.priority),
                              self._usage.get(sr.request.adapter_id, 0))
        else:
            key = lambda sr: priority_rank(sr.request.priority)
        return sorted(order, key=key)   # stable: fcfs within ties

    def peek_next(self, now: float,
                  resident: Collection[str] = ()
                  ) -> Optional[ScheduledRequest]:
        """First arrived request in policy order WITHOUT offering or
        removing it — the preemption path asks who is blocked before
        deciding whether (and whom) to evict for them."""
        order = self._ordered(now, resident)
        return order[0] if order else None

    def pop_next(self, now: float,
                 admit: Callable[[ScheduledRequest], bool],
                 resident: Collection[str] = ()) -> Optional[ScheduledRequest]:
        """Offer arrived requests to `admit` in policy order; remove and
        return the first accepted one (None when nothing arrived or every
        arrived request was turned down this cycle)."""
        for sr in self._ordered(now, resident):
            if admit(sr):
                self._pending.remove(sr)
                return sr
        return None
