"""Tiered-memory serving configuration (a copy of the JAX package's
`serve/tiering/config.py`).

Torch-free on purpose: the gateway protocol layer (serve/gateway/protocol.py)
and the request queue import `PRIORITIES` to validate the `priority` request
extension without pulling in the model stack.
"""
from __future__ import annotations

from dataclasses import dataclass

# priority classes, best first. Rank order is the scheduling order AND the
# preemption order: a candidate may only preempt victims of STRICTLY worse
# class (equal-class preemption would thrash two peers against each other).
PRIORITIES = ("interactive", "batch", "best_effort")
DEFAULT_PRIORITY = "batch"

_RANK = {p: i for i, p in enumerate(PRIORITIES)}


def priority_rank(priority: str) -> int:
    """Smaller is better; unknown classes sort worst (the queue and the
    protocol validate on entry, so this is only a guard)."""
    return _RANK.get(priority, len(PRIORITIES))


@dataclass(frozen=True)
class TieringConfig:
    """Knobs for preemption and the host-memory tiers.

    host_kv_pages:      host KV tier capacity in pages — holds demoted
                        cold prefix pages (LRU, evictable) and preemption
                        snapshots (pinned until resumed). 0 disables the
                        KV host tier: evicted prefix pages are dropped and
                        preemption always recomputes.
    host_adapter_slots: host adapter tier capacity in bank rows — evicted
                        AdapterBank tenants spill here and reload without
                        a checkpoint read. 0 disables it.
    preempt:            allow the scheduler to evict a strictly-lower-class
                        victim slot under page/bank pressure instead of
                        deferring the admission (False = deferral only).
    mode:               victim eviction policy: "swap" snapshots the
                        victim's used KV pages to host memory and restores
                        them on resume; "recompute" drops them and
                        re-prefills prompt + emitted at resume; "auto"
                        picks per victim by cost estimate (see
                        `preempt.choose_mode`).
    swap_cost_per_token: relative cost of moving one token's KV host<->
                        device (in recomputed-token units) — "auto" swaps
                        when 2 * moved_tokens * this < recomputed tokens.
                        The default, the JAX package's, says a D2H+H2D
                        round trip is about 4x cheaper per token than
                        recomputing it; PERF.md §5 holds the ratio measured
                        on the H100.
    """
    host_kv_pages: int = 0
    host_adapter_slots: int = 0
    preempt: bool = True
    mode: str = "auto"
    swap_cost_per_token: float = 0.125

    def __post_init__(self):
        if self.mode not in ("auto", "swap", "recompute"):
            raise ValueError(f"unknown preempt mode {self.mode!r}; "
                             "one of auto|swap|recompute")
        if self.host_kv_pages < 0 or self.host_adapter_slots < 0:
            raise ValueError("host tier capacities must be >= 0")
