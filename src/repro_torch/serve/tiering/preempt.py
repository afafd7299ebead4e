"""Victim selection and the eviction-mode cost model for preempt-and-resume
(a copy of the JAX package's `serve/tiering/preempt.py`).

Pure host-side policy — no torch, no scheduler state. The runtime hands in
plain numbers and applies the verdicts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.serve.tiering.config import TieringConfig


@dataclass(frozen=True)
class VictimInfo:
    """One ACTIVE slot as the victim picker sees it."""
    slot: int
    rank: int                  # priority_rank of the occupant's class
    prompt_len: int            # original prompt tokens
    emitted: int               # tokens generated so far
    used_pages: int            # pages holding written KV rows


def choose_victim(candidate_rank: int,
                  occupants: List[VictimInfo]) -> Optional[VictimInfo]:
    """The slot to evict for a blocked candidate of `candidate_rank`, or
    None when no slot is eligible. Only STRICTLY worse classes are
    eligible (equal-class preemption would let two peers thrash); among
    them, take the worst class first, then the least progress (cheapest
    stream to redo or move), then the highest slot index."""
    eligible = [o for o in occupants if o.rank > candidate_rank]
    if not eligible:
        return None
    return max(eligible, key=lambda o: (o.rank, -o.emitted, o.slot))


def choose_mode(cfg: TieringConfig, victim: VictimInfo, page_size: int,
                host_can_swap: bool) -> str:
    """"swap" or "recompute" for one eviction.

    The estimate compares token-equivalent work: recompute re-prefills
    prompt + emitted tokens at resume, swap moves used_pages * page_size
    token rows between host and device twice (spill + fill).
    `swap_cost_per_token` converts moved tokens into recomputed-token
    units. A forced "swap" still degrades to recompute when the host pool
    cannot take the snapshot — correctness never depends on host
    capacity."""
    if not host_can_swap:
        return "recompute"
    if cfg.mode != "auto":
        return cfg.mode
    cost_swap = 2.0 * victim.used_pages * page_size * cfg.swap_cost_per_token
    cost_recompute = float(victim.prompt_len + victim.emitted)
    return "swap" if cost_swap < cost_recompute else "recompute"
