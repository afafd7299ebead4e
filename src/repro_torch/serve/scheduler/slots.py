"""Slot lifecycle for the serving runtimes (a copy of the JAX package's
`serve/scheduler/slots.py`; it is plain Python).

State machine (per slot of the fixed-shape batch):

    FREE --acquire--> ACTIVE --note_token x N--> (budget 0 | EOS) --release--> FREE

`SlotManager` owns the invariants both runtimes rely on:

- **no double assignment** — acquire only ever hands out a FREE slot and
  refuses a rid that is already active (RuntimeError, not silent reuse);
- **exact budgets** — a request records precisely min(max_new, tokens
  through EOS) tokens: note_token decrements the budget and reports
  completion the step it hits zero or emits `eos_id`;
- **recycling is immediate** — release returns the slot to FREE the same
  scheduler step its request completes, and the `on_release` hook fires
  inside that transition: the paged runtime frees the slot's KV pages
  there, so page lifetime is exactly slot lifetime (DESIGN.md §Paging).

The lockstep engine (Engine.generate_requests) and the continuous runtime
(scheduler.runtime) both complete requests through note_token/release, so
"stop contributing once budget or EOS is hit" is one shared code path.

Capacity invariant the runtimes' admission guards derive from: the final
cache position a request WRITES is `prompt_len + taken - 2` and the
deepest it READS is `prompt_len + taken - 1` (the last generated token is
never written) — so a request fits a max_len cache iff
`prompt_len + max_new - 1 <= max_len`, one token more than the historical
`prompt_len + max_new <= max_len` guard admitted.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, List, Optional

FREE = "FREE"
ACTIVE = "ACTIVE"


@dataclass
class SlotState:
    state: str = FREE
    rid: Optional[int] = None          # request id of the occupant
    adapter_id: Optional[str] = None   # bank tenant the occupant gathers
    budget: int = 0                    # tokens still owed (> 0 iff ACTIVE)
    taken: int = 0                     # tokens recorded for the occupant
    prompt_len: int = 0                # cache row position = prompt_len +
                                       # taken - 1 (last token never written);
                                       # the device cache's pos vector is the
                                       # source of truth


class SlotManager:
    """Tracks per-slot occupancy/budget for a fixed pool of decode slots.

    on_release: optional hook `f(slot, snapshot)` fired as a slot recycles
    (ACTIVE -> FREE) — the paged runtime frees the slot's KV pages here."""

    def __init__(self, n_slots: int, eos_id: Optional[int] = None,
                 on_release: Optional[Callable] = None):
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        self.eos_id = eos_id
        self.on_release = on_release
        self._slots = [SlotState() for _ in range(n_slots)]

    def __len__(self) -> int:
        return len(self._slots)

    def state(self, slot: int) -> SlotState:
        return self._slots[slot]

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s.state == FREE]

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s.state == ACTIVE]

    def any_active(self) -> bool:
        return any(s.state == ACTIVE for s in self._slots)

    def occupancy(self) -> float:
        return len(self.active_slots()) / len(self._slots)

    def adapter_ids(self) -> List[Optional[str]]:
        """Per-slot tenant ids (None for FREE slots / bank-less requests) —
        exactly the `adapter_slots` gather order of the decode batch, and
        the pin set protecting live tenants from LRU eviction."""
        return [s.adapter_id if s.state == ACTIVE else None
                for s in self._slots]

    def acquire(self, rid: int, budget: int,
                adapter_id: Optional[str] = None,
                prompt_len: int = 0, slot: Optional[int] = None) -> int:
        """Assign the lowest FREE slot to request `rid` — or the explicit
        `slot` (the paged runtime plans page tables against a specific slot
        before acquiring; passing it here makes the pairing a contract
        instead of an ordering assumption). Raises RuntimeError when no
        slot is free, the requested slot isn't, or `rid` is already
        assigned (a double assignment would interleave two requests'
        tokens in one KV row)."""
        if budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        if any(s.state == ACTIVE and s.rid == rid for s in self._slots):
            raise RuntimeError(f"request {rid} is already assigned a slot")
        if slot is not None:
            if self._slots[slot].state != FREE:
                raise RuntimeError(f"requested slot {slot} is not FREE")
        else:
            free = self.free_slots()
            if not free:
                raise RuntimeError("no free slot")
            slot = free[0]
        self._slots[slot] = SlotState(state=ACTIVE, rid=rid,
                                      adapter_id=adapter_id, budget=budget,
                                      taken=0, prompt_len=prompt_len)
        return slot

    def note_token(self, slot: int, token: Optional[int] = None) -> bool:
        """Record one generated token for `slot`; True when the request is
        done (budget exhausted, or `token` == eos_id — the EOS token itself
        is included in the output). `token` may be None only when the
        manager has no eos_id (budget-only completion needs no values)."""
        s = self._slots[slot]
        if s.state != ACTIVE:
            raise RuntimeError(f"note_token on {s.state} slot {slot}")
        if self.eos_id is not None and token is None:
            raise RuntimeError("eos_id is set: note_token needs the token")
        s.taken += 1
        s.budget -= 1
        return s.budget <= 0 or (self.eos_id is not None
                                 and token == self.eos_id)

    def note_window(self, slot: int, tokens: List[int]) -> tuple:
        """Record an ACCEPTED speculative window for `slot` (DESIGN.md
        §Speculation): consume `tokens` in order, stopping the moment the
        budget hits zero or a token is `eos_id` — the same per-token rule
        `note_token` applies, so a verify step emitting [t1..tn] is
        accounted exactly like n sequential decode steps. Returns
        (n_emitted, done): the runtime must emit only the first n_emitted
        tokens (the rest are clamped overshoot) and release the slot when
        done."""
        if not tokens:
            raise ValueError("note_window needs at least one token")
        for n, tok in enumerate(tokens, start=1):
            if self.note_token(slot, tok):
                return n, True
        return len(tokens), False

    def release(self, slot: int) -> SlotState:
        """Recycle `slot` (ACTIVE -> FREE); returns the occupant's final
        state snapshot. Fires `on_release` after the transition."""
        s = self._slots[slot]
        if s.state != ACTIVE:
            raise RuntimeError(f"release of {s.state} slot {slot}")
        snapshot = dataclasses.replace(s)
        self._slots[slot] = SlotState()
        if self.on_release is not None:
            self.on_release(slot, snapshot)
        return snapshot
