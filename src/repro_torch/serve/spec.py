"""Drafters for speculative decoding on the continuous scheduler (the JAX
package's `serve/spec.py`).

A drafter proposes `k` tokens per slot per scheduler step; the scheduler
scores all of them, plus the mandatory next token, in ONE batched
`verify_step` forward (W = k+1 query rows per slot) and accepts the longest
prefix greedy decoding would have produced, so a step emits between 1 and
k+1 tokens per slot. In f32 (TF32 off on the card) the output is
token-identical to the plain loop; in bf16 on the card the verify
forward's products round differently from decode's, and a stream can part
from the plain loop's where two logits nearly tie.

`SelfDrafter` — the adapter-free base model drafts for itself. The adapter
    bank reserves a zero row that every gather can hit, and the adapters'
    deltas are added to the frozen base, so the zero row IS the base model:
    drafting runs k ordinary decode steps with every slot's gather forced
    to the zero row (without a bank, with the served params). The probes
    write base-model K/V at pos..pos+k-1 and advance `pos` by k; `propose`
    rolls `pos` back (`advance_pos(-k)`), and the verify forward overwrites
    every probed row before anything reads it. The proposal stays on the
    device: each probe's output is the next probe's input.

`NGramDrafter` — prompt-lookup drafting on the host: each slot keeps its
    token history (prompt + generated) and proposes the continuation of
    the most recent PRIOR occurrence of its trailing n-gram. No device work
    per proposal; it pays when outputs quote their inputs.
"""
from __future__ import annotations

import weakref
from typing import Dict, List

import numpy as np
import torch


class Drafter:
    """Protocol and no-op history hooks. A drafter is bound to ONE
    scheduler (`bind`), proposes an (n_slots, k) int32 token block per step
    (`propose`: a device tensor or a host array; rows of free slots are
    ignored), and sees the slot lifecycle through `on_prime`, `on_tokens`
    and `on_release`. The scheduler owns its drafter, so the drafter holds
    only a weak proxy of it: a dropped scheduler frees its cache without
    waiting for the cyclic garbage collector."""

    k: int = 4

    def bind(self, sched) -> None:
        self._sched = None if sched is None else weakref.proxy(sched)

    def propose(self):
        raise NotImplementedError

    def on_prime(self, slot: int, prompt: np.ndarray,
                 first_token: int) -> None:
        pass

    def on_tokens(self, slot: int, tokens: List[int]) -> None:
        pass

    def on_release(self, slot: int) -> None:
        pass


class SelfDrafter(Drafter):
    """Base-row self-drafting: k greedy decode steps with every adapter
    gather pointed at the bank's zero row (the frozen base model). The
    proposal is a device tensor; no token is read back to the host, so the
    scheduler's verify read is the step's only transfer."""

    def __init__(self, k: int = 4):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = k

    def bind(self, sched) -> None:
        super().bind(sched)
        self._zero_slots = None

    def propose(self) -> torch.Tensor:
        s = self._sched
        params, extra = s.engine.params, {}
        if s.pager is not None:
            extra["block_table"] = s.pager.block_table_device()
            extra["scratch_pages"] = s.pager.scratch_pages_device()
        if s.bank is not None:
            if self._zero_slots is None:      # all-None ids -> zero rows
                self._zero_slots = s.bank.slot_rows([None] * s.n_slots,
                                                    s.n_slots)
            extra["adapter_slots"] = self._zero_slots
            params = {**params, "bank": s.bank.params}
        cache = s.cache
        toks = s.engine.commit_tokens(np.asarray(s._last, np.int32)[:, None])
        outs = []
        for _ in range(self.k):
            nt, cache = s.dispatch("decode", s.model.decode_step,
                                  {"tokens": toks, **extra},
                                  state=(params, cache))
            outs.append(nt)
            toks = nt[:, None]
        # roll the probes back: pos is the only state that must not move
        # (the probe rows sit past kv_len until verify rewrites them)
        s.cache = s.dispatch("advance", s.model.advance_pos, -self.k,
                             state=(cache,))
        return torch.stack(outs, dim=1)


class NGramDrafter(Drafter):
    """Prompt-lookup drafting: propose the continuation of the most recent
    PRIOR occurrence of the trailing n-gram of each slot's history, trying
    suffix lengths `ngram` down to 1, repeating the last token when the
    match runs short or none exists (a proposal's quality moves the
    acceptance, never the output)."""

    def __init__(self, k: int = 4, ngram: int = 3, max_history: int = 4096):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {ngram}")
        self.k = k
        self.ngram = ngram
        self.max_history = max_history

    def bind(self, sched) -> None:
        super().bind(sched)
        self._hist: Dict[int, List[int]] = {}

    def on_prime(self, slot: int, prompt: np.ndarray,
                 first_token: int) -> None:
        self._hist[slot] = [int(t) for t in prompt] + [int(first_token)]

    def on_tokens(self, slot: int, tokens: List[int]) -> None:
        h = self._hist.get(slot)
        if h is not None:
            h.extend(tokens)
            if len(h) > self.max_history:
                del h[:len(h) - self.max_history]

    def on_release(self, slot: int) -> None:
        self._hist.pop(slot, None)

    def _lookup(self, h: List[int]) -> List[int]:
        for n in range(min(self.ngram, len(h) - 1), 0, -1):
            pat = h[-n:]
            # the most recent PRIOR occurrence: its continuation must start
            # before the suffix itself (i + n < len(h))
            for i in range(len(h) - n - 1, -1, -1):
                if h[i:i + n] == pat:
                    cont = h[i + n:i + n + self.k]
                    return cont + [cont[-1]] * (self.k - len(cont))
        return [h[-1]] * self.k

    def propose(self) -> np.ndarray:
        out = np.zeros((self._sched.n_slots, self.k), np.int32)
        for slot, h in self._hist.items():
            out[slot] = self._lookup(h)
        return out
