"""Continuous-batching runtime over the slot Engine (the JAX package's
`serve/scheduler/runtime.py`, without tiering).

One persistent PAGED KV cache by default: K/V in a global pool of
fixed-size pages, each slot mapping its logical positions onto pages
through a block-table row, with page-aligned prompt prefixes reused across
requests so the prime prefill computes only the unshared tail
(copy-on-write when a prompt is exactly a cached prefix). `paged=False`
keeps a dense per-slot cache instead (max_len rows per slot; the prime
prefills a batch-1 cache and splices it into the slot with `write_slot`).
Every slot decodes at its own position and ragged kv_len; requests are
admitted into FREE slots the moment a slot (and, paged, the request's
worst-case page count) is available, and a slot is recycled — its pages
freed — the very step its request completes. In-flight prefill primes one
slot while the other slots keep decoding.

Decode feeds its own device output back as the next step's input; emitted
tokens buffer on the device and drain in one transfer when a budget
completion is due, when the EOS done-flag (copied to the host
asynchronously, read one step late) comes back set, or every
`eos_sync_every` steps.

Admission is adapter-bank-aware: a request's tenant is touched when
resident, loaded through `load_from_checkpoint` when not, with the tenants
of live slots pinned against LRU eviction (evicting one would zero a row
that a decoding slot gathers). A request whose tenant cannot be made
resident now waits, without head-of-line blocking the rest of the queue.
A slot stays live, and its tenant pinned, until its last token is drained:
a completion found late by the buffered drain is released only then, so a
slot re-primed for another tenant never gathers the old tenant's row.

Speculative decoding (`drafter=`, serve/spec.py): each step the drafter
proposes k tokens per slot, ONE `verify_step` forward scores the window
[last token, drafts] (W = k+1 query rows per slot; on the card the
paged-attention kernel at W rows), and each slot keeps the longest prefix
greedy decoding would have emitted. The window and the scores come back
in one device-to-host transfer per step; the accepted counts commit to the
cache's positions with `advance_pos`.

Outputs are exact per request: the same tokens `Engine.generate` gives run
one request at a time, on either cache. With a drafter that holds in f32
(TF32 off on the card); in bf16 on the card the verify window's matrix
products (B·W rows) round differently from decode's (B rows), and a stream
can part from the plain loop's where two logits nearly tie (PERF.md §6).

Not ported yet, and rejected by the constructor: tiering (`tiering`,
ROADMAP queue 1).
"""
from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serve.engine import BankFullError, Engine, Request
from repro_torch.serve.paging import PagedKVCache, PrefixCache, PrimePlan
from repro_torch.serve.scheduler.metrics import ServingMetrics
from repro_torch.serve.scheduler.queue import (
    PRIORITIES, RequestQueue, ScheduledRequest,
)
from repro_torch.serve.scheduler.slots import SlotManager

Event = Tuple  # ("admit", rid, slot, t) | ("token", rid, tok, t)
               # | ("done", rid, toks, t)


def _bucket(n: int, lo: int = 8) -> int:
    """Next power of two >= n (floored at `lo`)."""
    b = lo
    while b < n:
        b <<= 1
    return b


class _HostFlag:
    """A device bool vector copied to the host without blocking: the copy is
    queued behind the work that produced the flag, and `ready_any()` waits
    only for that copy, not for work queued after it."""

    def __init__(self, flag: torch.Tensor):
        if flag.device.type == "cuda":
            self._host = torch.empty(flag.shape, dtype=flag.dtype,
                                     pin_memory=True)
            self._host.copy_(flag, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(flag.device))
        else:
            self._host = flag.clone()
            self._event = None

    def ready_any(self) -> bool:
        if self._event is not None:
            self._event.synchronize()
        return bool(self._host.any())


class ContinuousScheduler:
    """Continuous-batching front end over an Engine's model and params.

    eos_id:  optional stop token — a slot completes on emitting it (the
             token is included in the output). At most `eos_sync_every`
             decode steps run past an EOS before the drain discards the
             overshoot.
    policy:  RequestQueue admission order ("fcfs" | "resident_first" |
             "fair").
    bucket:  pad prime prefills to pow2 prompt buckets.
    paged:   block-table page-pool cache with shared-prefix reuse (the
             default); False: the dense per-slot cache.
    page_size / n_pages: paged-cache geometry (n_pages defaults to the
             zero-sharing worst case plus prefix-cache headroom).
    drafter: a `serve.spec.Drafter` switches the decode loop to
             draft-then-verify speculative decoding.

    `events()` yields ("admit", rid, slot, t), ("token", rid, token, t) and
    ("done", rid, tokens, t) tuples; `serve(requests, arrivals)` replays a
    trace and returns the requests with `.out` filled; `metrics`
    accumulates TTFT / occupancy / tokens-per-s (ServingMetrics)."""

    def __init__(self, engine: Engine, eos_id: Optional[int] = None,
                 policy: str = "fcfs", bucket: bool = True,
                 paged: bool = True, page_size: int = 16,
                 n_pages: Optional[int] = None, drafter=None,
                 eos_sync_every: int = 4, tiering=None):
        if tiering is not None:
            raise NotImplementedError("tiering: comes with a later slice "
                                      "(ROADMAP queue 1)")
        self.engine = engine
        self.bank = engine.bank
        self.model = engine.model
        self.device = engine.device
        self.n_slots = engine.batch
        self.max_len = engine.max_len
        self.eos_id = eos_id
        self.bucket = bucket
        self.queue = RequestQueue(policy)
        self.pager: Optional[PagedKVCache] = None
        if paged:
            self.pager = PagedKVCache(self.n_slots, self.max_len,
                                      page_size=page_size, n_pages=n_pages,
                                      device=self.device)
        self.slots = SlotManager(self.n_slots, eos_id=eos_id,
                                 on_release=self._release_pages)
        self.metrics = ServingMetrics()
        self.t = 0.0                           # decode-step clock
        if paged:
            self.cache = engine._fresh_cache(paged=True,
                                             page_size=self.pager.page_size,
                                             n_pages=self.pager.n_pages)
            # the decode attention, resolved once (the model keeps it) for
            # its head_dim and the cache's dtype: a kernel that cannot take
            # them refuses here, before the first decode step
            self.model.paged_attention(self.device, self.cache["pk"].dtype)
        else:
            self.cache = engine._fresh_cache(per_slot=True)
        self._sr: List[Optional[ScheduledRequest]] = [None] * self.n_slots
        self._plans: Dict[int, PrimePlan] = {}
        self._prefix_keys: Dict[int, tuple] = {}   # rid -> memoized hashes
        self._last = [0] * self.n_slots        # per-slot last token (host)
        self._outs: Dict[int, List[int]] = {}
        self._stale = set()                    # freed, not yet reset slots
        # buffered decode state: device token feedback plus not-yet-drained
        # step outputs and the EOS done-flag
        self.eos_sync_every = max(1, int(eos_sync_every))
        self._pending: List[Tuple] = []        # (t, nt_dev, [(slot, sr)..])
        self._toks_dev: Optional[torch.Tensor] = None   # (B, 1) next inputs
        self._flag_dev: Optional[torch.Tensor] = None   # (B,) done-flags
        self._flag_prev: Optional[_HostFlag] = None     # last copy in flight
        self.drafter = drafter
        if drafter is not None:
            drafter.bind(self)

    # ---- submission -------------------------------------------------------
    def submit(self, request: Request, arrival: float = 0.0) -> int:
        """Queue a request; `arrival` is on the decode-step clock (traffic
        replay). Returns the request id used in events/metrics."""
        if request.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {request.max_new}")
        S = int(request.prompt.shape[0])
        if S < 1:
            raise ValueError("empty (length-0) prompt")
        # the LAST generated token is never written, so the deepest read is
        # kv_len = S + max_new - 1 (slots.py invariant)
        if S + request.max_new - 1 > self.max_len:
            raise ValueError(
                f"prompt ({S}) + max_new ({request.max_new}) needs "
                f"{S + request.max_new - 1} cache positions, exceeding the "
                f"persistent cache's max_len ({self.max_len})")
        if request.adapter_id is not None and self.bank is None:
            raise ValueError("request has an adapter_id but the engine "
                             "has no bank")
        if request.priority not in PRIORITIES:
            raise ValueError(f"unknown priority {request.priority!r}; "
                             f"one of {PRIORITIES}")
        rid = self.queue.push(request, arrival)
        self.metrics.on_arrival(rid, float(arrival),
                                priority=request.priority)
        self.metrics.queue_depth = len(self.queue)
        return rid

    # ---- admission --------------------------------------------------------
    def _ensure_resident(self, sr: ScheduledRequest) -> bool:
        """Make the request's tenant bank-resident (admission side effect).
        False defers it: the bank is full of pinned (live) tenants."""
        aid = sr.request.adapter_id
        if aid is None:
            return True
        if aid in self.bank.resident_ids:
            self.bank.touch(aid)
            return True
        pinned = [a for a in self.slots.adapter_ids() if a is not None]
        try:
            if self.bank.load_from_host(aid, pinned=pinned) is None:
                self.bank.load_from_checkpoint(aid, pinned=pinned)
        except BankFullError:
            return False
        return True

    def _try_admit(self, sr: ScheduledRequest) -> bool:
        """Admission callback for the queue: bank residency first, then the
        page plan — match the prompt against the prefix cache and allocate
        the slot's worst-case pages up front, so decode never allocates.
        False defers the request without head-of-line blocking the
        queue."""
        if not self._ensure_resident(sr):
            return False
        if self.pager is None:
            return True
        memo = self._prefix_keys.get(sr.rid)
        if memo is None:                     # hash + host-copy once;
            prompt = np.asarray(torch.as_tensor(sr.request.prompt).cpu())
            memo = (prompt, PrefixCache.chain_keys(   # deferred requests
                prompt, self.pager.page_size,         # are re-offered
                sr.request.adapter_id))               # every cycle
            self._prefix_keys[sr.rid] = memo
        prompt, keys = memo
        plan = self.pager.plan_admit(
            self.slots.free_slots()[0], prompt, sr.request.max_new,
            adapter_id=sr.request.adapter_id, keys=keys)
        if plan is None:
            return False
        self._plans[sr.rid] = plan
        self._prefix_keys.pop(sr.rid, None)
        return True

    def _release_pages(self, slot: int, snapshot) -> None:
        """SlotManager release hook: a recycled slot frees its pages the
        same scheduler step its request completes."""
        if self.pager is not None:
            self.pager.release(slot)

    def _bucketed_prompt(self, tokens: np.ndarray) -> Dict:
        """{tokens, true_len?} for a batch-1 prefill, pow2-bucketed and
        clamped to max_len; `true_len` present iff padded."""
        n = int(tokens.shape[0])
        P = min(_bucket(n), self.max_len) if self.bucket else n
        padded = np.zeros((1, P), np.int32)
        padded[0, :n] = tokens
        batch: Dict = {"tokens": torch.as_tensor(padded, device=self.device)}
        if P != n:
            batch["true_len"] = torch.full((1,), n, dtype=torch.int32,
                                           device=self.device)
        return batch

    def _prime(self, sr: ScheduledRequest, slot: int,
               prompt: np.ndarray) -> int:
        """In-flight prefill of `prompt` (the request's, on the host);
        returns the first generated token. Paged: run
        the UNSHARED TAIL of the prompt through a batch-1 paged prefill
        that writes its KV into the slot's pages; reused prefix pages enter
        the tail's attention through the block-table window, after the COW
        clone when the plan calls for one. Dense: prefill the prompt into a
        batch-1 cache and splice it into the slot's row."""
        t0 = time.perf_counter()
        params, extra = self.engine._batch_extra([sr.request.adapter_id],
                                                 batch=1)
        if self.pager is None:
            batch = self._bucketed_prompt(prompt)
            batch.update(extra)
            scratch = self.model.init_cache(
                1, int(batch["tokens"].shape[1]), self.cache["k"].dtype,
                self.device)
            nt, scratch = self.model.prefill(params, scratch, batch)
            self.cache = self.model.write_slot(self.cache, scratch, slot,
                                               int(prompt.shape[0]))
            tok = int(nt.reshape(-1)[0])
            self.metrics.on_prime(sr.rid, time.perf_counter() - t0)
            return tok
        plan = self._plans.pop(sr.rid)
        if plan.cow is not None:
            self.cache = self.model.copy_page(self.cache, *plan.cow)
        batch = self._bucketed_prompt(np.asarray(plan.tail, np.int32))
        batch.update(block_table=torch.as_tensor(plan.block_row[None],
                                                 device=self.device),
                     slot=slot, scratch_page=plan.scratch_page)
        if plan.prefix_len:
            # warm prime: the attention window gathers only the pow2 bucket
            # of the PREFIX pages, not the full pages_per_seq window
            ps = self.pager.page_size
            wp = min(_bucket(-(-plan.prefix_len // ps), lo=1),
                     self.pager.pages_per_seq)
            batch["window_table"] = torch.as_tensor(plan.block_row[None, :wp],
                                                    device=self.device)
            batch["prefix_len"] = plan.prefix_len
        batch.update(extra)
        nt, self.cache = self.model.prefill_paged(params, self.cache, batch)
        tok = int(nt.reshape(-1)[0])
        # publish the prompt's chunks for sharing only past the host sync
        # above: a failed prime must not leave prefix-cache entries pointing
        # at never-filled pages
        self.pager.register_prompt(plan)
        self.metrics.on_prime(sr.rid, time.perf_counter() - t0)
        return tok

    def _admit_ready(self) -> Iterator[Event]:
        while len(self.queue) and self.slots.free_slots():
            sr = self.queue.pop_next(self.t, self._try_admit)
            if sr is None:
                return          # every arrived request deferred on pages
            yield from self._admit_one(sr)

    def _admit_one(self, sr: ScheduledRequest) -> Iterator[Event]:
        """Acquire + prime one accepted request."""
        plan = self._plans.get(sr.rid)
        slot = self.slots.acquire(sr.rid, budget=sr.request.max_new,
                                  adapter_id=sr.request.adapter_id,
                                  prompt_len=int(sr.request.prompt.shape[0]),
                                  slot=plan.slot if plan else None)
        self._sr[slot] = sr
        self.metrics.on_admit(sr.rid, self.t)
        prompt = np.asarray(torch.as_tensor(sr.request.prompt).cpu(),
                            np.int32)
        tok = self._prime(sr, slot, prompt)
        self._outs[sr.rid] = [tok]
        self._last[slot] = tok
        if self._toks_dev is not None:
            # mid-buffer admission: in-flight slots' next tokens live only
            # on the device, so splice the new slot's first token in
            self._toks_dev[slot, 0] = tok
        if self.drafter is not None:
            self.drafter.on_prime(slot, prompt, tok)
        self.metrics.on_token(sr.rid, self.t)
        self.queue.note_usage(sr.request.adapter_id, 1)
        yield ("admit", sr.rid, slot, self.t)
        yield ("token", sr.rid, tok, self.t)
        if self.slots.note_token(slot, tok):
            yield self._finish(slot)

    def _finish(self, slot: int, t: Optional[float] = None) -> Event:
        t = self.t if t is None else t
        sr = self._sr[slot]
        self._sr[slot] = None
        self._last[slot] = 0
        self.slots.release(slot)
        self._stale.add(slot)          # reset is batched into the next step
        if self.drafter is not None:
            self.drafter.on_release(slot)
        toks = self._outs.pop(sr.rid)
        sr.request.out = toks
        self.metrics.on_finish(sr.rid, t)
        return ("done", sr.rid, toks, t)

    # ---- decode -----------------------------------------------------------
    def _flush_stale(self) -> None:
        """One batched reset for slots freed since the last step; slots that
        were already re-primed (their position was set) drop out."""
        stale = self._stale & set(self.slots.free_slots())
        self._stale.clear()
        if stale:
            mask = np.zeros((self.n_slots,), bool)
            mask[list(stale)] = True
            self.cache = self.model.reset_slots(self.cache, mask)

    def _batch_inputs(self) -> Tuple[Dict, Dict]:
        """(params, extra) for a full-batch decode or verify call: the
        bank's gather rows in slot order (the slots' occupants) and, paged,
        the block table and the slots' scratch pages."""
        params, extra = self.engine._batch_extra(self.slots.adapter_ids())
        if self.pager is not None:
            extra["block_table"] = self.pager.block_table_device()
            extra["scratch_pages"] = self.pager.scratch_pages_device()
        return params, extra

    def _min_budget_left(self) -> int:
        """Tokens until the EARLIEST budget completion among active slots,
        counted from the last drain."""
        budgets = [self.slots.state(s).budget
                   for s in self.slots.active_slots()]
        return min(budgets) if budgets else 0

    def _decode_once(self) -> Iterator[Event]:
        self._flush_stale()
        active = self.slots.active_slots()
        if self._toks_dev is None:
            self._toks_dev = self.engine.commit_tokens(
                np.asarray(self._last, np.int32)[:, None])
        params, extra = self._batch_inputs()
        nt, self.cache = self.model.decode_step(
            params, self.cache, {"tokens": self._toks_dev, **extra})
        # feed the device output straight back as the next step's input —
        # the host never sees tokens until a drain
        self._toks_dev = nt[:, None].clone()
        self.t += 1
        self.metrics.on_step(len(active), self.n_slots)
        self._pending.append((self.t, nt, [(s, self._sr[s]) for s in active]))
        sync = self._min_budget_left() <= len(self._pending)
        if self.eos_id is not None:
            if self._flag_dev is None:
                self._flag_dev = torch.zeros((self.n_slots,), dtype=torch.bool,
                                             device=self.device)
            self._flag_dev = self._flag_dev | (nt == int(self.eos_id))
            # the PREVIOUS flag copy has had a full decode dispatch to come
            # back — reading it now costs no wait on this step's work
            if self._flag_prev is not None and self._flag_prev.ready_any():
                sync = True
            self._flag_prev = _HostFlag(self._flag_dev)
            if len(self._pending) >= self.eos_sync_every:
                sync = True
        if sync:
            yield from self._drain()

    def _drain(self) -> Iterator[Event]:
        """Fetch every buffered step's tokens in ONE device transfer and
        replay them through the per-token accounting, stamped with their
        original step times. Slots that complete mid-buffer stop
        contributing from that step on (their later buffered tokens — the
        decode overshoot — are discarded)."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        self._flag_dev = None
        self._flag_prev = None
        arr = torch.stack([nt for _, nt, _ in pending]).cpu().numpy()
        for i, (t, _, occupants) in enumerate(pending):
            for slot, sr in occupants:
                if self._sr[slot] is not sr:   # finished at an earlier step
                    continue
                tok = int(arr[i, slot])
                self._outs[sr.rid].append(tok)
                self._last[slot] = tok
                self.metrics.on_token(sr.rid, t)
                self.queue.note_usage(sr.request.adapter_id, 1)
                yield ("token", sr.rid, tok, t)
                if self.slots.note_token(slot, tok):
                    yield self._finish(slot, t)

    # ---- speculative decode ------------------------------------------------
    def _spec_decode_once(self) -> Iterator[Event]:
        """One draft-then-verify step: the drafter proposes k tokens per
        slot, ONE `verify_step` forward scores the (n_slots, k+1) window,
        and each active slot accepts the longest prefix greedy decoding
        would have emitted — token j is kept iff draft j matched the
        model's own output after token j-1, with EOS and budget clamping
        anywhere inside the window. The accepted counts commit to the
        device `pos` with `advance_pos` (0 for free slots); rejected rows
        stay past kv_len until a later window overwrites them."""
        self._flush_stale()
        active = self.slots.active_slots()
        params, extra = self._batch_inputs()
        k = self.drafter.k
        # the window is assembled on the device whether the drafts come
        # from the device (SelfDrafter) or the host (NGramDrafter)
        drafts = torch.as_tensor(self.drafter.propose(), dtype=torch.int32,
                                 device=self.device)
        last = self.engine.commit_tokens(np.asarray(self._last, np.int32))
        win_dev = torch.cat([last[:, None], drafts], dim=1)
        out, self.cache = self.model.verify_step(
            params, self.cache, {"tokens": win_dev, **extra})
        self.t += 1
        self.metrics.on_step(len(active), self.n_slots)
        # the step's one device-to-host transfer: the window and its scores
        wa = torch.cat([win_dev, out], dim=1).cpu().numpy()
        win, arr = wa[:, :k + 1], wa[:, k + 1:]
        deltas = np.zeros((self.n_slots,), np.int32)
        for slot in active:
            sr = self._sr[slot]
            # token 0 is the mandatory next token; token j is valid iff
            # draft j matched the model's own continuation after token j-1
            accepted = [int(arr[slot, 0])]
            for j in range(1, k + 1):
                if win[slot, j] != arr[slot, j - 1]:
                    break
                accepted.append(int(arr[slot, j]))
            n_emit, done = self.slots.note_window(slot, accepted)
            emitted = accepted[:n_emit]         # budget / EOS clamp
            for tok in emitted:
                self._outs[sr.rid].append(tok)
                self._last[slot] = tok
                self.metrics.on_token(sr.rid, self.t)
                self.queue.note_usage(sr.request.adapter_id, 1)
                yield ("token", sr.rid, tok, self.t)
            deltas[slot] = n_emit
            self.drafter.on_tokens(slot, emitted)
            self.metrics.on_spec(sr.rid, drafted=k, accepted=n_emit - 1,
                                 emitted=n_emit)
            if done:
                yield self._finish(slot)
        self.cache = self.model.advance_pos(self.cache, deltas)

    def resource_gauges(self) -> Dict[str, float]:
        """Occupancy gauges: bank residency and, paged, prefix-cache and
        page-pool fill."""
        out: Dict[str, float] = {}
        if self.bank is not None:
            out["bank_resident_adapters"] = float(len(self.bank.resident_ids))
        if self.pager is not None:
            out["prefix_cache_pages"] = float(len(self.pager.prefix_cache))
            out["kv_pages_free"] = float(self.pager.allocator.free_count())
        return out

    # ---- main loop --------------------------------------------------------
    @torch.no_grad()
    def tick(self) -> List[Event]:
        """ONE scheduler round — admit every admissible arrived request,
        then (if anything is decoding) one decode or verify step —
        returning the round's events. Returns [] when there is nothing to
        do right now (the round idle-skips the clock to the next arrival).
        Every prefill, decode and verify runs here, without autograd."""
        evs: List[Event] = list(self._admit_ready())
        if self.slots.any_active():
            if self.drafter is not None:
                evs.extend(self._spec_decode_once())
            else:
                evs.extend(self._decode_once())
        else:
            nxt = self.queue.next_arrival()
            if nxt is not None and nxt > self.t:
                self.t = nxt           # idle: skip to the next arrival
        self.metrics.queue_depth = len(self.queue)
        return evs

    def events(self) -> Iterator[Event]:
        """Drain the queue: admit -> decode -> recycle until no request is
        pending or in flight, yielding the event stream."""
        self.metrics.start()
        try:
            while len(self.queue) or self.slots.any_active():
                t_before = self.t
                evs = self.tick()
                yield from evs
                if not evs and not self.slots.any_active() \
                        and self.t == t_before and len(self.queue):
                    raise RuntimeError(
                        "scheduler stalled: arrived requests cannot be "
                        "admitted although every slot is free")
        finally:
            self.metrics.stop()

    def serve(self, requests: Sequence[Request],
              arrivals: Optional[Sequence[float]] = None) -> List[Request]:
        """Traffic replay: submit every request (arrivals on the decode-step
        clock, default all-at-0) and drain. Returns the requests with `.out`
        filled, in input order."""
        if arrivals is not None and len(arrivals) != len(requests):
            raise ValueError(f"{len(arrivals)} arrivals for "
                             f"{len(requests)} requests")
        for i, r in enumerate(requests):
            self.submit(r, arrivals[i] if arrivals is not None else 0.0)
        for _ in self.events():
            pass
        return list(requests)
