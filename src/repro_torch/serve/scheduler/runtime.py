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

Tiering (`tiering=`, serve/tiering): priority classes, preempt-and-resume
under page or bank pressure, and host-memory tiers for KV pages and
adapter-bank rows. A blocked higher-class request evicts a strictly
lower-class slot: the victim's written pages leave by a snapshot to pinned
host memory ("swap": a gather into a fresh device tensor, copied to the
host on a side stream, restored into freshly allocated pages with one
`index_copy_` at resume) or are dropped for a re-prefill of prompt +
emitted at resume ("recompute"). Cold prefix pages evicted from the prefix
cache demote to the host tier and come back for a prompt that shares them;
an evicted bank tenant spills its rows there and reloads without a
checkpoint read. `cancel(rid)` aborts a request wherever it is (the
gateway's disconnect path).

Outputs are exact per request: the same tokens `Engine.generate` gives run
one request at a time, on either cache, preempted and resumed or not. With
a drafter, and across a recompute-resume (whose prefill computes rows that
decode steps wrote before), that holds in f32 (TF32 off on the card); in
bf16 on the card matrix products over different row counts round
differently, and a stream can part from the plain loop's where two logits
nearly tie (PERF.md §6).

The hooks the scheduler hands to objects it owns (the slot manager's
`on_release`, the prefix cache's `on_evict`, the adapter tier's
`on_spill`, the drafter's back-reference) hold it weakly, so a dropped
scheduler frees its page pool at once, without the cyclic garbage
collector.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.devices import to_device
from repro_torch.serve.engine import BankFullError, Engine, Request
from repro_torch.serve.paging import PagedKVCache, PrefixCache, PrimePlan
from repro_torch.serve.scheduler.metrics import ServingMetrics
from repro_torch.serve.scheduler.queue import RequestQueue, ScheduledRequest
from repro_torch.serve.scheduler.slots import SlotManager
from repro_torch.serve.tiering import (
    PRIORITIES, HostAdapterTier, HostPagePool, TieringConfig, VictimInfo,
    choose_mode, choose_victim, priority_rank,
)
from repro_torch.serve.tiering.host_pool import HostCopy

Event = Tuple  # ("admit", rid, slot, t) | ("token", rid, tok, t)
               # | ("done", rid, toks, t) | ("preempt", rid, slot, t)
               # | ("resume", rid, slot, t)


@dataclass
class ResumeState:
    """How a preempted request comes back (ScheduledRequest.resume):
    "swap" restores the host snapshot of its KV pages; "recompute"
    re-prefills prompt + everything already emitted."""
    mode: str


def _bucket(n: int, lo: int = 8) -> int:
    """Next power of two >= n (floored at `lo`)."""
    b = lo
    while b < n:
        b <<= 1
    return b


def _signature(x):
    """The shape/dtype signature of what a dispatch point hands the model
    (tensors and arrays by shape and dtype, Python scalars by type, dicts
    by their keys): the port's counterpart of a jit cache key."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return x.shape, x.dtype
    if isinstance(x, dict):
        return tuple(sorted((k, _signature(v)) for k, v in x.items()))
    if isinstance(x, (tuple, list)):
        return tuple(_signature(v) for v in x)
    return type(x)


def _weak_method(method):
    """A callable that forwards to bound `method` without keeping its
    object alive (a no-op once the object is gone)."""
    ref = weakref.WeakMethod(method)

    def call(*args):
        fn = ref()
        if fn is not None:
            return fn(*args)
    return call


class _HostFlag:
    """A device bool vector copied to the host without blocking: the copy is
    queued behind the work that produced the flag, and `ready_any()` waits
    only for that copy, not for work queued after it."""

    def __init__(self, flag: torch.Tensor):
        stream = (torch.cuda.current_stream(flag.device)
                  if flag.device.type == "cuda" else None)
        self._copy = HostCopy([flag], stream)

    def ready_any(self) -> bool:
        return bool(self._copy.wait()[0].any())


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
    tiering: a `serve.tiering.TieringConfig` — priority classes,
             preempt-and-resume under page or bank pressure, and host
             tiers for KV pages and bank rows. Preemption and the KV tier
             need the paged cache; the adapter tier works either way.

    `events()` yields ("admit", rid, slot, t), ("token", rid, token, t),
    ("done", rid, tokens, t), ("preempt", rid, slot, t) and ("resume",
    rid, slot, t) tuples; `serve(requests, arrivals)` replays a trace and
    returns the requests with `.out` filled; `metrics` accumulates TTFT /
    occupancy / tokens-per-s (ServingMetrics)."""

    def __init__(self, engine: Engine, eos_id: Optional[int] = None,
                 policy: str = "fcfs", bucket: bool = True,
                 paged: bool = True, page_size: int = 16,
                 n_pages: Optional[int] = None, drafter=None,
                 eos_sync_every: int = 4,
                 tiering: Optional[TieringConfig] = None):
        if not engine.model.supports_slot_cache:
            raise NotImplementedError(
                f"{engine.model.cfg.name}: continuous batching needs the "
                "per-slot cache path (token-input transformer families)")
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
                                 on_release=_weak_method(self._release_pages))
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
        # the distinct signatures each dispatch point has handed the model
        # (compiled_signatures)
        self._sigs: Dict[str, set] = {}
        self.drafter = drafter
        if drafter is not None:
            drafter.bind(self)
        # tiering: host pools and the page-pool moves. The copies to the
        # host run on one side stream, resolved here once (on the CPU the
        # tiers keep the gathered tensors themselves)
        self.tiering = tiering
        self.host_kv: Optional[HostPagePool] = None
        self.host_adapters: Optional[HostAdapterTier] = None
        self._no_admit: set = set()        # preempted this admission round
        copy_stream = (torch.cuda.Stream(self.device)
                       if tiering is not None and self.device.type == "cuda"
                       else None)
        if tiering is not None and self.pager is not None \
                and tiering.host_kv_pages > 0:
            self.host_kv = HostPagePool(tiering.host_kv_pages,
                                        stream=copy_stream)
            # touch (not just probe): planned fill keys become MRU so the
            # same plan's demotions displace older entries first
            self.pager.host_has = self.host_kv.touch_prefix
            self.pager.prefix_cache.on_evict = _weak_method(
                self._demote_prefix_page)
        if tiering is not None and tiering.host_adapter_slots > 0 \
                and self.bank is not None:
            self.host_adapters = HostAdapterTier(
                tiering.host_adapter_slots,
                on_spill=_weak_method(self._on_adapter_spill),
                stream=copy_stream)
            self.bank.host_tier = self.host_adapters

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

    def reset_metrics(self) -> None:
        """Fresh per-run metrics AND a rewound decode-step clock for a new
        trace replay. Only meaningful between drains. The monotonic
        cumulative counters (ServingMetrics.COUNTERS) carry over: a
        /metrics scrape must never see them dip."""
        if self.slots.any_active() or len(self.queue):
            raise RuntimeError("reset_metrics with requests in flight")
        self.metrics = ServingMetrics(carry=self.metrics)
        self.t = 0.0

    # ---- admission --------------------------------------------------------
    def _ensure_resident(self, sr: ScheduledRequest) -> bool:
        """Make the request's tenant bank-resident (admission side effect):
        from the host tier when it holds the tenant, else from its
        checkpoint. False defers it: the bank is full of pinned (live)
        tenants."""
        aid = sr.request.adapter_id
        if aid is None:
            return True
        if aid in self.bank.resident_ids:
            self.bank.touch(aid)
            return True
        pinned = [a for a in self.slots.adapter_ids() if a is not None]
        try:
            if self.bank.load_from_host(aid, pinned=pinned) is not None:
                self.metrics.on_adapter_host_hit()
                return True
            self.bank.load_from_checkpoint(aid, pinned=pinned)
        except BankFullError:
            return False
        return True

    def _on_adapter_spill(self) -> None:
        """HostAdapterTier on_spill hook; reads self.metrics at call time,
        so the counter survives reset_metrics() swapping the object."""
        self.metrics.on_adapter_spill()

    def _effective(self, sr: ScheduledRequest) -> Tuple[np.ndarray, int]:
        """(prompt on the host, max_new) as the admission path sees them. A
        resumed request re-enters with prompt + everything already emitted
        as its effective prompt and only its remaining budget left — the
        page totals and slot invariants of an unpreempted run at the same
        point."""
        # repro: allow(host-sync) — prompts arrive on the host (a no-op)
        prompt = np.asarray(torch.as_tensor(sr.request.prompt).cpu(),
                            np.int32)
        if sr.resume is None:
            return prompt, sr.request.max_new
        done = self._outs[sr.rid]
        return (np.concatenate([prompt, np.asarray(done, np.int32)]),
                sr.request.max_new - len(done))

    def _try_admit(self, sr: ScheduledRequest) -> bool:
        """Admission callback for the queue: bank residency first, then the
        page plan — match the prompt against the prefix cache and allocate
        the slot's worst-case pages up front, so decode never allocates.
        False defers the request without head-of-line blocking the queue.

        Resumes ride the same path: a swap-resume allocates all its pages
        privately (`plan_resume` — the snapshot holds the exact KV); a
        recompute-resume plans its EFFECTIVE prompt through the ordinary
        prefix-matching admission, so it may share cached prefix pages."""
        if sr.rid in self._no_admit:
            return False       # just preempted: re-admitting it this round
                               # would thrash it against its preemptor
        if not self._ensure_resident(sr):
            return False
        if self.pager is None:
            return True
        if sr.resume is not None and sr.resume.mode == "swap":
            prompt, max_new = self._effective(sr)
            total = -(-(int(prompt.shape[0]) + max_new - 1)
                      // self.pager.page_size)
            plan = self.pager.plan_resume(self.slots.free_slots()[0], total)
            if plan is None:
                return False
            self._plans[sr.rid] = plan
            return True
        memo = self._prefix_keys.get(sr.rid)
        if memo is None:                     # hash + host-copy once;
            prompt, max_new = self._effective(sr)     # deferred requests
            memo = (prompt, max_new, PrefixCache.chain_keys(  # are re-
                prompt, self.pager.page_size,         # offered every cycle
                sr.request.adapter_id))
            self._prefix_keys[sr.rid] = memo
        prompt, max_new, keys = memo
        plan = self.pager.plan_admit(
            self.slots.free_slots()[0], prompt, max_new,
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
        batch: Dict = {"tokens": to_device(padded, self.device)}
        if P != n:
            batch["true_len"] = torch.full((1,), n, dtype=torch.int32,
                                           device=self.device)
        return batch

    # ---- page moves (tiering) ---------------------------------------------
    def _spill_pages(self, idx: np.ndarray
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gather pages `idx` of both pools into fresh device tensors
        (advanced indexing copies): queued on the compute stream BEFORE the
        pages can be freed, so the gather reads their old contents even if
        a later prime reuses them."""
        self._note("spill_pages", idx)
        i = to_device(idx, self.device, torch.int64)
        return (self.cache["pk"].index_select(1, i),
                self.cache["pv"].index_select(1, i))

    def _fill_pages(self, k: torch.Tensor, v: torch.Tensor,
                    idx: np.ndarray) -> None:
        """Copy host pages k/v (L, P, page, K, hd) into pool pages `idx`.
        The host-to-device copy is queued on the compute stream (from
        pinned memory, without blocking the host), so it lands before the
        prime or decode that reads those pages."""
        self._note("fill_pages", k, v, idx)
        i = to_device(idx, self.device, torch.int64)
        for key, h in (("pk", k), ("pv", v)):
            pool = self.cache[key]
            pool.index_copy_(1, i, h.to(pool.device, non_blocking=True))

    def _host_buffer(self, shape, dtype) -> torch.Tensor:
        """A zeroed host staging tensor, pinned when the cache is on the
        card (the host allocator then keeps it until its copy lands)."""
        return torch.zeros(shape, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    def _promote_fills(self, plan: PrimePlan, prompt: np.ndarray) -> None:
        """Copy the plan's host-matched chunks back into their owned device
        pages before the prime (one batched host-to-device copy and one
        `index_copy_`; padded rows land in the slot's scratch page). The
        entries stay host-resident — the LRU ages them out.

        A fill can vanish between plan and promote: `plan_admit`'s own
        eviction demotes device prefix pages into the host pool, and when
        the pool is full those demotions displace its LRU entries. The
        chain shares from the front, so everything past the first missing
        chunk is unusable: truncate the fills there and extend the tail
        back over the lost chunks — the prime recomputes them into the
        already-owned pages, keeping the stream exact at a recompute
        cost."""
        n = len(plan.fills)
        width = _bucket(n, lo=1)
        k = v = idx = None
        filled = 0
        for i, (c, key) in enumerate(plan.fills):
            hit = self.host_kv.get_prefix(key)
            if hit is None:
                self.metrics.on_kv_fill_degraded(n - i)
                plan.prefix_len = c * self.pager.page_size
                plan.tail = np.asarray(prompt)[plan.prefix_len:]
                del plan.fills[i:]
                break
            hk, hv = hit
            if k is None:
                shape = (hk.shape[0], width) + tuple(hk.shape[2:])
                k = self._host_buffer(shape, hk.dtype)
                v = self._host_buffer(shape, hk.dtype)
                idx = np.full((width,), plan.scratch_page, np.int64)
            k[:, i], v[:, i] = hk[:, 0], hv[:, 0]
            idx[i] = plan.block_row[c]
            filled += 1
        if not filled:
            return
        self._fill_pages(k, v, idx)
        self.metrics.on_kv_fill(filled)
        self.metrics.on_prefix_host_hit(filled)

    def _prime(self, sr: ScheduledRequest, slot: int,
               prompt: np.ndarray) -> int:
        """In-flight prefill of `prompt` (on the host: the request's, or
        prompt + emitted for a recompute-resume); returns the next token.
        Paged: run the UNSHARED TAIL of the prompt through a batch-1 paged
        prefill that writes its KV into the slot's pages; reused prefix
        pages enter the tail's attention through the block-table window,
        after the COW clone, or the promotion of host-tier pages, when the
        plan calls for one. Dense: prefill the prompt into a batch-1 cache
        and splice it into the slot's row."""
        t0 = time.perf_counter()
        params, extra = self.engine._batch_extra([sr.request.adapter_id],
                                                 batch=1)
        if self.pager is None:
            batch = self._bucketed_prompt(prompt)
            batch.update(extra)
            scratch = self.engine.place_cache(self.model.init_cache(
                1, int(batch["tokens"].shape[1]), self.cache["k"].dtype,
                self.device), batch=1)
            nt, scratch = self.dispatch("prefill", self.model.prefill, scratch,
                                        batch, state=(params,))
            self.cache = self.dispatch("write", self.model.write_slot, scratch,
                                       slot, int(prompt.shape[0]),
                                       state=(self.cache,))
            tok = int(nt.reshape(-1)[0])
            self.metrics.on_prime(sr.rid, time.perf_counter() - t0)
            return tok
        plan = self._plans.pop(sr.rid)
        if plan.cow is not None:
            self.cache = self.dispatch("copy_page", self.model.copy_page,
                                       *plan.cow, state=(self.cache,))
        if plan.fills:
            self._promote_fills(plan, prompt)
        batch = self._bucketed_prompt(np.asarray(plan.tail, np.int32))
        batch.update(block_table=to_device(plan.block_row[None], self.device),
                     slot=slot, scratch_page=plan.scratch_page)
        if plan.prefix_len:
            # warm prime: the attention window gathers only the pow2 bucket
            # of the PREFIX pages, not the full pages_per_seq window
            ps = self.pager.page_size
            wp = min(_bucket(-(-plan.prefix_len // ps), lo=1),
                     self.pager.pages_per_seq)
            batch["window_table"] = to_device(plan.block_row[None, :wp],
                                              self.device)
            batch["prefix_len"] = plan.prefix_len
        batch.update(extra)
        nt, self.cache = self.dispatch("prefill_paged",
                                       self.model.prefill_paged, batch,
                                       state=(params, self.cache))
        tok = int(nt.reshape(-1)[0])
        # publish the prompt's chunks for sharing only past the host sync
        # above: a failed prime must not leave prefix-cache entries pointing
        # at never-filled pages
        self.pager.register_prompt(plan)
        self.metrics.on_prime(sr.rid, time.perf_counter() - t0)
        return tok

    def _admit_ready(self) -> Iterator[Event]:
        self._no_admit = set()
        try:
            while len(self.queue):
                resident = self.bank.resident_ids if self.bank else ()
                sr = None
                if self.slots.free_slots():
                    sr = self.queue.pop_next(self.t, self._try_admit,
                                             resident=resident)
                if sr is not None:
                    yield from self._admit_one(sr)
                    continue
                # blocked: no free slot, or every arrived request deferred
                # on pages or the bank. With preemption on, evict a
                # strictly-lower-class victim for the head-of-policy-order
                # candidate and retry.
                if (self.tiering is None or not self.tiering.preempt
                        or self.pager is None):
                    return
                cand = self.queue.peek_next(self.t, resident=resident)
                if cand is None or cand.rid in self._no_admit:
                    return
                evs = self._preempt_for(cand)
                if evs is None:
                    return
                yield from evs
                if not any(e[0] in ("preempt", "done") for e in evs):
                    return    # drained tokens only: nothing was freed, so
                              # retrying admission would spin
        finally:
            self._no_admit = set()

    def _admit_one(self, sr: ScheduledRequest) -> Iterator[Event]:
        """Acquire + prime one accepted request (fresh or resumed)."""
        resume = sr.resume
        prompt, max_new = self._effective(sr)
        plan = self._plans.get(sr.rid)
        slot = self.slots.acquire(sr.rid, budget=max_new,
                                  adapter_id=sr.request.adapter_id,
                                  prompt_len=int(prompt.shape[0]),
                                  slot=plan.slot if plan else None)
        self._sr[slot] = sr
        if resume is not None and resume.mode == "swap":
            # restore the snapshot: no prefill, no token — the slot picks
            # up exactly where the victim stopped (pos = S_eff - 1, next
            # input = the last emitted token), so the next decode emits the
            # token an unpreempted run would have
            sr.resume = None
            plan = self._plans.pop(sr.rid)
            k, v, n_used = self.host_kv.pop_snapshot(sr.rid)
            idx = np.full((k.shape[1],), plan.scratch_page, np.int64)
            idx[:n_used] = plan.block_row[:n_used]
            self._fill_pages(k, v, idx)
            pos = self.cache["pos"]
            self.dispatch("set_pos", lambda s, p: pos[s].fill_(p), slot,
                          int(prompt.shape[0]) - 1)
            self.metrics.on_kv_fill(n_used)
            tok = self._outs[sr.rid][-1]
            self._last[slot] = tok
            if self._toks_dev is not None:
                self._toks_dev[slot].fill_(tok)   # no host tensor to copy
            if self.drafter is not None:
                self.drafter.on_prime(slot, prompt[:-1], tok)
            self.metrics.on_resume(sr.rid, self.t)
            yield ("resume", sr.rid, slot, self.t)
            return
        if resume is not None:
            sr.resume = None
            self.metrics.on_resume(sr.rid, self.t)
        else:
            self.metrics.on_admit(sr.rid, self.t)
        tok = self._prime(sr, slot, prompt)
        if resume is None:
            self._outs[sr.rid] = [tok]
        else:
            # recompute-resume: the prime re-prefilled prompt + emitted and
            # produced the NEXT token of the stream
            self._outs[sr.rid].append(tok)
        self._last[slot] = tok
        if self._toks_dev is not None:
            # mid-buffer admission: in-flight slots' next tokens live only
            # on the device, so splice the new slot's first token in
            self._toks_dev[slot].fill_(tok)
        if self.drafter is not None:
            self.drafter.on_prime(slot, prompt, tok)
        self.metrics.on_token(sr.rid, self.t)
        self.queue.note_usage(sr.request.adapter_id, 1)
        yield (("resume" if resume is not None else "admit"),
               sr.rid, slot, self.t)
        yield ("token", sr.rid, tok, self.t)
        if self.slots.note_token(slot, tok):
            yield self._finish(slot)

    def _demote_prefix_page(self, key: bytes, page: int) -> None:
        """PrefixCache on_evict hook: instead of dropping a cold prefix
        page, gather its KV (queued BEFORE the page returns to the free
        list) and hand the fresh copy to the host tier, which copies it to
        the host."""
        if self.host_kv.put_prefix(key, *self._spill_pages(
                np.array([page], np.int64))):
            self.metrics.on_kv_spill(1)

    def _preempt_for(self, cand: ScheduledRequest) -> Optional[List[Event]]:
        """Evict one strictly-lower-class victim slot so `cand` can admit.
        Returns the events produced (the pre-evict drain may finish
        slots), or None when nothing is eligible. The victim's KV leaves by
        snapshot to the host ("swap") or is dropped for re-prefill at
        resume ("recompute"), per the cost estimate; either way it
        re-enters the queue with its rid, arrival and emitted tokens
        intact, and resumes with the same stream."""
        # drain first: the host view of emitted tokens must be current
        # before sizing or snapshotting a victim, and a buffered completion
        # may free a slot outright — then just retry admission (a slot that
        # was ALREADY free means the candidate is blocked on pages or the
        # bank, and eviction below is still the right move)
        free_before = len(self.slots.free_slots())
        evs = list(self._drain())
        if len(self.slots.free_slots()) > free_before:
            return evs
        crank = priority_rank(cand.request.priority)
        occupants = []
        for slot in self.slots.active_slots():
            vsr = self._sr[slot]
            if vsr is None:
                continue
            st = self.slots.state(slot)
            occupants.append(VictimInfo(
                slot=slot,
                rank=priority_rank(vsr.request.priority),
                prompt_len=int(vsr.request.prompt.shape[0]),
                emitted=len(self._outs[vsr.rid]),
                # rows actually written: pos = prompt_len + taken - 1
                used_pages=-(-(st.prompt_len + st.taken - 1)
                             // self.pager.page_size)))
        victim = choose_victim(crank, occupants)
        if victim is None:
            return evs if evs else None
        vsr = self._sr[victim.slot]
        mode = choose_mode(self.tiering, victim, self.pager.page_size,
                           host_can_swap=self.host_kv is not None)
        if mode == "swap":
            # gather the victim's used pages (padded to a pow2 width with
            # its scratch page — harmless dirt both ways) and pin the copy
            # in the host pool; a pool too full of other snapshots degrades
            # to recompute, never to waiting
            n_used = victim.used_pages
            idx = np.full((_bucket(n_used, lo=1),), victim.slot, np.int64)
            idx[:n_used] = self.pager.block_tables[victim.slot][:n_used]
            if self.host_kv.put_snapshot(vsr.rid, *self._spill_pages(idx),
                                         n_used):
                self.metrics.on_kv_spill(n_used)
            else:
                mode = "recompute"
        vsr.resume = ResumeState(mode)
        self._sr[victim.slot] = None
        self._last[victim.slot] = 0
        self.slots.release(victim.slot)   # frees pages via on_release —
        self._stale.add(victim.slot)      # AFTER the spill gather above
        if self.drafter is not None:
            self.drafter.on_release(victim.slot)
        self._prefix_keys.pop(vsr.rid, None)   # resume re-hashes eff prompt
        self.metrics.on_preempt(vsr.rid, self.t, mode)
        self.queue.requeue(vsr)
        self._no_admit.add(vsr.rid)
        evs.append(("preempt", vsr.rid, victim.slot, self.t))
        return evs

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

    # ---- cancellation ------------------------------------------------------
    @torch.no_grad()
    def cancel(self, rid: int) -> bool:
        """Abort request `rid` wherever it is — the client-disconnect path.
        A queued request is withdrawn (and a preempted one's host snapshot
        dropped); an ACTIVE one releases its slot THIS step: the release
        hook frees its KV pages, its tenant's bank row unpins the moment
        the slot leaves `slots.adapter_ids()`, and its not-yet-drained
        buffered tokens are discarded by the drain's occupancy check.
        Returns True iff the request was found live; its `.out` holds the
        tokens emitted before the abort."""
        sr = self.queue.remove(rid)
        if sr is not None:       # still queued: never admitted, or waiting
            self._prefix_keys.pop(rid, None)   # to resume after preemption
            if self.host_kv is not None:
                self.host_kv.drop_snapshot(rid)
            sr.request.out = self._outs.pop(rid, [])
            self.metrics.on_cancel(rid, self.t)
            self.metrics.queue_depth = len(self.queue)
            return True
        for slot in self.slots.active_slots():
            sr = self._sr[slot]
            if sr is None or sr.rid != rid:
                continue
            self._sr[slot] = None              # buffered overshoot for this
            self._last[slot] = 0               # slot now drains to nowhere
            self.slots.release(slot)           # frees pages via on_release
            self._stale.add(slot)
            if self.drafter is not None:
                self.drafter.on_release(slot)
            sr.request.out = self._outs.pop(rid, [])
            if not self.slots.any_active():
                # nothing left to drain for: drop the buffered-decode state
                # instead of carrying dead device work into the next round
                self._pending.clear()
                self._flag_dev = None
                self._flag_prev = None
            self.metrics.on_cancel(rid, self.t)
            return True
        return False

    # ---- decode -----------------------------------------------------------
    def _flush_stale(self) -> None:
        """One batched reset for slots freed since the last step; slots that
        were already re-primed (their position was set) drop out."""
        stale = self._stale & set(self.slots.free_slots())
        self._stale.clear()
        if stale:
            mask = np.zeros((self.n_slots,), bool)
            mask[list(stale)] = True
            self.cache = self.dispatch("reset", self.model.reset_slots, mask,
                                       state=(self.cache,))

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
        nt, self.cache = self.dispatch(
            "decode", self.model.decode_step,
            {"tokens": self._toks_dev, **extra}, state=(params, self.cache))
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
            self._flag_dev = self.dispatch(
                "or_eos", lambda f, t: f | (t == int(self.eos_id)),
                self._flag_dev, nt)
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
        drafts = to_device(self.drafter.propose(), self.device, torch.int32)
        last = self.engine.commit_tokens(np.asarray(self._last, np.int32))
        win_dev = torch.cat([last[:, None], drafts], dim=1)
        out, self.cache = self.dispatch(
            "verify", self.model.verify_step, {"tokens": win_dev, **extra},
            state=(params, self.cache))
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
        self.cache = self.dispatch("advance", self.model.advance_pos, deltas,
                                   state=(self.cache,))

    # ---- dispatch points: each records the signature it hands the model --
    def _note(self, name: str, *args) -> None:
        self._sigs.setdefault(name, set()).add(_signature(args))

    def dispatch(self, name: str, fn, *args, state: Tuple = ()):
        """`fn(*state, *args)`, recording the signature of `args` under
        dispatch point `name` (compiled_signatures). `state` is the model's
        parameters and cache, whose shapes are fixed for the scheduler's
        life: passed through, not recorded."""
        self._note(name, *args)
        return fn(*state, *args)

    # ---- static-analysis surface (repro_torch.analysis) --------------------
    def compiled_signatures(self) -> Dict[str, int]:
        """Distinct signatures each dispatch point has handed the model,
        keyed as the JAX scheduler's jit cache sizes: there is no jit
        cache in eager PyTorch, so each point records the (shape, dtype)
        signature of what it passes besides the parameters and the cache
        (`dispatch`: one tuple a dispatch on the host, no device work). It
        is the surface a CUDA graph of a step needs: one capture per
        signature. Every JAX graph has its point here (`or_eos` and
        `set_pos` are eager ops in the port, sent through `dispatch` so
        that they record), so no key is missing. `decode` counts the
        scheduler's own decode steps and the self-drafter's probes, as the
        JAX engine's shared decode jit does; other users of the engine are
        not counted."""
        keys = ["decode", "reset", "advance", "write"]
        if self.pager is not None:
            keys += ["prefill_paged", "copy_page"]
        else:
            keys.append("prefill")
        if self.drafter is not None:
            keys.append("verify")
        if self.eos_id is not None:
            keys.append("or_eos")
        if self.tiering is not None and self.pager is not None:
            keys += ["spill_pages", "fill_pages", "set_pos"]
        return {k: len(self._sigs.get(k, ())) for k in keys}

    def expected_compile_bounds(self) -> Dict[str, int]:
        """The signature CONTRACT the pow2 bucketing declares, keyed like
        `compiled_signatures()` (the JAX scheduler's, unchanged). decode/
        verify run at one fixed (n_slots, ·) shape → exactly 1 signature
        regardless of churn; prime prefills take one per pow2 prompt
        bucket (× cold + pow2 prefix-window buckets when paged). With
        `bucket=False` prefill takes one per distinct prompt length —
        unbounded by design — so no prefill bound is declared and the
        analyzer skips it."""
        bounds = {"decode": 1, "reset": 1, "advance": 1}
        if self.drafter is not None:
            bounds["verify"] = 1
            # scalar rollback (drafter probe) + (B,) accept-commit deltas
            bounds["advance"] = 2
        if self.eos_id is not None:
            bounds["or_eos"] = 1
        if self.pager is not None:
            bounds["copy_page"] = 1
            bounds["write"] = 0            # dense-path point, unused here
        if self.bucket:
            # pow2 buckets in [8, _bucket(max_len)]
            n_len = _bucket(self.max_len).bit_length() - 3
            if self.pager is not None:
                # pow2 warm prefix-window widths in [1, _bucket(pages)]
                wins = _bucket(self.pager.pages_per_seq, lo=1).bit_length()
                bounds["prefill_paged"] = n_len * (1 + wins)
            else:
                bounds["prefill"] = n_len
                bounds["write"] = n_len    # scratch k/v shape per bucket
        if self.tiering is not None and self.pager is not None:
            # spill/fill widths are pow2-bucketed in [1, _bucket(pages)]
            # regardless of the prompt-bucket flag (the widths come from
            # page counts, not prompt lengths)
            widths = _bucket(self.pager.pages_per_seq, lo=1).bit_length()
            bounds["spill_pages"] = widths
            bounds["fill_pages"] = widths
            bounds["set_pos"] = 1
        return bounds

    def resource_gauges(self) -> Dict[str, float]:
        """Occupancy gauges for the gateway's /metrics scrape: bank
        residency, prefix-cache and page-pool fill, and host-tier occupancy
        when tiering is on."""
        out: Dict[str, float] = {}
        if self.bank is not None:
            out["bank_resident_adapters"] = float(len(self.bank.resident_ids))
        if self.pager is not None:
            out["prefix_cache_pages"] = float(len(self.pager.prefix_cache))
            out["kv_pages_free"] = float(self.pager.allocator.free_count())
        if self.host_kv is not None:
            out["host_kv_pages_used"] = float(self.host_kv.used_pages)
            out["host_kv_pages_capacity"] = float(self.host_kv.capacity_pages)
        if self.host_adapters is not None:
            out["host_adapter_rows"] = float(len(self.host_adapters))
            out["host_adapter_capacity"] = float(self.host_adapters.capacity)
        return out

    # ---- main loop --------------------------------------------------------
    @torch.no_grad()
    def tick(self) -> List[Event]:
        """ONE scheduler round — admit every admissible arrived request,
        then (if anything is decoding) one decode or verify step —
        returning the round's events. Returns [] when there is nothing to
        do right now (the round idle-skips the clock to the next arrival),
        or every arrived request is deferred on resources: unlike
        `events()`, tick() never raises on an un-admittable backlog, since
        under live traffic a later round can free what admission waits on
        (the gateway pumps it from its own thread). Every prefill, decode
        and verify runs here, without autograd."""
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
        if self.host_kv is not None:
            # wait for the round's copies to the host now that its decode
            # work is queued (the copies overlapped it); holding them
            # longer would keep their device sources allocated
            self.host_kv.settle()
        if self.host_adapters is not None:
            self.host_adapters.settle()
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
