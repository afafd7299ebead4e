"""Paged KV cache with shared-prefix reuse (a copy of the JAX package's
`serve/paging.py`; `block_table_device` returns a torch tensor on the
pool's `device`).

Host-side bookkeeping for the continuous-batching runtime's paged cache:

- `PageAllocator` — refcounted free-list over a fixed pool of fixed-size
  pages. Pages [0, n_reserved) are per-slot scratch (one per decode slot,
  never allocated or freed): every slot's unallocated block-table entries
  point at its own scratch page, so decode's unconditional scatter write
  always has a unique, harmless target.
- `PrefixCache` — chained hash of page-aligned prompt-prefix chunks ->
  immutable page. The chain key is seeded with the request's adapter id:
  factored adapters transform the backbone projections, so a prefix's KV is
  TENANT-DEPENDENT — sharing it across tenants would serve wrong math
  (bit-exactness would break). Same-tenant (and bare-base) traffic with a
  common system prompt is exactly the workload that shares. Each entry
  holds one allocator reference; entries whose page no live block table
  shares (refcount == 1) are LRU-evicted when the pool runs dry.
- `PagedKVCache` — the per-slot block-table manager gluing both to the
  scheduler's admit/decode/release lifecycle: `plan_admit` matches the
  prompt against the prefix cache, allocates the slot's owned pages
  up-front (every position the request can ever write, so decode NEVER
  allocates — admission is the only point that can defer on capacity), and
  returns the `PrimePlan` the runtime's tail prefill consumes; `release`
  frees/derefs every page the slot holds the same step its request
  completes.

COW rule: shared pages are immutable. Tail prefill and decode only ever
write positions >= prefix_len, which lie past every shared page — except
when a prompt is EXACTLY a cached page-aligned prefix: its last token must
still run through the model for the next-token logits, and that token's KV
row lives inside the final shared page. `plan_admit` then returns a
`cow=(src, dst)` pair — the runtime clones src into a freshly-owned dst
(`Model.copy_page`) and the 1-token tail write lands in the clone, leaving
the shared original byte-identical for its other holders.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

_CHAIN_SEED = b"repro-paging-v1/"


class PageError(RuntimeError):
    """Refcount misuse: double free / ref of a free page / reserved-page
    free — always a bug in the caller's lifecycle, never load-dependent."""


class OutOfPagesError(PageError):
    """The pool has no free page (after prefix-cache eviction)."""


class PageAllocator:
    """Refcounted free-list over `n_pages` fixed-size pages; pages
    [0, n_reserved) are reserved per-slot scratch, outside alloc/free."""

    def __init__(self, n_pages: int, n_reserved: int = 0):
        if n_pages <= n_reserved:
            raise ValueError(f"pool of {n_pages} pages can't reserve "
                             f"{n_reserved}")
        self.n_pages = n_pages
        self.n_reserved = n_reserved
        self._free = list(range(n_reserved, n_pages))
        self._refs = [0] * n_pages

    def free_count(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def alloc(self) -> int:
        if not self._free:
            raise OutOfPagesError(
                f"page pool exhausted ({self.n_pages} pages, "
                f"{self.n_reserved} reserved)")
        page = self._free.pop()
        self._refs[page] = 1
        return page

    def ref(self, page: int) -> None:
        if page < self.n_reserved or self._refs[page] < 1:
            raise PageError(f"ref of unallocated page {page}")
        self._refs[page] += 1

    def free(self, page: int) -> None:
        if page < self.n_reserved:
            raise PageError(f"free of reserved scratch page {page}")
        if self._refs[page] < 1:
            raise PageError(f"double free of page {page}")
        self._refs[page] -= 1
        if self._refs[page] == 0:
            self._free.append(page)


class PrefixCache:
    """Chained-hash prefix chunks -> immutable pages, LRU-evictable.

    Entries form chains (chunk c's key hashes the whole prefix through it),
    so evicting an interior chunk while a descendant stays cached would
    strand the descendant: `match` walks front-to-back and stops at the
    first miss, making the still-referenced descendant pages unreachable
    dead weight. Eviction is therefore LEAF-FIRST — an entry is evictable
    only while no cached entry names it as parent — which also means chains
    shrink from the tail, exactly the cold end of a shared prefix.

    `on_evict(key, page)` fires right before each page is freed; the
    tiering runtime uses it to demote the page's KV to the host pool
    (DESIGN.md §Tiering). The hook must not touch the cache."""

    def __init__(self, allocator: PageAllocator,
                 on_evict: Optional[Callable[[bytes, int], None]] = None):
        self._alloc = allocator
        self.on_evict = on_evict
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()
        self._parent: Dict[bytes, Optional[bytes]] = {}
        self._nkids: Dict[bytes, int] = {}

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def pages(self) -> Tuple[int, ...]:
        return tuple(self._entries.values())

    @staticmethod
    def chain_keys(prompt: np.ndarray, page_size: int,
                   adapter_id: Optional[str]) -> List[bytes]:
        """One key per full page-aligned chunk of `prompt`, each hashing
        the ENTIRE prefix through it (chained), seeded by the tenant."""
        keys = []
        h = _CHAIN_SEED + (adapter_id or "").encode()
        for c in range(len(prompt) // page_size):
            chunk = np.ascontiguousarray(
                prompt[c * page_size:(c + 1) * page_size], dtype=np.int32)
            h = hashlib.blake2b(h + chunk.tobytes(),
                                digest_size=16).digest()
            keys.append(h)
        return keys

    def match(self, keys: List[bytes]) -> List[int]:
        """Pages of the longest cached chain prefix (LRU-touched)."""
        pages = []
        for key in keys:
            page = self._entries.get(key)
            if page is None:
                break
            self._entries.move_to_end(key)
            pages.append(page)
        return pages

    def insert(self, key: bytes, page: int,
               parent: Optional[bytes] = None) -> None:
        """Register `page` as the immutable holder of chunk `key` (takes
        one allocator reference); `parent` is the previous chunk's key in
        the chain (None for the first chunk). No-op when the chunk is
        already cached — the existing page stays canonical.

        The parent link is recorded even when the ancestor is currently
        absent: chain keys are pure functions of the prefix, so if the
        ancestor's key is ever (re-)inserted it must immediately count
        this child — otherwise leaf-first eviction could evict the
        interior chunk first, stranding the descendant (unreachable —
        `match` stops at the first miss — yet still holding its page)."""
        if key in self._entries:
            self._entries.move_to_end(key)
            return
        self._alloc.ref(page)
        self._entries[key] = page
        self._parent[key] = parent
        if parent is not None:
            self._nkids[parent] = self._nkids.get(parent, 0) + 1

    def _drop(self, key: bytes, page: int) -> None:
        if self.on_evict is not None:
            self.on_evict(key, page)
        del self._entries[key]
        parent = self._parent.pop(key, None)
        if parent is not None:
            self._nkids[parent] -= 1
            if not self._nkids[parent]:
                del self._nkids[parent]
        self._alloc.free(page)

    def evict_until_free(self, need: int) -> Tuple[int, int]:
        """Drop entries until `need` pages are free, leaf-first in LRU
        order, touching only pages no block table shares (refcount 1).
        Stops the moment the free list covers `need` — never overshoots —
        and reports (evicted, shortfall) where shortfall is how many pages
        the caller still lacks because every remaining entry is pinned (by
        a live block table or a cached descendant)."""
        evicted = 0
        progress = True
        while progress and self._alloc.free_count() < need:
            progress = False
            for key in list(self._entries):
                if self._alloc.free_count() >= need:
                    break
                if self._nkids.get(key):
                    continue        # interior chunk: descendants first
                page = self._entries[key]
                if self._alloc.refcount(page) == 1:
                    self._drop(key, page)
                    evicted += 1
                    progress = True
        return evicted, max(0, need - self._alloc.free_count())


@dataclass
class PrimePlan:
    """Everything the runtime's paged prime needs for one admission."""
    slot: int
    prefix_len: int            # reused tokens already resident in pages
    tail: np.ndarray           # prompt[prefix_len:] — what prefill computes
    block_row: np.ndarray      # (pages_per_seq,) int32
    cow: Optional[Tuple[int, int]]   # (src, dst) page clone, or None
    scratch_page: int
    chunk_keys: List[bytes]    # chain keys of the prompt's full chunks —
                               # published via register_prompt AFTER the
                               # prime fills the pages
    fills: List[Tuple[int, bytes]] = field(default_factory=list)
                               # host-resident chunks to copy into owned
                               # pages before the prime: (chunk index c,
                               # chain key) — the target page is
                               # block_row[c] (DESIGN.md §Tiering)


class PagedKVCache:
    """Block-table + page-lifecycle manager for one paged decode pool.

    `host_has` (optional, set by the tiering runtime) answers whether a
    chain key is resident in the host KV tier; when set, `plan_admit`
    extends a device prefix match with host-resident chunks and returns
    them as `PrimePlan.fills` for the runtime to copy back (promote)
    before the prime."""

    def __init__(self, n_slots: int, max_len: int, page_size: int = 16,
                 n_pages: Optional[int] = None, device=None):
        self.device = device                # where block_table_device lives
        self.host_has: Optional[Callable[[bytes], bool]] = None
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_slots = n_slots
        self.max_len = max_len
        self.page_size = page_size
        self.pages_per_seq = pps = -(-max_len // page_size)
        if n_pages is None:
            # worst case (zero sharing): every slot owns its full window;
            # headroom lets the prefix cache retain pages across requests
            n_pages = n_slots + n_slots * pps + 2 * pps
        if n_pages < n_slots + pps:
            raise ValueError(
                f"{n_pages} pages cannot hold {n_slots} scratch pages plus "
                f"one full {pps}-page window")
        self.n_pages = n_pages
        self.allocator = PageAllocator(n_pages, n_reserved=n_slots)
        self.prefix_cache = PrefixCache(self.allocator)
        # scratch page of slot i is page i: unallocated entries default there
        self.block_tables = np.tile(
            np.arange(n_slots, dtype=np.int32)[:, None], (1, pps))
        self._slot_pages: List[List[int]] = [[] for _ in range(n_slots)]
        self._device_bt = None
        self._device_scratch = None

    # ---- admission --------------------------------------------------------
    def plan_admit(self, slot: int, prompt: np.ndarray, max_new: int,
                   adapter_id: Optional[str] = None,
                   keys: Optional[List[bytes]] = None) -> Optional[PrimePlan]:
        """Build the slot's block-table row for one request: match the
        prompt's page-aligned prefix against the prefix cache, allocate
        every owned page the request can ever write (positions
        0..S+max_new-2 — the last generated token is never written), and
        register the prompt's own full chunks for future sharing. Returns
        None when the pool (after eviction) cannot cover the owned pages —
        the scheduler defers the request, exactly like a pinned-full bank.

        keys: precomputed `PrefixCache.chain_keys(prompt, page_size,
        adapter_id)` — a deferred request is re-offered every admission
        cycle, and the chain hash is a pure function of the prompt, so the
        scheduler memoizes it instead of re-hashing per offer."""
        if self._slot_pages[slot]:
            raise PageError(f"slot {slot} still holds pages")
        prompt = np.asarray(prompt)
        S = int(prompt.shape[0])
        ps = self.page_size
        total_pages = -(-(S + max_new - 1) // ps)
        if total_pages > self.pages_per_seq:
            raise ValueError(
                f"prompt ({S}) + max_new ({max_new}) needs {total_pages} "
                f"pages > pages_per_seq ({self.pages_per_seq})")
        if keys is None:
            keys = PrefixCache.chain_keys(prompt, ps, adapter_id)
        shared = self.prefix_cache.match(keys)
        cow_src = None
        if shared and len(shared) * ps >= S:
            # the prompt IS a cached page-aligned prefix: its last token
            # must still be recomputed for the next-token logits, and its
            # KV row lives inside the final shared page -> COW that page
            cow_src = shared.pop()
        fills: List[Tuple[int, bytes]] = []
        if cow_src is None and self.host_has is not None:
            # extend the device match with host-resident chunks. The fill
            # target is an OWNED page (no pinning, no COW interplay), and
            # we stop one token short of full coverage so the last prompt
            # token always prefills on device for its logits — the host
            # tier never recreates the COW corner.
            c = len(shared)
            while ((c + 1) * ps <= S - 1 and c < len(keys)
                   and self.host_has(keys[c])):
                fills.append((c, keys[c]))
                c += 1
        # pin the matched pages (and the COW source) BEFORE any eviction:
        # once their original slots drained they sit at refcount 1 (cache-
        # only), exactly what the LRU pass below frees — matching without
        # pinning would let eviction pull the pages out from under us
        for page in shared:
            self.allocator.ref(page)
        if cow_src is not None:
            self.allocator.ref(cow_src)
        n_owned = total_pages - len(shared)
        if self.allocator.free_count() < n_owned:
            self.prefix_cache.evict_until_free(n_owned)
        if self.allocator.free_count() < n_owned:
            # give the match back before deferring: the entries WE pinned
            # may be the only evictable pages (e.g. a fully-cached prompt
            # at the capacity bound on a minimal pool, where the COW clone
            # needs one page more than a full window) — a cold prime needs
            # more owned pages but zero pins, and always fits a pool that
            # holds one full window once the cache is drained
            for page in shared:
                self.allocator.free(page)
            if cow_src is not None:
                self.allocator.free(cow_src)
            shared, cow_src, fills = [], None, []
            n_owned = total_pages
            if self.allocator.free_count() < n_owned:
                self.prefix_cache.evict_until_free(n_owned)
                if self.allocator.free_count() < n_owned:
                    return None
        row = np.full((self.pages_per_seq,), slot, np.int32)
        held: List[int] = list(shared)         # pinned above
        for i, page in enumerate(shared):
            row[i] = page
        owned = [self.allocator.alloc() for _ in range(n_owned)]
        for i, page in enumerate(owned):
            row[len(shared) + i] = page
            held.append(page)
        if cow_src is not None:
            prefix_len = S - 1
            cow = (cow_src, owned[0])
            held.append(cow_src)   # the pin guards src until the runtime's
        else:                      # copy_page; held through the request —
            # filled chunks count as resident prefix: the runtime copies
            # them into their owned pages before the prime runs
            prefix_len = (len(shared) + len(fills)) * ps
            cow = None
        self._slot_pages[slot] = held
        self.block_tables[slot] = row
        self._device_bt = None
        return PrimePlan(slot=slot, prefix_len=prefix_len,
                         tail=prompt[prefix_len:], block_row=row,
                         cow=cow, scratch_page=slot, chunk_keys=keys,
                         fills=fills)

    def register_prompt(self, plan: PrimePlan) -> None:
        """Publish the plan's full page-aligned chunks into the prefix
        cache. Called by the runtime AFTER the prime prefill has filled the
        pages — registering inside plan_admit would poison the cache with
        never-filled pages if the prime raised (the pages are immutable
        from here on: tail writes stop at position S-1, decode writes start
        at S, both past every full chunk)."""
        for c, key in enumerate(plan.chunk_keys):
            self.prefix_cache.insert(key, int(plan.block_row[c]),
                                     parent=plan.chunk_keys[c - 1] if c
                                     else None)

    def plan_resume(self, slot: int, total_pages: int) -> Optional[PrimePlan]:
        """Block-table row for a swap-resumed request (DESIGN.md §Tiering):
        all `total_pages` pages are freshly owned — the snapshot holds the
        victim's exact KV including any formerly-shared prefix pages, so
        nothing is matched or pinned and the restored pages stay private
        (re-publishing them could collide with keys the cache still holds
        canonical pages for; resume keeps it simple and private). Returns
        None when the pool cannot cover it — the scheduler keeps the
        request queued and re-offers next cycle."""
        if self._slot_pages[slot]:
            raise PageError(f"slot {slot} still holds pages")
        if total_pages > self.pages_per_seq:
            raise ValueError(
                f"resume needs {total_pages} pages > pages_per_seq "
                f"({self.pages_per_seq})")
        if self.allocator.free_count() < total_pages:
            self.prefix_cache.evict_until_free(total_pages)
            if self.allocator.free_count() < total_pages:
                return None
        row = np.full((self.pages_per_seq,), slot, np.int32)
        owned = [self.allocator.alloc() for _ in range(total_pages)]
        for i, page in enumerate(owned):
            row[i] = page
        self._slot_pages[slot] = owned
        self.block_tables[slot] = row
        self._device_bt = None
        return PrimePlan(slot=slot, prefix_len=0,
                         tail=np.empty((0,), np.int32), block_row=row,
                         cow=None, scratch_page=slot, chunk_keys=[])

    # ---- lifecycle --------------------------------------------------------
    def release(self, slot: int) -> None:
        """Free every page reference the slot holds (owned pages return to
        the free list unless the prefix cache retains them) and point the
        slot's block-table row back at its scratch page."""
        for page in self._slot_pages[slot]:
            self.allocator.free(page)
        self._slot_pages[slot] = []
        self.block_tables[slot, :] = slot
        self._device_bt = None

    def block_table_device(self):
        """(n_slots, pages_per_seq) int32 torch tensor on the pool's device,
        cached until the host tables change — one small transfer per
        admission/release, not per decode step."""
        if self.device is None:
            raise ValueError("PagedKVCache was built without a device")
        if self._device_bt is None:
            from repro_torch.devices import to_device
            self._device_bt = to_device(self.block_tables, self.device)
        return self._device_bt

    def scratch_pages_device(self):
        """(n_slots,) int32 torch tensor on the pool's device: slot i's
        scratch page, page i, where its writes past its own pages go."""
        if self.device is None:
            raise ValueError("PagedKVCache was built without a device")
        if self._device_scratch is None:
            import torch
            self._device_scratch = torch.arange(
                self.n_slots, dtype=torch.int32, device=self.device)
        return self._device_scratch

    # ---- invariants (tests) -----------------------------------------------
    def holders(self) -> Dict[int, int]:
        """page -> number of holders (slots + prefix cache), non-reserved."""
        refs: Dict[int, int] = {}
        for pages in self._slot_pages:
            for page in pages:
                refs[page] = refs.get(page, 0) + 1
        for page in self.prefix_cache.pages:
            refs[page] = refs.get(page, 0) + 1
        return refs

    def assert_no_leaks(self) -> None:
        """Every non-reserved page's refcount equals its holder count, and
        unheld pages are exactly the free list."""
        refs = self.holders()
        free = 0
        for page in range(self.n_slots, self.n_pages):
            expect = refs.get(page, 0)
            got = self.allocator.refcount(page)
            if got != expect:
                raise AssertionError(
                    f"page {page}: refcount {got} != {expect} holders")
            free += expect == 0
        if free != self.allocator.free_count():
            raise AssertionError(
                f"{free} unheld pages but free list has "
                f"{self.allocator.free_count()}")
