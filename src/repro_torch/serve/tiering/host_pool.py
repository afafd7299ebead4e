"""Host-memory tiers for the serving runtime (the JAX package's
`serve/tiering/host_pool.py`, on pinned host tensors).

Both tiers take FRESH device tensors (a gather or a clone the caller made
on its compute stream, never a view of live state) and start their copy to
the host at once. On the card each tensor is copied on the side stream the
runtime resolved once, into a pinned buffer of torch's host allocator,
after the work the calling thread's stream had queued (the gather that
made it); the source stays referenced until the copy's event completes, so
the allocator cannot hand its memory to later work while the copy reads
it. A reader waits on the entry's event before it touches the host copy:
`settle()` (the runtime calls it once per scheduler round, after the
round's device work is queued, so the copies overlap decode and the device
sources are released promptly), `get_prefix`, `pop_snapshot` and
`HostAdapterTier.get`. On the CPU (no stream) the tensors the caller hands
over are the host copies, and nothing waits.

`HostPagePool` — KV pages. Two populations share one page-count budget:
  - prefix entries (one page, keyed by the prefix cache's chain hash):
    demoted cold prefix pages, LRU-evictable, promoted back on a match;
  - snapshots (keyed by request id): a preempted victim's used pages,
    PINNED until the request resumes or is cancelled — losing one would
    break the resume-exactness contract, so snapshots never evict and a
    put that cannot fit even after draining every prefix entry fails (the
    scheduler then falls back to recompute).

`HostAdapterTier` — evicted AdapterBank rows ({site: {leaf: tensor}} trees
keyed by tenant), LRU over `capacity` tenants. A host hit at admission
skips the checkpoint read; a miss falls back to `load_from_checkpoint`.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch


class HostCopy:
    """Host copies of device tensors that land asynchronously: the copies
    run on `stream` after the work the calling thread's stream has queued,
    into pinned buffers, and `wait()` waits for them alone (module doc).
    `stream` None: the tensors are already the host copies (the CPU)."""

    def __init__(self, tensors: Sequence[torch.Tensor], stream=None):
        self._event = None
        self._src = None
        if stream is None:
            self.host = list(tensors)
            return
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(stream)
        self._src = list(tensors)

    @property
    def landed(self) -> bool:
        return self._event is None

    def wait(self) -> List[torch.Tensor]:
        """The host copies, once their copy has completed."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None
            self._src = None
        return self.host


class HostPagePool:
    """Host tier for KV pages: LRU prefix entries + pinned snapshots.
    Entries hold k/v of shape (L, P, page_size, n_kv, head_dim) — one page
    for a prefix entry, the padded spill width for a snapshot."""

    def __init__(self, capacity_pages: int, stream=None):
        if capacity_pages < 1:
            raise ValueError("HostPagePool needs capacity_pages >= 1")
        self.capacity_pages = capacity_pages
        self._stream = stream
        self._prefix: "OrderedDict[bytes, HostCopy]" = OrderedDict()
        # rid -> (k/v host copy, n_pages used, stored width)
        self._snapshots: Dict[int, Tuple[HostCopy, int, int]] = {}
        self._snap_pages = 0
        self._unsettled: List[HostCopy] = []

    # ---- accounting --------------------------------------------------------
    @property
    def used_pages(self) -> int:
        return len(self._prefix) + self._snap_pages

    @property
    def free_pages(self) -> int:
        return self.capacity_pages - self.used_pages

    def __len__(self) -> int:
        return len(self._prefix) + len(self._snapshots)

    def _make_room(self, need: int) -> bool:
        """Evict LRU prefix entries until `need` pages fit; False when even
        an empty prefix side cannot cover it (snapshots never evict)."""
        if need > self.capacity_pages - self._snap_pages:
            return False
        while self.free_pages < need:
            self._prefix.popitem(last=False)
        return True

    def _copy(self, tensors) -> HostCopy:
        entry = HostCopy(tensors, self._stream)
        if not entry.landed:
            self._unsettled.append(entry)
        return entry

    # ---- prefix tier -------------------------------------------------------
    def has_prefix(self, key: bytes) -> bool:
        return key in self._prefix

    def touch_prefix(self, key: bytes) -> bool:
        """has_prefix + LRU refresh: the admission planner probes fill
        candidates through this, so the keys a plan is about to promote
        become MRU and `_make_room` (fed by the SAME plan's device-side
        demotions) displaces older entries first. Not a pin — a plan whose
        demotions exceed the pool can still age its own fills out, which
        the runtime degrades to recompute."""
        if key not in self._prefix:
            return False
        self._prefix.move_to_end(key)
        return True

    def put_prefix(self, key: bytes, k: torch.Tensor,
                   v: torch.Tensor) -> bool:
        """Admit one demoted prefix page. False when the pool cannot fit it
        — the page is simply dropped, as without a host tier."""
        if key in self._prefix:
            self._prefix.move_to_end(key)
            return True
        if not self._make_room(1):
            return False
        self._prefix[key] = self._copy((k, v))
        return True

    def get_prefix(self, key: bytes
                   ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """(k, v) host tensors of one host-resident chunk (LRU-touched),
        or None. The entry STAYS host-resident — a promotion copies it
        back to device pages; the host copy ages out through the LRU."""
        entry = self._prefix.get(key)
        if entry is None:
            return None
        self._prefix.move_to_end(key)
        k, v = entry.wait()
        return k, v

    # ---- snapshot tier -----------------------------------------------------
    def put_snapshot(self, rid: int, k: torch.Tensor, v: torch.Tensor,
                     n_pages: int) -> bool:
        """Pin a preemption snapshot (its page dim may be padded past
        `n_pages` by the spill's pow2 bucketing — the budget charges the
        stored width, which is what host memory holds)."""
        if rid in self._snapshots:
            raise KeyError(f"request {rid} already holds a snapshot")
        width = int(k.shape[1])
        if not self._make_room(width):
            return False
        self._snapshots[rid] = (self._copy((k, v)), n_pages, width)
        self._snap_pages += width
        return True

    def pop_snapshot(self, rid: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Consume (k, v, n_pages) at resume, once the copy has landed;
        frees the budget."""
        entry, n_pages, width = self._snapshots.pop(rid)
        self._snap_pages -= width
        k, v = entry.wait()
        return k, v, n_pages

    def drop_snapshot(self, rid: int) -> bool:
        """Discard a snapshot without resuming (cancelled request)."""
        entry = self._snapshots.pop(rid, None)
        if entry is None:
            return False
        self._snap_pages -= entry[2]
        return True

    def has_snapshot(self, rid: int) -> bool:
        return rid in self._snapshots

    # ---- lifecycle ---------------------------------------------------------
    def settle(self) -> None:
        """Wait for every copy started since the last settle (the runtime
        calls this once per scheduler round, after queueing the round's
        device work)."""
        pending, self._unsettled = self._unsettled, []
        for entry in pending:
            entry.wait()


class HostAdapterTier:
    """LRU host tier for evicted AdapterBank rows."""

    def __init__(self, capacity: int,
                 on_spill: Optional[Callable[[], None]] = None, stream=None):
        if capacity < 1:
            raise ValueError("HostAdapterTier needs capacity >= 1")
        self.capacity = capacity
        self.on_spill = on_spill
        self._stream = stream
        # aid -> (method, {site: [leaf names]}, host copy of the leaves in
        # site/leaf order)
        self._entries: "OrderedDict[str, Tuple[str, Dict, HostCopy]]" = \
            OrderedDict()
        self._unsettled: List[HostCopy] = []

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, adapter_id: str) -> bool:
        return adapter_id in self._entries

    def put(self, adapter_id: str, method: str,
            tree: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Admit one evicted tenant's trainable rows ({site: {leaf:
        tensor}}, fresh copies). Evicts the LRU tenant past capacity."""
        names = {site: sorted(leaves) for site, leaves in tree.items()}
        entry = HostCopy([tree[site][leaf] for site in sorted(names)
                          for leaf in names[site]], self._stream)
        if not entry.landed:
            self._unsettled.append(entry)
        self._entries.pop(adapter_id, None)
        self._entries[adapter_id] = (method, names, entry)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
        if self.on_spill is not None:
            self.on_spill()

    def get(self, adapter_id: str
            ) -> Optional[Tuple[str, Dict[str, Dict[str, torch.Tensor]]]]:
        """(method, {site: {leaf: host tensor}}) once landed, or None."""
        entry = self._entries.get(adapter_id)
        if entry is None:
            return None
        self._entries.move_to_end(adapter_id)
        method, names, copy = entry
        it = iter(copy.wait())
        tree = {site: {leaf: next(it) for leaf in names[site]}
                for site in sorted(names)}
        return method, tree

    def drop(self, adapter_id: str) -> bool:
        """Discard a spilled row (a fresh device load supersedes it).
        Returns whether anything was held."""
        return self._entries.pop(adapter_id, None) is not None

    def settle(self) -> None:
        pending, self._unsettled = self._unsettled, []
        for entry in pending:
            entry.wait()
