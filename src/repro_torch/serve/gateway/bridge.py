"""Async bridge between the asyncio gateway and the synchronous
`ContinuousScheduler` (the JAX package's `serve/gateway/bridge.py`).

The scheduler's decode loop is blocking host code (kernel launches plus the
buffered drains' device syncs), so it cannot run on the event loop without
stalling every connection. `SchedulerBridge` runs it on ONE daemon thread
— the scheduler stays single-threaded, exactly as the replay path uses it
— and pumps `ContinuousScheduler.tick()` forever:

    event loop ──commands──▶ pump thread ──call_soon_threadsafe──▶ loop
      submit(req)              sched.submit / tick / cancel        handle
      cancel(handle)                                               queues

All scheduler access happens on the pump thread: submissions, bank
residency checks, cancellation, and arbitrary reads via `call()` (used by
/metrics and /v1/models so a scrape never iterates dicts the pump is
mutating). Commands are processed between ticks, so each one observes a
consistent scheduler. The only event-loop-side reads are the watermark
integers (`depth()`, `free_page_frac()`) — approximate by design. Grad
mode is per thread in torch, so the pump runs everything — ticks,
submissions, cancellations and `call()`s — without autograd; the
scheduler's device and copy stream were resolved when it was built.

Across ranks (`torchrun`, a process per rank) every rank must take the
same scheduler decisions. Rank 0 runs the gateway and this pump; with a
`RankSync` the pump broadcasts each round's submissions and cancellations
to the other ranks (`broadcast_object_list` over a gloo group) before it
ticks, and every other rank runs `follow`: it applies the same commands
in the same order, then ticks the same scheduler. Only rank 0 opens a
socket and streams; stopping the pump broadcasts the stop.

Per request the bridge hands back a `RequestHandle` whose asyncio queue
receives ("token", id), ("done", tokens), ("cancelled", tokens) or
("error", message) items; a client disconnect calls `cancel(handle)`,
which aborts the request mid-stream through the scheduler's cancel path —
freeing its slot and pages and unpinning its tenant's bank row.
"""
from __future__ import annotations

import asyncio
import queue as _queue
import threading
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.serve.engine import Request


class RequestHandle:
    """Event-loop-side view of one in-flight request."""

    def __init__(self) -> None:
        self.rid: Optional[int] = None
        self.queue: "asyncio.Queue" = asyncio.Queue()
        self.tokens: List[int] = []            # tokens streamed so far
        self.closed = False                    # terminal item delivered


class RankSync:
    """The pump's round broadcast from rank 0 (module docstring): `send`
    on rank 0, `receive` on the others, over `group` (a gloo group; the
    default group when None)."""

    def __init__(self, group=None):
        self.group = group

    def send(self, ops: List) -> None:
        import torch.distributed as dist
        dist.broadcast_object_list([ops], src=0, group=self.group)

    def receive(self) -> List:
        import torch.distributed as dist
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


@torch.no_grad()
def follow(sched, sync: RankSync) -> int:
    """The pump of a rank other than 0: each round, apply rank 0's
    submissions and cancellations in its order, then tick; until rank 0
    stops. A failed tick cancels every live request, as rank 0's pump
    does. Returns the rounds followed."""
    live = set()
    rounds = 0
    while True:
        ops = sync.receive()
        for op in ops:
            if op[0] == "stop":
                return rounds
            if op[0] == "submit":
                live.add(sched.submit(op[1], arrival=op[2]))
            else:
                sched.cancel(op[1])
                live.discard(op[1])
        try:
            events = sched.tick()
        except Exception:                      # noqa: BLE001 — as rank 0
            for rid in list(live):
                try:
                    sched.cancel(rid)
                except Exception:               # noqa: BLE001 — best effort
                    pass
            live.clear()
            events = []
        for ev in events:
            if ev[0] == "done":
                live.discard(ev[1])
        rounds += 1


class SchedulerBridge:
    """Pumps a ContinuousScheduler from a daemon thread; see module doc.
    `sync`: a RankSync when other ranks follow this pump."""

    def __init__(self, sched, idle_wait_s: float = 0.005,
                 sync: Optional[RankSync] = None):
        self.sched = sched
        self.idle_wait_s = idle_wait_s
        self.sync = sync
        self._round: List = []                 # this round's commands
        self._cmds: "_queue.SimpleQueue" = _queue.SimpleQueue()
        self._handles: Dict[int, RequestHandle] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---- lifecycle (event loop side) --------------------------------------
    def start(self, loop: Optional[asyncio.AbstractEventLoop] = None) -> None:
        if self._thread is not None:
            raise RuntimeError("bridge already started")
        self._loop = loop or asyncio.get_event_loop()
        self.sched.metrics.start()             # wall clock = server uptime
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="gateway-scheduler-pump")
        self._thread.start()

    def stop(self) -> None:
        """Stop the pump (blocking join; the thread exits after at most one
        tick + idle_wait_s)."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
        self.sched.metrics.stop()

    # ---- request API (event loop side) ------------------------------------
    def submit(self, request: Request,
               validate: Optional[Callable[[], Optional[str]]] = None) \
            -> "asyncio.Future":
        """Enqueue a submission; the returned future resolves to the
        request's RequestHandle once the pump has admitted it to the
        scheduler queue — or raises RuntimeError(message) when `validate`
        (run on the pump thread, e.g. bank-residency lookup) vetoes it."""
        fut = self._loop.create_future()
        self._cmds.put(("submit", request, validate, fut))
        return fut

    def cancel(self, handle: RequestHandle) -> None:
        """Abort `handle`'s request (queued or mid-stream). Safe to call
        redundantly or after completion — cancelling a finished request is
        a no-op."""
        self._cmds.put(("cancel", handle))

    def call(self, fn: Callable):
        """Run `fn()` on the pump thread between ticks and resolve the
        returned future with its result — THE way to read scheduler/bank
        state that the pump mutates (metrics summaries, residency lists)."""
        fut = self._loop.create_future()
        self._cmds.put(("call", fn, fut))
        return fut

    # ---- watermark reads (racy by design: single ints under the GIL) ------
    def depth(self) -> int:
        """Pending + in-flight request count (the 429 queue watermark)."""
        return len(self.sched.queue) + len(self.sched.slots.active_slots())

    def queued(self) -> int:
        return len(self.sched.queue)

    def free_page_frac(self) -> float:
        """Free fraction of the allocatable page pool (1.0 when dense)."""
        pager = self.sched.pager
        if pager is None:
            return 1.0
        total = pager.n_pages - pager.n_slots
        return pager.allocator.free_count() / max(total, 1)

    def preempting(self) -> bool:
        """Whether the scheduler can actually evict a victim for blocked
        high-class work (mirrors the runtime's admission-path gate) — the
        gateway's interactive backpressure bypass is only sound then."""
        tiering = self.sched.tiering
        return (tiering is not None and tiering.preempt
                and self.sched.pager is not None)

    # ---- pump thread -------------------------------------------------------
    def _post(self, handle: RequestHandle, item) -> None:
        try:
            self._loop.call_soon_threadsafe(handle.queue.put_nowait, item)
        except RuntimeError:
            pass                               # loop already closed

    def _resolve(self, fut: "asyncio.Future", value=None,
                 error: Optional[BaseException] = None) -> None:
        def _set() -> None:
            if fut.cancelled():
                return
            if error is not None:
                fut.set_exception(error)
            else:
                fut.set_result(value)
        try:
            self._loop.call_soon_threadsafe(_set)
        except RuntimeError:
            pass

    def _exec(self, cmd) -> None:
        kind = cmd[0]
        if kind == "submit":
            _, request, validate, fut = cmd
            try:
                if validate is not None:
                    veto = validate()
                    if veto:
                        raise RuntimeError(veto)
                handle = RequestHandle()
                # live traffic arrives NOW on the decode-step clock
                arrival = self.sched.t
                handle.rid = self.sched.submit(request, arrival=arrival)
            except Exception as e:              # noqa: BLE001 — to caller
                self._resolve(fut, error=e)
                return
            self._round.append(("submit", request, arrival))
            self._handles[handle.rid] = handle
            self._resolve(fut, value=handle)
        elif kind == "cancel":
            _, handle = cmd
            rid = handle.rid
            if rid is None or rid not in self._handles:
                return                          # already finished / unknown
            del self._handles[rid]
            self.sched.cancel(rid)
            self._round.append(("cancel", rid))
            self._post(handle, ("cancelled", []))
        elif kind == "call":
            _, fn, fut = cmd
            try:
                self._resolve(fut, value=fn())
            except Exception as e:              # noqa: BLE001 — to caller
                self._resolve(fut, error=e)

    def _dispatch(self, ev) -> None:
        kind, rid = ev[0], ev[1]
        handle = self._handles.get(rid)
        if handle is None:
            return                             # cancelled or non-gateway rid
        if kind == "token":
            self._post(handle, ("token", int(ev[2])))
        elif kind == "done":
            del self._handles[rid]
            self._post(handle, ("done", [int(t) for t in ev[2]]))

    @torch.no_grad()
    def _pump(self) -> None:
        sched = self.sched
        while not self._stop.is_set():
            while True:                        # drain commands between ticks
                try:
                    self._exec(self._cmds.get_nowait())
                except _queue.Empty:
                    break
            if self.sync is not None:
                # the other ranks apply this round's commands, then tick
                self.sync.send(self._round)
            self._round = []
            try:
                events = sched.tick()
            except Exception as e:             # noqa: BLE001 — fail streams
                # a poisoned admission (e.g. corrupt checkpoint at load)
                # surfaces here; every live stream gets the error rather
                # than hanging, and the pump keeps serving
                for rid, handle in list(self._handles.items()):
                    self._post(handle, ("error", f"scheduler error: {e}"))
                    try:
                        self.sched.cancel(rid)  # release slots/pages held
                    except Exception:           # noqa: BLE001 — best effort
                        pass
                self._handles.clear()
                events = []
            for ev in events:
                self._dispatch(ev)
            if not events and not sched.slots.any_active():
                # idle: block briefly for the next command so a quiet
                # server doesn't spin (bounded so stop() stays responsive)
                try:
                    self._exec(self._cmds.get(timeout=self.idle_wait_s))
                except _queue.Empty:
                    pass
        if self.sync is not None:
            self.sync.send([("stop",)])
