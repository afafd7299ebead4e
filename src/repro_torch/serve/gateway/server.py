"""OpenAI-compatible asyncio HTTP gateway over the continuous runtime (the
JAX package's `serve/gateway/server.py`).

Endpoints:

    POST /v1/chat/completions   chat messages -> completion (JSON or SSE)
    POST /v1/completions        text or token-id prompt -> completion
    GET  /v1/models             base + resident bank tenants
    GET  /metrics               Prometheus text: ServingMetrics counters/
                                percentiles + gateway response counters
    GET  /healthz               readiness probe

Built on `asyncio.start_server` with hand-rolled HTTP/1.1 — the repo's
serving path takes no dependency beyond the stdlib. One request per
connection (`Connection: close`); SSE streams are close-delimited, so a
client reads `data:` frames until `data: [DONE]` and EOF.

Admission control (per request, before the scheduler sees it):
  - validation (protocol.parse_request) -> 400/404;
  - backpressure: queued depth >= `max_queue` OR free-page fraction below
    `min_free_page_frac` with a non-empty queue -> 429 + Retry-After;
  - adapter routing: `adapter:<id>` must be bank-resident or present in
    the bank's checkpoint dir -> 404 otherwise (checked on the pump
    thread, racelessly against LRU churn).

Cancellation: a client disconnect (monitored at EOF mid-stream) or a
`request_timeout_s` overrun aborts the request through
`ContinuousScheduler.cancel` — the slot recycles, its pages free, and the
tenant's bank row unpins the same scheduler round.
"""
from __future__ import annotations

import asyncio
import json
import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.serve.engine import Request
from repro_torch.serve.gateway import protocol
from repro_torch.serve.gateway.bridge import RequestHandle, SchedulerBridge
from repro_torch.serve.gateway.protocol import ApiError

_MAX_BODY = 4 << 20                     # 4 MiB request-body cap
_MAX_HEADER = 64 << 10


class GatewayServer:
    """The asyncio front end over one ContinuousScheduler.

    max_queue:            queued (not yet admitted) request watermark —
                          at/above it new work gets 429.
    min_free_page_frac:   page-pool watermark — with a non-empty queue and
                          less than this fraction of allocatable pages
                          free, new work gets 429 (0 disables).
    retry_after_s:        Retry-After header value on 429.
    request_timeout_s:    end-to-end deadline per request (None = off);
                          overruns cancel the request mid-stream.
    default_max_new:      `max_tokens` default when the client omits it.
    sync:                 a `bridge.RankSync` when other ranks follow
                          this gateway's pump (rank 0 of a group).
    """

    def __init__(self, sched, eos_id: Optional[int] = None,
                 max_queue: int = 32, min_free_page_frac: float = 0.0,
                 retry_after_s: float = 1.0,
                 request_timeout_s: Optional[float] = None,
                 default_max_new: int = 16, sync=None):
        self.sched = sched
        self.eos_id = eos_id
        self.max_queue = max_queue
        self.min_free_page_frac = min_free_page_frac
        self.retry_after_s = retry_after_s
        self.request_timeout_s = request_timeout_s
        self.default_max_new = default_max_new
        self.vocab = int(sched.model.cfg.vocab)
        self.max_len = int(sched.max_len)
        self.base_aliases = (sched.model.cfg.name,)
        self.bridge = SchedulerBridge(sched, sync=sync)
        self.responses: Dict[int, int] = {}    # HTTP status -> count
        self._ids = 0
        self._server: Optional[asyncio.base_events.Server] = None
        self.host: Optional[str] = None
        self.port: Optional[int] = None

    # ---- lifecycle ---------------------------------------------------------
    async def start(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.bridge.start(asyncio.get_running_loop())
        self._server = await asyncio.start_server(self._serve_conn,
                                                  host, port)
        sock = self._server.sockets[0].getsockname()
        self.host, self.port = sock[0], sock[1]

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        self.bridge.stop()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # ---- connection handling ----------------------------------------------
    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            try:
                method, path, headers, body = await self._read_request(reader)
            except ApiError as e:
                await self._respond_json(writer, e.status, e.body())
                return
            except (asyncio.IncompleteReadError, ConnectionError):
                return                         # client went away mid-request
            await self._route(method, path, headers, body, reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass                               # disconnects are normal
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _read_request(self, reader) -> Tuple[str, str, Dict, bytes]:
        line = await reader.readuntil(b"\r\n")
        parts = line.decode("latin-1").strip().split()
        if len(parts) != 3:
            raise ApiError(400, "malformed request line")
        method, path = parts[0].upper(), parts[1]
        headers: Dict[str, str] = {}
        size = len(line)
        while True:
            line = await reader.readuntil(b"\r\n")
            size += len(line)
            if size > _MAX_HEADER:
                raise ApiError(431, "headers too large")
            if line == b"\r\n":
                break
            name, _, value = line.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        if "chunked" in headers.get("transfer-encoding", "").lower():
            raise ApiError(400, "chunked request bodies are not supported")
        length = headers.get("content-length", "0")
        try:
            n = int(length)
        except ValueError:
            raise ApiError(400, f"bad Content-Length {length!r}") from None
        if n < 0 or n > _MAX_BODY:
            raise ApiError(413, f"request body of {n} bytes exceeds the "
                                f"{_MAX_BODY}-byte cap")
        body = await reader.readexactly(n) if n else b""
        return method, path, headers, body

    async def _route(self, method, path, headers, body, reader, writer):
        path = path.split("?", 1)[0]
        if method == "POST" and path == "/v1/chat/completions":
            await self._handle_generate("chat", body, reader, writer)
        elif method == "POST" and path == "/v1/completions":
            await self._handle_generate("completion", body, reader, writer)
        elif method == "GET" and path == "/v1/models":
            await self._handle_models(writer)
        elif method == "GET" and path == "/metrics":
            await self._handle_metrics(writer)
        elif method == "GET" and path == "/healthz":
            await self._respond_json(writer, 200, {"status": "ok"})
        else:
            await self._respond_json(
                writer, 404,
                ApiError(404, f"no route for {method} {path}",
                         err_type="not_found_error").body())

    # ---- plain responses ---------------------------------------------------
    _REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
                408: "Request Timeout", 413: "Payload Too Large",
                429: "Too Many Requests", 431: "Header Too Large",
                500: "Internal Server Error", 504: "Gateway Timeout"}

    def _head(self, status: int, content_type: str,
              extra: Dict[str, str] = (), length: Optional[int] = None) \
            -> bytes:
        self.responses[status] = self.responses.get(status, 0) + 1
        lines = [f"HTTP/1.1 {status} {self._REASONS.get(status, 'OK')}",
                 f"Content-Type: {content_type}", "Connection: close"]
        if length is not None:
            lines.append(f"Content-Length: {length}")
        for k, v in dict(extra or {}).items():
            lines.append(f"{k}: {v}")
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    async def _respond(self, writer, status: int, payload: bytes,
                       content_type: str, extra=()) -> None:
        writer.write(self._head(status, content_type, extra, len(payload))
                     + payload)
        await writer.drain()

    async def _respond_json(self, writer, status: int, obj,
                            extra=()) -> None:
        await self._respond(writer, status,
                            json.dumps(obj).encode("utf-8"),
                            "application/json", extra)

    # ---- info endpoints ----------------------------------------------------
    async def _handle_models(self, writer) -> None:
        def _list():
            resident = self.sched.bank.resident_ids \
                if self.sched.bank is not None else ()
            return list(resident)
        resident = await self.bridge.call(_list)
        created = int(time.time())
        data = [{"id": protocol.MODEL_BASE, "object": "model",
                 "created": created, "owned_by": "repro"}]
        data += [{"id": f"{protocol.ADAPTER_PREFIX}{aid}",
                  "object": "model", "created": created,
                  "owned_by": "repro", "resident": True}
                 for aid in resident]
        await self._respond_json(writer, 200,
                                 {"object": "list", "data": data})

    async def _handle_metrics(self, writer) -> None:
        def _scrape():
            out = self.sched.metrics.summary()
            # bank residency, prefix-cache pages, host-tier occupancy
            out.update(self.sched.resource_gauges())
            return out
        summary = await self.bridge.call(_scrape)
        summary["gateway_page_free_frac"] = self.bridge.free_page_frac()
        labeled = {"gateway_responses_total":
                   {f'code="{code}"': n
                    for code, n in sorted(self.responses.items())}}
        text = protocol.prometheus_text(summary, labeled=labeled)
        await self._respond(writer, 200, text.encode("utf-8"),
                            "text/plain; version=0.0.4")

    # ---- generation --------------------------------------------------------
    def _overloaded(self, priority: str = "batch") -> bool:
        """Class-aware backpressure: interactive work
        skips the page-frac gate ONLY when the scheduler can actually
        preempt for it (otherwise it would just queue behind pressure with
        overload protection disabled — and `priority` is client-supplied,
        so the bypass must not outrun what the backend enforces);
        best_effort work is shed at half the queue watermark so it never
        crowds out the classes above it."""
        queued = self.bridge.queued()
        watermark = self.max_queue
        if priority == "best_effort":
            watermark = max(1, self.max_queue // 2)
        if queued >= watermark:
            return True
        if priority == "interactive" and self.bridge.preempting():
            return False
        return (self.min_free_page_frac > 0 and queued > 0
                and self.bridge.free_page_frac() < self.min_free_page_frac)

    def _adapter_gate(self, adapter_id: Optional[str]):
        """Pump-thread validation closure: resolve the routed tenant
        against bank residency / on-disk checkpoints; a veto string maps
        to 404 model_not_found."""
        sched = self.sched
        if adapter_id is None:
            return None

        def _check() -> Optional[str]:
            bank = sched.bank
            if bank is None:
                return "this deployment serves no adapters (no bank)"
            if adapter_id in bank.resident_ids:
                return None
            if bank.checkpoint_dir is not None:
                from repro_torch.checkpoint import adapters as adapter_ckpt
                if adapter_id in adapter_ckpt.list_adapters(
                        bank.checkpoint_dir):
                    return None
            return (f"model '{protocol.ADAPTER_PREFIX}{adapter_id}' is "
                    "neither resident nor checkpointed")
        return _check

    async def _handle_generate(self, kind, body, reader, writer) -> None:
        try:
            payload = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError):
            await self._respond_json(
                writer, 400, ApiError(400, "body is not valid JSON").body())
            return
        try:
            preq = protocol.parse_request(
                kind, payload, vocab=self.vocab, max_len=self.max_len,
                default_max_new=self.default_max_new,
                base_aliases=self.base_aliases)
        except ApiError as e:
            await self._respond_json(writer, e.status, e.body())
            return
        if self._overloaded(preq.priority):
            self.sched.metrics.on_reject()
            await self._respond_json(
                writer, 429,
                ApiError(429, "server is saturated; retry later",
                         err_type="rate_limit_error",
                         code="server_overloaded").body(),
                extra={"Retry-After": f"{self.retry_after_s:g}"})
            return
        request = Request(prompt=torch.tensor(preq.prompt,
                                              dtype=torch.int32),
                          max_new=preq.max_new, adapter_id=preq.adapter_id,
                          priority=preq.priority)
        try:
            handle = await self.bridge.submit(
                request, validate=self._adapter_gate(preq.adapter_id))
        except RuntimeError as e:
            await self._respond_json(
                writer, 404,
                ApiError(404, str(e), err_type="not_found_error",
                         code="model_not_found").body())
            return
        self._ids += 1
        rid = f"{'chatcmpl' if kind == 'chat' else 'cmpl'}-{self._ids}"
        created = int(time.time())
        if preq.stream:
            await self._stream_response(preq, rid, created, handle,
                                        reader, writer)
        else:
            await self._block_response(preq, rid, created, handle,
                                       reader, writer)

    async def _next_item(self, handle: RequestHandle, monitor,
                         deadline: Optional[float]):
        """Next stream item, or ("disconnect",)/("timeout",) sentinels."""
        get = asyncio.ensure_future(handle.queue.get())
        waits = {get, monitor}
        timeout = None
        if deadline is not None:
            timeout = max(deadline - time.monotonic(), 0.0)
        done, _ = await asyncio.wait(waits, timeout=timeout,
                                     return_when=asyncio.FIRST_COMPLETED)
        if get in done:
            return get.result()
        get.cancel()
        return ("disconnect",) if monitor in done else ("timeout",)

    def _deadline(self) -> Optional[float]:
        if self.request_timeout_s is None:
            return None
        return time.monotonic() + self.request_timeout_s

    async def _block_response(self, preq, rid, created, handle,
                              reader, writer) -> None:
        monitor = asyncio.ensure_future(reader.read())
        deadline = self._deadline()
        tokens, status, reason = [], 200, None
        try:
            while True:
                item = await self._next_item(handle, monitor, deadline)
                kind = item[0]
                if kind == "token":
                    tokens.append(item[1])
                elif kind == "done":
                    tokens = item[1]
                    reason = protocol.finish_reason(tokens, self.eos_id)
                    break
                elif kind == "cancelled":
                    reason, status = "cancelled", 500
                    break
                elif kind == "error":
                    await self._respond_json(
                        writer, 500,
                        ApiError(500, item[1], "server_error").body())
                    return
                elif kind == "disconnect":
                    self.bridge.cancel(handle)
                    return                     # nobody to answer
                elif kind == "timeout":
                    self.bridge.cancel(handle)
                    await self._respond_json(
                        writer, 504,
                        ApiError(504, "generation exceeded "
                                 f"{self.request_timeout_s:g}s",
                                 "timeout_error").body())
                    return
        finally:
            monitor.cancel()
        body = protocol.completion_body(preq, rid, created, tokens,
                                        reason or "length")
        await self._respond_json(writer, status, body)

    async def _stream_response(self, preq, rid, created, handle,
                               reader, writer) -> None:
        monitor = asyncio.ensure_future(reader.read())
        deadline = self._deadline()
        writer.write(self._head(200, "text/event-stream",
                                {"Cache-Control": "no-cache"}))
        first = True
        try:
            while True:
                item = await self._next_item(handle, monitor, deadline)
                kind = item[0]
                if kind == "token":
                    chunk = protocol.stream_chunk(preq, rid, created,
                                                  item[1], first)
                    first = False
                    writer.write(protocol.sse_event(chunk))
                    await writer.drain()
                elif kind == "done":
                    reason = protocol.finish_reason(item[1], self.eos_id)
                    writer.write(protocol.sse_event(protocol.stream_chunk(
                        preq, rid, created, None, first, reason)))
                    writer.write(protocol.sse_event("[DONE]"))
                    await writer.drain()
                    return
                elif kind in ("cancelled", "error"):
                    writer.write(protocol.sse_event(protocol.stream_chunk(
                        preq, rid, created, None, first,
                        "cancelled" if kind == "cancelled" else "error")))
                    writer.write(protocol.sse_event("[DONE]"))
                    await writer.drain()
                    return
                elif kind == "disconnect":
                    self.bridge.cancel(handle)
                    return
                elif kind == "timeout":
                    self.bridge.cancel(handle)
                    writer.write(protocol.sse_event(protocol.stream_chunk(
                        preq, rid, created, None, first, "timeout")))
                    writer.write(protocol.sse_event("[DONE]"))
                    await writer.drain()
                    return
        except (ConnectionError, OSError):
            self.bridge.cancel(handle)         # write failed: client gone
        finally:
            monitor.cancel()
