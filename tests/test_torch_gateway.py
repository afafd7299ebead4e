"""The port's OpenAI-compatible gateway and the scheduler's cancel path, on a
reduced yi-6b (vocab 64, f32, CPU).

Every case of tests/test_serve_gateway.py, run on the port:
- the wire protocol: validation (400/404), chat encoding, model routing,
  Prometheus text — and, against JAX's protocol module, the same parsed
  requests, encodings, response bodies and SSE frames for the same input;
- `ContinuousScheduler.cancel`: a queued request, an active one (slot and
  pages freed this step, the runtime still exact), a preempted one (its
  host snapshot dropped), and counters that survive `reset_metrics`;
- HTTP end to end: concurrent SSE streams over a fourierft+lora+base mix
  equal the in-process replay token for token (and JAX's scheduler on the
  same params), streams through a preempting scheduler equal the replay,
  a blocking JSON response equals its stream, a mid-stream disconnect
  leaks no slot, page or pin, a timeout answers 504, malformed requests
  400/404, /v1/models and /metrics (with the tiering counters and gauges);
- 429 under saturation, made deterministic: the pump is held inside a
  blocking `bridge.call` that queued one request, so the queue watermark
  is reached whatever the timing, and the retry after release succeeds;
- the `priority` extension and the interactive backpressure bypass, which
  holds only when the scheduler can preempt;
- the API launcher: `--export-demo-bank`, then `--port 0` boots on the CPU
  and serves the replay's streams; mesh flags are refused."""
import asyncio
import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as jax_configs
from repro.checkpoint import adapters as jax_ckpt
from repro.configs.base import PEFTConfig as JaxPEFT
from repro.core import adapter as jax_adapter_api
from repro.core import peft as jax_peft
from repro.models import build as jax_build
from repro.serve import AdapterBank as JaxBank
from repro.serve import ContinuousScheduler as JaxScheduler
from repro.serve import Engine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve.gateway import protocol as jax_protocol
from repro_torch import configs
from repro_torch.configs.base import PEFTConfig
from repro_torch.convert import from_jax_params
from repro_torch.launch import api as launch_api
from repro_torch.models import build
from repro_torch.serve import (
    AdapterBank, ContinuousScheduler, Engine, Request, TieringConfig,
)
from repro_torch.serve.gateway import GatewayServer, protocol
from repro_torch.serve.gateway.protocol import (
    ApiError, parse_request, prometheus_text, resolve_model,
)

ROOT = Path(__file__).resolve().parents[1]
TENANTS = ("t-fft", "t-lora")


def _cfgs():
    kw = dict(vocab=64, param_dtype="float32", dtype="float32")
    return (jax_configs.reduced(jax_configs.get("yi-6b")).replace(**kw),
            configs.reduced(configs.get("yi-6b")).replace(**kw))


@pytest.fixture(scope="module")
def world():
    """The JAX base model and params (method none), and their port copies."""
    jcfg, tcfg = _cfgs()
    jmodel = jax_build(jcfg, JaxPEFT(method="none"))
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    model = build(tcfg, PEFTConfig(method="none"))
    return jmodel, jparams, model, from_jax_params(jparams, "cpu")


def _profile_kw():
    return {"fourierft": dict(method="fourierft", n=16, alpha=25.0,
                              param_dtype="float32"),
            "lora": dict(method="lora", lora_r=2, param_dtype="float32")}


@pytest.fixture(scope="module")
def tenant_dir(world, tmp_path_factory):
    """The reference's two tenants, exported by the JAX package."""
    jmodel = world[0]
    directory = tmp_path_factory.mktemp("tenants")
    for i, (tid, m) in enumerate(zip(TENANTS, ("fourierft", "lora"))):
        prof = JaxPEFT(**_profile_kw()[m])
        tree = jax_peft.init_adapters(jax.random.PRNGKey(10 + i),
                                      jmodel.sites, prof)
        tree = jax.tree.map(
            lambda x: x + 0.05 if jnp.issubdtype(x.dtype, jnp.floating)
            else x, tree)
        trainable = set(jax_adapter_api.resolve(m).trainable_leaves(prof))
        tree = {s: {k: v for k, v in d.items() if k in trainable}
                for s, d in tree.items()}
        jax_ckpt.export_adapter(str(directory), tid, tree, prof)
    return str(directory)


def _bank(world, tenant_dir, capacity=4):
    return AdapterBank(world[2], {m: PEFTConfig(**kw)
                                  for m, kw in _profile_kw().items()},
                       capacity=capacity, checkpoint_dir=tenant_dir,
                       device="cpu")


def _engine(world, slots=2, max_len=48, bank=None):
    _, _, model, params = world
    return Engine(model, params, batch_slots=slots, max_len=max_len,
                  bank=bank, device="cpu")


def _server(world, *, slots=2, max_len=48, bank=None, tiering=None,
            pool=None, **kw):
    sched = ContinuousScheduler(_engine(world, slots, max_len, bank),
                                tiering=tiering, **(pool or {"page_size": 8}))
    return GatewayServer(sched, **kw)


def _req(prompt, max_new, adapter_id=None, priority="batch"):
    return Request(prompt=torch.tensor(prompt, dtype=torch.int32),
                   max_new=max_new, adapter_id=adapter_id, priority=priority)


# ---- stdlib test client ----------------------------------------------------
async def _raw(host, port, data: bytes):
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(data)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split()[1])
    headers = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(":")
        headers[k.strip().lower()] = v.strip()
    return status, headers, body


async def _post(host, port, path, payload):
    body = payload if isinstance(payload, bytes) \
        else json.dumps(payload).encode()
    return await _raw(host, port,
                      (f"POST {path} HTTP/1.1\r\nHost: t\r\n"
                       f"Content-Length: {len(body)}\r\n"
                       f"Connection: close\r\n\r\n").encode() + body)


async def _get(host, port, path):
    return await _raw(host, port, (f"GET {path} HTTP/1.1\r\nHost: t\r\n"
                                   "Connection: close\r\n\r\n").encode())


def _sse_parse(body: bytes):
    """SSE body -> (token ids, finish_reason, saw [DONE])."""
    tokens, finish, done = [], None, False
    for line in body.split(b"\n"):
        line = line.strip()
        if not line.startswith(b"data: "):
            continue
        data = line[len(b"data: "):]
        if data == b"[DONE]":
            done = True
            continue
        choice = json.loads(data)["choices"][0]
        if "token_id" in choice:
            tokens.append(int(choice["token_id"]))
        if choice.get("finish_reason") is not None:
            finish = choice["finish_reason"]
    return tokens, finish, done


def _completion(model, prompt, max_new, stream=True, **extra):
    return {"model": model, "prompt": prompt, "max_tokens": max_new,
            "stream": stream, **extra}


async def _drain_idle(server, timeout=20.0):
    """Wait until the scheduler has no active slots (pump-thread read)."""
    deadline = asyncio.get_event_loop().time() + timeout
    sched = server.sched
    while await server.bridge.call(lambda: sched.slots.any_active()):
        assert asyncio.get_event_loop().time() < deadline, "never drained"
        await asyncio.sleep(0.01)


# ---------------------------------------------------------------------------
# protocol units (no server)
# ---------------------------------------------------------------------------
class TestProtocol:
    def _parse(self, payload, kind="completion", module=protocol, **kw):
        kw.setdefault("vocab", 64)
        kw.setdefault("max_len", 48)
        kw.setdefault("default_max_new", 8)
        kw.setdefault("base_aliases", ())
        return module.parse_request(kind, payload, **kw)

    REJECTED = [
        ({"model": "base"}, 400),
        ({"model": "base", "prompt": []}, 400),
        ({"model": "base", "prompt": [1, 2], "n": 2}, 400),
        ({"model": "base", "prompt": [1, 999]}, 400),
        ({"model": "base", "prompt": [1, -2]}, 400),
        ({"model": "base", "prompt": [1.5]}, 400),
        ({"model": "base", "prompt": [1], "max_tokens": 0}, 400),
        ({"model": "base", "prompt": [1], "stream": "yes"}, 400),
        ({"model": "base", "prompt": list(range(1, 47)),
          "max_tokens": 30}, 400),
        ({"model": 7, "prompt": [1]}, 400),
        ({"model": "oops", "prompt": [1]}, 404),
        ({"model": "base", "prompt": [1], "priority": "urgent"}, 400),
    ]

    def test_validation_rejections(self):
        for payload, status in self.REJECTED:
            with pytest.raises(ApiError) as ei:
                self._parse(payload)
            assert ei.value.status == status, payload
            with pytest.raises(jax_protocol.ApiError) as ej:
                self._parse(payload, module=jax_protocol)
            assert ej.value.body() == ei.value.body(), payload

    def test_chat_needs_messages(self):
        with pytest.raises(ApiError):
            self._parse({"model": "base"}, kind="chat")
        preq = self._parse({"model": "base",
                            "messages": [{"role": "user", "content": "hi"}]},
                           kind="chat")
        assert preq.prompt and all(0 <= t < 64 for t in preq.prompt)

    def test_resolve_model(self):
        assert resolve_model("base") is None
        assert resolve_model("yi-6b-smoke", ("yi-6b-smoke",)) is None
        assert resolve_model("adapter:t0") == "t0"
        with pytest.raises(ApiError) as ei:
            resolve_model("gpt-4")
        assert ei.value.status == 404
        with pytest.raises(ApiError):
            resolve_model("adapter:")

    def test_prometheus_text(self):
        text = prometheus_text(
            {"requests_admitted_total": 3, "queue_depth": 1.0},
            labeled={"gateway_responses_total": {'code="200"': 4}})
        assert "# TYPE repro_requests_admitted_total counter" in text
        assert "# TYPE repro_queue_depth gauge" in text
        assert "repro_requests_admitted_total 3" in text
        assert 'repro_gateway_responses_total{code="200"} 4' in text

    @pytest.mark.parametrize("kind,payload", [
        ("completion", {"model": "adapter:t0", "prompt": "héllo",
                        "max_tokens": 3, "stream": True,
                        "priority": "interactive"}),
        ("completion", {"model": "base", "prompt": [5, 6, 7]}),
        ("chat", {"model": "yi-6b", "max_completion_tokens": 2,
                  "messages": [{"role": "system", "content": "be terse"},
                               {"role": "user", "content": "hi ✓"}]}),
    ])
    def test_dialect_equals_the_reference(self, kind, payload):
        """The same body parses to the same request, and the same tokens
        frame to the same JSON body, SSE chunks and metrics text, in both
        packages."""
        kw = dict(vocab=64, max_len=48, default_max_new=8,
                  base_aliases=("yi-6b",))
        mine = parse_request(kind, payload, **kw)
        ref = jax_protocol.parse_request(kind, payload, **kw)
        assert vars(mine) == vars(ref)
        toks = [72, 105, 3, 63]
        assert protocol.completion_body(mine, "x-1", 7, toks, "length") \
            == jax_protocol.completion_body(ref, "x-1", 7, toks, "length")
        for i, t in enumerate(toks + [None]):
            reason = "stop" if t is None else None
            assert protocol.sse_event(protocol.stream_chunk(
                mine, "x-1", 7, t, i == 0, reason)) \
                == jax_protocol.sse_event(jax_protocol.stream_chunk(
                    ref, "x-1", 7, t, i == 0, reason))
        assert protocol.sse_event("[DONE]") \
            == jax_protocol.sse_event("[DONE]")
        values = {"tokens_emitted_total": 9, "kv_pages_free": 3.5}
        assert protocol.prometheus_text(values) \
            == jax_protocol.prometheus_text(values)


# ---------------------------------------------------------------------------
# scheduler cancel path + cumulative counters (no HTTP)
# ---------------------------------------------------------------------------
class TestSchedulerCancel:
    def test_cancel_queued_request(self, world):
        sched = ContinuousScheduler(_engine(world, slots=1), page_size=8)
        r = _req([1, 2, 3], 4)
        rid = sched.submit(r)
        assert sched.cancel(rid) is True
        assert sched.cancel(rid) is False
        assert len(sched.queue) == 0
        assert r.out == []
        s = sched.metrics.summary()
        assert s["requests_cancelled_total"] == 1.0
        assert s["queue_depth"] == 0.0

    def test_cancel_active_frees_slot_and_pages(self, world):
        eng = _engine(world)
        sched = ContinuousScheduler(eng, page_size=8)
        long = _req([1, 2, 3, 4], 24)
        rid = sched.submit(long)
        for _ in range(6):
            sched.tick()
        assert sched.slots.any_active()
        assert sched.cancel(rid) is True
        assert not sched.slots.any_active()
        sched.pager.assert_no_leaks()
        assert 0 < len(long.out) < 24
        follow = _req([7, 8, 9], 5)
        sched.serve([follow])
        ref = eng.generate([follow.prompt], max_new=5)[0]
        assert follow.out == ref.tolist()
        sched.pager.assert_no_leaks()

    def test_cancel_preempted_request_drops_its_snapshot(self, world):
        """A request waiting to resume after a swap preemption is cancelled
        from the queue: its host snapshot goes with it, and the trace
        drains leak-free."""
        sched = ContinuousScheduler(
            _engine(world, slots=3),
            tiering=TieringConfig(mode="swap", host_kv_pages=32),
            page_size=8, n_pages=9)
        reqs = [_req([1, 2, 3, 4, 5], 20), _req([7, 8, 9], 18),
                _req([11, 12], 4, priority="interactive")]
        for r, at in zip(reqs, (0.0, 0.0, 3.0)):
            sched.submit(r, arrival=at)
        victim = None
        for _ in range(40):
            for ev in sched.tick():
                if ev[0] == "preempt":
                    victim = ev[1]
            if victim is not None:
                break
        assert victim is not None
        assert sched.host_kv.has_snapshot(victim)
        assert sched.cancel(victim) is True
        assert not sched.host_kv.has_snapshot(victim)
        for _ in sched.events():
            pass
        sched.pager.assert_no_leaks()
        assert not sched.host_kv._snapshots
        assert sched.metrics.summary()["requests_cancelled_total"] == 1.0

    def test_counters_survive_reset(self, world):
        sched = ContinuousScheduler(_engine(world), page_size=8)
        sched.serve([_req([1, 2], 3) for _ in range(2)])
        before = sched.metrics.summary()
        assert before["requests_finished_total"] == 2.0
        sched.reset_metrics()
        after = sched.metrics.summary()
        for k in ("requests_submitted_total", "requests_admitted_total",
                  "requests_finished_total", "tokens_emitted_total"):
            assert after[k] == before[k], k
        sched.serve([_req([5], 2)])
        assert sched.metrics.summary()["requests_finished_total"] == 3.0
        sched.submit(_req([5], 2))
        with pytest.raises(RuntimeError, match="in flight"):
            sched.reset_metrics()


# ---------------------------------------------------------------------------
# HTTP end-to-end
# ---------------------------------------------------------------------------
class TestGatewayHTTP:
    def test_streams_bit_identical_heterogeneous(self, world, tenant_dir):
        """Concurrent SSE streams over a fourierft+lora+base mix equal the
        in-process scheduler replay token for token, and JAX's scheduler's
        on the same params and tenants."""
        prompts = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12],
                   [3, 1, 4, 1, 5], [2, 7, 1, 8], [6, 6, 6]]
        models = ["adapter:t-fft", "adapter:t-lora", "base",
                  "adapter:t-fft", "adapter:t-lora", "base"]

        async def drive():
            server = _server(world, slots=3, bank=_bank(world, tenant_dir))
            await server.start()
            try:
                return await asyncio.gather(*(
                    _post(server.host, server.port, "/v1/completions",
                          _completion(m, p, 6))
                    for m, p in zip(models, prompts)))
            finally:
                await server.close()

        got = []
        for status, _, body in asyncio.run(drive()):
            assert status == 200
            tokens, finish, done = _sse_parse(body)
            assert done and finish == "length"
            got.append(tokens)
        reqs = [_req(p, 6, resolve_model(m)) for m, p in zip(models, prompts)]
        ContinuousScheduler(_engine(world, 3, bank=_bank(world, tenant_dir)),
                            page_size=8).serve(reqs)
        assert got == [r.out for r in reqs]
        jmodel, jparams = world[:2]
        jbank = JaxBank(jmodel, {m: JaxPEFT(**kw)
                                 for m, kw in _profile_kw().items()},
                        capacity=4, checkpoint_dir=tenant_dir)
        jreqs = [JaxRequest(prompt=jnp.asarray(p, jnp.int32), max_new=6,
                            adapter_id=resolve_model(m))
                 for m, p in zip(models, prompts)]
        JaxScheduler(JaxEngine(jmodel, jparams, batch_slots=3, max_len=48,
                               bank=jbank), page_size=8).serve(jreqs)
        assert got == [r.out for r in jreqs]

    def test_preempting_gateway_streams_equal_replay(self, world):
        """Two long `batch` streams own a constrained pool. Once they
        decode, the pump is held in a blocking `bridge.call` until two
        `interactive` submissions wait in its command queue, so they reach
        the scheduler together with the longs mid-stream and preempt them
        (swap). Every stream equals the in-process replay, and /metrics
        shows the preemptions and the host-tier gauges."""
        pool = dict(page_size=8, n_pages=9)
        tiering = TieringConfig(mode="swap", host_kv_pages=32)
        longs = [([1, 2, 3, 4, 5], 20), ([7, 8, 9], 18)]
        shorts = [([11, 12], 4), ([13, 12], 4)]

        async def drive():
            server = _server(world, slots=3, tiering=tiering, pool=pool)
            await server.start()
            host, port = server.host, server.port
            sched = server.sched
            try:
                first = [asyncio.ensure_future(_post(
                    host, port, "/v1/completions", _completion("base", p, n)))
                    for p, n in longs]
                while not await server.bridge.call(
                        lambda: sched.metrics.steps >= 3):
                    await asyncio.sleep(0.001)
                gate, entered = threading.Event(), threading.Event()

                def hold():
                    entered.set()
                    assert gate.wait(timeout=60), "the test never released"

                held = server.bridge.call(hold)
                while not entered.is_set():
                    await asyncio.sleep(0.001)
                second = [asyncio.ensure_future(_post(
                    host, port, "/v1/completions",
                    _completion("base", p, n, priority="interactive")))
                    for p, n in shorts]
                while server.bridge._cmds.qsize() < len(shorts):
                    await asyncio.sleep(0.001)
                gate.set()
                await held
                out = await asyncio.gather(*first, *second)
                await _drain_idle(server)
                await server.bridge.call(sched.pager.assert_no_leaks)
                _, _, metrics = await _get(host, port, "/metrics")
                return out, metrics.decode()
            finally:
                await server.close()

        out, metrics = asyncio.run(drive())
        got = [_sse_parse(body)[0] for status, _, body in out]
        assert all(status == 200 for status, _, _ in out)
        reqs = [_req(p, n) for p, n in longs + shorts]
        ContinuousScheduler(_engine(world, 3), page_size=8).serve(reqs)
        assert got == [r.out for r in reqs]
        values = dict(ln.rsplit(" ", 1) for ln in metrics.splitlines()
                      if ln and not ln.startswith("#") and "{" not in ln)
        assert float(values["repro_preemptions_total"]) >= 1
        assert float(values["repro_preempt_swap_total"]) >= 1
        assert float(values["repro_resumed_total"]) >= 1
        assert float(values["repro_host_kv_pages_capacity"]) == 32
        assert "repro_host_kv_pages_used" in values

    def test_blocking_json_matches_stream(self, world):
        async def drive():
            server = _server(world)
            await server.start()
            try:
                s1, _, b1 = await _post(server.host, server.port,
                                        "/v1/completions",
                                        _completion("base", [1, 2, 3], 5))
                s2, _, b2 = await _post(
                    server.host, server.port, "/v1/completions",
                    _completion("base", [1, 2, 3], 5, stream=False))
                return s1, b1, s2, b2
            finally:
                await server.close()

        s1, b1, s2, b2 = asyncio.run(drive())
        assert s1 == 200 and s2 == 200
        stream_tokens, _, _ = _sse_parse(b1)
        obj = json.loads(b2)
        choice = obj["choices"][0]
        assert choice["token_ids"] == stream_tokens
        assert choice["finish_reason"] == "length"
        assert obj["usage"]["completion_tokens"] == len(stream_tokens)

    def test_429_under_saturation_then_retry(self, world):
        """One slot + max_queue=1. The pump is held inside a blocking
        `bridge.call` that first queued one request on the pump thread, so
        the queue sits at the watermark whatever the timing: a request now
        bounces with 429 and Retry-After; once the pump is released and
        the backlog drains, the retry goes through."""
        gate = threading.Event()

        async def drive():
            server = _server(world, slots=1, max_queue=1, retry_after_s=0.25)
            await server.start()
            host, port = server.host, server.port
            sched = server.sched
            entered = threading.Event()

            def hold():
                sched.submit(_req([1, 2, 3], 8))
                entered.set()
                assert gate.wait(timeout=60), "the test never released"

            try:
                held = server.bridge.call(hold)
                while not entered.is_set():
                    await asyncio.sleep(0.001)
                status, headers, body = await _post(
                    host, port, "/v1/completions",
                    _completion("base", [6], 2, stream=False))
                gate.set()
                await held
                await _drain_idle(server)
                sc, _, retry = await _post(
                    host, port, "/v1/completions",
                    _completion("base", [6], 2, stream=False))
                metrics = await server.bridge.call(
                    lambda: sched.metrics.summary())
                return status, headers, body, sc, retry, metrics
            finally:
                gate.set()
                await server.close()

        status, headers, body, sc, retry, metrics = asyncio.run(drive())
        assert status == 429
        assert float(headers["retry-after"]) == 0.25
        assert json.loads(body)["error"]["code"] == "server_overloaded"
        assert sc == 200
        assert len(json.loads(retry)["choices"][0]["token_ids"]) == 2
        assert metrics["requests_rejected_total"] == 1.0
        assert metrics["requests_finished_total"] == 2.0

    def test_disconnect_mid_stream_leaks_nothing(self, world, tenant_dir):
        """Closing the socket mid-stream cancels the request: every slot
        returns to FREE, the page pool balances, the tenant's bank row
        unpins, and the next request is exact."""
        async def drive():
            server = _server(world, slots=2, bank=_bank(world, tenant_dir))
            await server.start()
            host, port = server.host, server.port
            try:
                reader, writer = await asyncio.open_connection(host, port)
                body = json.dumps(_completion(
                    "adapter:t-fft", [1, 2, 3, 4], 32)).encode()
                writer.write((f"POST /v1/completions HTTP/1.1\r\n"
                              f"Host: t\r\nContent-Length: {len(body)}\r\n"
                              f"Connection: close\r\n\r\n").encode() + body)
                await writer.drain()
                await reader.readuntil(b"\r\n\r\n")
                await reader.readuntil(b"\n\n")
                writer.close()
                await _drain_idle(server)
                sched = server.sched
                state = await server.bridge.call(lambda: (
                    sched.slots.active_slots(),
                    sched.slots.adapter_ids(),
                    sched.metrics.summary()["requests_cancelled_total"]))
                await server.bridge.call(sched.pager.assert_no_leaks)
                status, _, resp = await _post(
                    host, port, "/v1/completions",
                    _completion("adapter:t-lora", [7, 8, 9], 4,
                                stream=False))
                await server.bridge.call(sched.pager.assert_no_leaks)
                return state, status, json.loads(resp)
            finally:
                await server.close()

        (active, pins, cancelled), status, resp = asyncio.run(drive())
        assert active == [] and pins == [None, None]
        assert cancelled >= 1.0
        assert status == 200
        ref_eng = _engine(world, bank=_bank(world, tenant_dir))
        ref_eng.bank.load_from_checkpoint("t-lora")
        ref = ref_eng.generate([torch.tensor([7, 8, 9], dtype=torch.int32)],
                               max_new=4, adapter_ids=["t-lora"])[0]
        assert resp["choices"][0]["token_ids"] == ref.tolist()

    def test_request_timeout_504(self, world):
        async def drive():
            server = _server(world, request_timeout_s=1e-4)
            await server.start()
            try:
                status, _, body = await _post(
                    server.host, server.port, "/v1/completions",
                    _completion("base", [1, 2, 3], 16, stream=False))
                await _drain_idle(server)
                await server.bridge.call(server.sched.pager.assert_no_leaks)
                return status, body
            finally:
                await server.close()

        status, body = asyncio.run(drive())
        assert status == 504
        assert json.loads(body)["error"]["type"] == "timeout_error"

    def test_malformed_requests(self, world):
        async def drive():
            server = _server(world)
            await server.start()
            host, port = server.host, server.port
            try:
                return [
                    await _post(host, port, "/v1/completions",
                                b"{not json"),
                    await _post(host, port, "/v1/completions",
                                {"model": "base"}),
                    await _post(host, port, "/v1/completions",
                                {"model": "base", "prompt": [1], "n": 2}),
                    await _post(host, port, "/v1/completions",
                                {"model": "base", "prompt": [999]}),
                    await _post(host, port, "/v1/completions",
                                {"model": "base",
                                 "prompt": list(range(1, 50)),
                                 "max_tokens": 16}),
                    await _post(host, port, "/v1/completions",
                                {"model": "gpt-4", "prompt": [1]}),
                    await _post(host, port, "/v1/completions",
                                {"model": "adapter:ghost", "prompt": [1]}),
                    await _get(host, port, "/nope"),
                ]
            finally:
                await server.close()

        results = asyncio.run(drive())
        statuses = [r[0] for r in results]
        assert statuses == [400, 400, 400, 400, 400, 404, 404, 404]
        for status, _, body in results[:5]:
            assert json.loads(body)["error"]["type"] \
                == "invalid_request_error"

    def test_models_and_metrics_endpoints(self, world, tenant_dir):
        async def drive():
            bank = _bank(world, tenant_dir)
            bank.load_from_checkpoint("t-fft")
            server = _server(world, bank=bank,
                             tiering=TieringConfig(host_kv_pages=4,
                                                   host_adapter_slots=2))
            await server.start()
            host, port = server.host, server.port
            try:
                await _post(host, port, "/v1/chat/completions",
                            {"model": "base", "stream": False,
                             "messages": [{"role": "user",
                                           "content": "hi"}],
                             "max_tokens": 3})
                ms, _, mbody = await _get(host, port, "/v1/models")
                ps, _, pbody = await _get(host, port, "/metrics")
                hs, _, _ = await _get(host, port, "/healthz")
                return ms, mbody, ps, pbody, hs
            finally:
                await server.close()

        ms, mbody, ps, pbody, hs = asyncio.run(drive())
        assert (ms, ps, hs) == (200, 200, 200)
        ids = [m["id"] for m in json.loads(mbody)["data"]]
        assert "base" in ids and "adapter:t-fft" in ids
        text = pbody.decode()
        assert "# TYPE repro_requests_admitted_total counter" in text
        assert "repro_requests_admitted_total 1" in text
        assert "repro_requests_finished_total 1" in text
        assert "repro_gateway_page_free_frac" in text
        assert 'repro_gateway_responses_total{code="200"}' in text
        assert "# TYPE repro_preemptions_total counter" in text
        assert "repro_host_kv_pages_capacity 4" in text
        assert "repro_host_adapter_capacity 2" in text
        assert "repro_bank_resident_adapters 1" in text


# ---- the priority extension -------------------------------------------------
class TestGatewayPriority:
    def test_parse_request_priority_field(self):
        ok = parse_request("completion",
                           {"model": "base", "prompt": [1, 2],
                            "priority": "interactive"},
                           vocab=64, max_len=64)
        assert ok.priority == "interactive"
        default = parse_request("completion",
                                {"model": "base", "prompt": [1, 2]},
                                vocab=64, max_len=64)
        assert default.priority == "batch"
        with pytest.raises(ApiError, match="priority"):
            parse_request("completion",
                          {"model": "base", "prompt": [1], "priority": "x"},
                          vocab=64, max_len=64)

    def test_interactive_bypass_requires_preemption(self, world):
        """`priority` is client-supplied: the interactive page-frac bypass
        holds only when the scheduler can actually preempt."""
        eng = _engine(world, slots=2, max_len=32)
        for tiering, bypass in ((None, False),
                                (TieringConfig(preempt=False), False),
                                (TieringConfig(host_kv_pages=4), True)):
            sched = ContinuousScheduler(eng, page_size=8, tiering=tiering)
            gw = GatewayServer(sched, min_free_page_frac=0.5)
            assert gw.bridge.preempting() is bypass
            gw.bridge.queued = lambda: 1
            gw.bridge.free_page_frac = lambda: 0.0
            assert gw._overloaded("batch")
            assert gw._overloaded("best_effort")
            assert gw._overloaded("interactive") is not bypass


# ---- the API launcher -------------------------------------------------------
def test_api_launcher_boots_and_serves_the_replay(tmp_path):
    """`--export-demo-bank` writes the demo tenants; `--port 0 --device cpu`
    boots the gateway over them in its own process, and a stream routed to
    `adapter:t0` equals the in-process replay of a scheduler built from
    the same flags (`build_scheduler`). SIGTERM shuts it down."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    flags = ["--arch", "yi-6b", "--reduced", "--device", "cpu",
             "--max-len", "64", "--slots", "2"]
    demo = str(tmp_path / "demo")
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.api", *flags,
         "--export-demo-bank", demo], env=env, capture_output=True,
        text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert "('t0', 't1')" in done.stdout
    flags += ["--bank-dir", demo, "--preempt", "--host-kv-pages", "8"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.api", *flags,
         "--port", "0"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "gateway listening on http://127.0.0.1:" in line, \
            line + proc.stderr.read()
        port = int(line.split("127.0.0.1:")[1].split()[0])
        status, _, body = asyncio.run(_post(
            "127.0.0.1", port, "/v1/completions",
            _completion("adapter:t0", [1, 2, 3], 5)))
        assert status == 200
        tokens, finish, done_ = _sse_parse(body)
        assert done_ and finish == "length"
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err
    assert "gateway shutting down" in out
    ap = launch_api.argparse.ArgumentParser()
    launch_api.add_model_args(ap)
    sched, tenants = launch_api.build_scheduler(ap.parse_args(flags))
    assert tenants == ["t0", "t1"] and sched.tiering.preempt
    req = _req([1, 2, 3], 5, adapter_id="t0")
    sched.serve([req])
    assert tokens == req.out


def test_api_launcher_refuses_mesh_flags(monkeypatch):
    """The mesh flags route through the mesh path: a searched plan serves
    at world size 1 (with no process group the mesh is the one device:
    nothing is placed, so no plan is resolved), a model axis wider than
    the ranks is refused (as the JAX launcher's make_host_mesh refuses
    it). More ranks than one serve: see
    test_api_launcher_across_two_ranks_streams_the_replay."""
    ap = launch_api.argparse.ArgumentParser()
    launch_api.add_model_args(ap)
    base = ["--arch", "yi-6b", "--reduced", "--device", "cpu"]
    runs = {}
    for plan in ("rules", "search"):
        sched, _ = launch_api.build_scheduler(
            ap.parse_args(base + ["--sharding-plan", plan]))
        assert sched.engine.mesh is None
        assert sched.engine.plan_source.kind == "rules"
        req = _req([1, 2, 3], 5)
        sched.serve([req])
        runs[plan] = req.out
    assert len(runs["search"]) == 5 and runs["search"] == runs["rules"]
    with pytest.raises(ValueError, match="does not divide"):
        launch_api.main(base + ["--port", "0", "--model-parallel", "2"])


def test_api_launcher_across_two_ranks_streams_the_replay(tmp_path):
    """`torchrun --nproc-per-node 2 -m repro_torch.launch.api` on gloo CPU
    ranks (a 1x2 model-parallel mesh, the demo bank): rank 0 serves, its
    pump broadcasts each round's submissions and cancellations and rank 1
    follows. A client that disconnects mid-stream is cancelled on both
    ranks (the next streams stay the replay's, which they could not if the
    ranks' schedulers parted), the HTTP streams equal the in-process
    replay of a scheduler from the same flags, and a SIGTERM to rank 0
    stops both ranks (torchrun exits 0)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    flags = ["--arch", "yi-6b", "--reduced", "--device", "cpu",
             "--max-len", "64", "--slots", "2", "--dtype", "float32"]
    demo = str(tmp_path / "demo")
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.api", *flags,
         "--export-demo-bank", demo], env=env, capture_output=True,
        text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    flags += ["--bank-dir", demo]
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.api", *flags,
         "--model-parallel", "2", "--port", "0"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT))
    asks = [("adapter:t0", [1, 2, 3], 5), ("base", [4, 5, 6, 7], 6),
            ("adapter:t1", [2, 9], 4)]
    try:
        line = proc.stdout.readline()
        assert "gateway listening on http://127.0.0.1:" in line \
            and "2 ranks" in line, line + proc.stderr.read()
        port = int(line.split("127.0.0.1:")[1].split()[0])
        pid = int(line.split("pid ")[1].split(")")[0])

        async def disconnect():
            body = json.dumps(_completion("adapter:t1", [3, 3, 3], 40))
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           port)
            writer.write((f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                          f"Content-Length: {len(body)}\r\n\r\n"
                          + body).encode())
            await writer.drain()
            await reader.readuntil(b"data: ")      # one token in: leave
            writer.close()

        asyncio.run(disconnect())
        streams = []
        for model, prompt, n in asks:
            status, _, body = asyncio.run(_post(
                "127.0.0.1", port, "/v1/completions",
                _completion(model, prompt, n)))
            assert status == 200
            tokens, finish, done_ = _sse_parse(body)
            assert done_ and finish == "length"
            streams.append(tokens)
        os.kill(pid, signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    assert out.count("gateway shutting down") == 1
    ap = launch_api.argparse.ArgumentParser()
    launch_api.add_model_args(ap)
    sched, _ = launch_api.build_scheduler(ap.parse_args(flags))
    want = []
    for model, prompt, n in asks:
        req = _req(prompt, n, adapter_id=None if model == "base"
                   else model.split(":")[1])
        sched.serve([req])
        want.append(req.out)
    assert streams == want
