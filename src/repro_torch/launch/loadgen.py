"""Open-loop asyncio load generator for the port's serving gateway
(`python -m repro_torch.launch.loadgen`; the JAX package's
`benchmarks/loadgen.py`, whose flags, traffic and report it keeps).

Fires `--n` token-id completion requests at a running gateway with
Poisson arrivals at `--rate` req/s (open loop: the arrival process never
waits for responses, so queueing delay shows up in the latency tail
instead of throttling the offered load). Traffic mixes:

  - tenant skew: requests route to `--models` (comma list, e.g.
    ``base,adapter:t0,adapter:t1``) under a Zipf law over list order —
    `--zipf-a 0` is uniform, larger is more skewed;
  - shared prefixes: with probability `--shared-frac` a request reuses
    its model's deterministic common prefix (per-tenant, so prefix-cache
    hits stay tenant-isolated) followed by a short random tail; the rest
    are fully random prompts of the same total length.

Per request it records latency, TTFT and inter-token gaps from the SSE
stream (or the blocking JSON response with `--no-stream`), honours 429
Retry-After backpressure with bounded retries, and prints nearest-rank
percentiles. `--out` dumps per-request results as JSON; nothing else is
written.

The payloads are numpy draws (`make_traffic`), so the same flags and
`--traffic-seed` give the JAX script's requests byte for byte. The
summary has the JAX script's keys and `throttled_429`, the 429 answers
the gateway sent (each one retried after its Retry-After).

`--verify` is the gateway's exactness check: it rebuilds the identical
engine in-process from the same model flags
(`repro_torch.launch.api.build_scheduler` — pass the server's
--arch/--reduced/--seed/--device/... here too), replays the collected
traffic through `ContinuousScheduler.serve`, and exits 1 unless every
gateway stream is bit-identical to the replay. The replay runs on the
card unless `--device` says otherwise.

Typical run against a small server on the CPU (drop `--device cpu` from
both on the card):

    PYTHONPATH=src python -m repro_torch.launch.api --arch yi-6b \\
        --reduced --export-demo-bank /tmp/bank --device cpu
    PYTHONPATH=src python -m repro_torch.launch.api --arch yi-6b \\
        --reduced --bank-dir /tmp/bank --port 8080 --device cpu &
    PYTHONPATH=src python -m repro_torch.launch.loadgen --port 8080 \\
        --n 64 --rate 16 --models base,adapter:t0 --shared-frac 0.9 \\
        --verify --arch yi-6b --reduced --bank-dir /tmp/bank --device cpu
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

_RETRYABLE = (ConnectionError, asyncio.IncompleteReadError, OSError)


@dataclass
class ReqResult:
    """One request's outcome (tokens are the bit-exactness payload)."""
    payload: Dict
    ok: bool = False
    status: int = 0
    tokens: List[int] = field(default_factory=list)
    finish: Optional[str] = None
    ttft_s: float = float("nan")
    latency_s: float = float("nan")
    itl_s: List[float] = field(default_factory=list)
    retries: int = 0                   # 429/connection retries consumed
    throttled: int = 0                 # 429 answers among them
    error: Optional[str] = None


# ---- traffic ---------------------------------------------------------------
def shared_prefix(model: str, prefix_len: int, vocab: int,
                  seed: int) -> List[int]:
    """The model's deterministic common prefix — same flags, same prefix,
    on both the loadgen and any verifier that wants to precompute it."""
    rng = np.random.default_rng([seed, zlib.crc32(model.encode())])
    return [int(t) for t in rng.integers(1, vocab, size=prefix_len)]


def parse_priority_mix(spec: str) -> (List[str], List[float]):
    """`"interactive:1,batch:2"` -> (classes, normalized weights).
    A bare class name means weight 1."""
    classes, weights = [], []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        classes.append(name)
        weights.append(float(w) if w else 1.0)
    total = sum(weights)
    return classes, [w / total for w in weights]


def make_traffic(*, n: int, vocab: int, models: List[str], zipf_a: float,
                 shared_frac: float, prefix_len: int, tail_len: int,
                 max_new: int, stream: bool, seed: int,
                 priorities: Optional[str] = None) -> List[Dict]:
    """`n` /v1/completions payloads; deterministic in the arguments.
    `priorities` ("cls:weight,..." — see parse_priority_mix) samples a
    tiering class per request and sets the `priority` payload extension."""
    rng = np.random.default_rng(seed)
    w = 1.0 / (np.arange(1, len(models) + 1) ** max(zipf_a, 0.0))
    w /= w.sum()
    prefixes = {m: shared_prefix(m, prefix_len, vocab, seed) for m in models}
    cls_names, cls_w = (parse_priority_mix(priorities)
                        if priorities else ([], []))
    payloads = []
    for _ in range(n):
        model = models[int(rng.choice(len(models), p=w))]
        tail = [int(t) for t in rng.integers(1, vocab, size=tail_len)]
        if rng.random() < shared_frac:
            prompt = prefixes[model] + tail
        else:
            prompt = [int(t) for t in
                      rng.integers(1, vocab, size=prefix_len)] + tail
        payload = {"model": model, "prompt": prompt,
                   "max_tokens": max_new, "stream": stream}
        if cls_names:
            payload["priority"] = \
                cls_names[int(rng.choice(len(cls_names), p=cls_w))]
        payloads.append(payload)
    return payloads


# ---- stdlib HTTP client ----------------------------------------------------
async def _once(host: str, port: int, payload: Dict,
                res: ReqResult) -> Optional[float]:
    """One HTTP attempt. Fills `res`; returns a Retry-After delay when the
    server answered 429 (the caller backs off and retries)."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        body = json.dumps(payload).encode("utf-8")
        writer.write((f"POST /v1/completions HTTP/1.1\r\nHost: {host}\r\n"
                      f"Content-Type: application/json\r\n"
                      f"Content-Length: {len(body)}\r\n"
                      f"Connection: close\r\n\r\n").encode("latin-1") + body)
        t_send = time.perf_counter()
        await writer.drain()
        head = await reader.readuntil(b"\r\n\r\n")
        head_lines = head.decode("latin-1").split("\r\n")
        res.status = int(head_lines[0].split()[1])
        headers = {}
        for ln in head_lines[1:]:
            k, _, v = ln.partition(":")
            headers[k.strip().lower()] = v.strip()
        if res.status == 429:
            await reader.read()                # drain the error body
            return float(headers.get("retry-after", "0.1"))
        if res.status != 200:
            res.error = (await reader.read()).decode("utf-8",
                                                     "replace")[:200]
            return None
        if payload.get("stream"):
            await _read_sse(reader, t_send, res)
        else:
            obj = json.loads(await reader.read())
            choice = obj["choices"][0]
            res.tokens = [int(t) for t in choice["token_ids"]]
            res.finish = choice.get("finish_reason")
            res.latency_s = time.perf_counter() - t_send
            res.ttft_s = res.latency_s         # no stream: first=last byte
        res.ok = res.finish in ("stop", "length")
        if not res.ok and res.error is None:
            res.error = f"finish_reason={res.finish!r}"
        return None
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass


async def _read_sse(reader: asyncio.StreamReader, t_send: float,
                    res: ReqResult) -> None:
    """Consume `data:` frames until [DONE], timestamping token chunks."""
    t_prev = None
    while True:
        line = await reader.readline()
        if not line:
            res.error = "stream closed before [DONE]"
            return
        line = line.strip()
        if not line.startswith(b"data: "):
            continue
        data = line[len(b"data: "):]
        if data == b"[DONE]":
            res.latency_s = time.perf_counter() - t_send
            return
        choice = json.loads(data)["choices"][0]
        if "token_id" in choice:
            now = time.perf_counter()
            if t_prev is None:
                res.ttft_s = now - t_send
            else:
                res.itl_s.append(now - t_prev)
            t_prev = now
            res.tokens.append(int(choice["token_id"]))
        if choice.get("finish_reason") is not None:
            res.finish = choice["finish_reason"]


async def send_request(host: str, port: int, payload: Dict, *,
                       retries: int = 8, retry_cap_s: float = 2.0,
                       timeout_s: float = 120.0) -> ReqResult:
    """POST with bounded 429/connection retries (honours Retry-After)."""
    res = ReqResult(payload=payload)
    for _ in range(retries + 1):
        try:
            backoff = await asyncio.wait_for(_once(host, port, payload, res),
                                             timeout_s)
        except asyncio.TimeoutError:
            res.error = f"client timeout after {timeout_s:g}s"
            return res
        except _RETRYABLE as e:
            res.retries += 1
            res.error = f"{type(e).__name__}: {e}"
            await asyncio.sleep(0.2)
            continue
        if backoff is None:
            return res
        res.retries += 1
        res.throttled += 1
        res.error = "429 retries exhausted"
        await asyncio.sleep(min(backoff, retry_cap_s))
    return res


async def run_open_loop(host: str, port: int, payloads: List[Dict], *,
                        rate: float, seed: int, retries: int,
                        timeout_s: float) -> (List[ReqResult], float):
    """Poisson open loop: arrival times are drawn up front and every
    request fires at its slot regardless of how the server is doing."""
    rng = np.random.default_rng(seed + 0x9E3779B9)
    if rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / rate,
                                             size=len(payloads)))
    else:
        arrivals = np.zeros(len(payloads))     # burst: all at once
    t0 = time.perf_counter()

    async def fire(i: int, payload: Dict) -> ReqResult:
        delay = arrivals[i] - (time.perf_counter() - t0)
        if delay > 0:
            await asyncio.sleep(float(delay))
        return await send_request(host, port, payload, retries=retries,
                                  timeout_s=timeout_s)

    results = list(await asyncio.gather(
        *(fire(i, p) for i, p in enumerate(payloads))))
    return results, time.perf_counter() - t0


async def wait_ready(host: str, port: int, wait_s: float) -> bool:
    """Poll /healthz until the gateway answers (server boot races)."""
    deadline = time.monotonic() + wait_s
    while True:
        try:
            reader, writer = await asyncio.open_connection(host, port)
            writer.write((f"GET /healthz HTTP/1.1\r\nHost: {host}\r\n"
                          "Connection: close\r\n\r\n").encode("latin-1"))
            await writer.drain()
            head = await reader.readuntil(b"\r\n\r\n")
            await reader.read()
            writer.close()
            if b" 200 " in head.split(b"\r\n", 1)[0]:
                return True
        except _RETRYABLE:
            pass
        if time.monotonic() >= deadline:
            return False
        await asyncio.sleep(0.25)


# ---- reporting -------------------------------------------------------------
def slo_attainment(results: List[ReqResult], slo_ttft_ms: Optional[float],
                   slo_itl_ms: Optional[float]) -> Dict[str, Dict]:
    """Per-priority-class SLO attainment: the fraction of each class's
    requests whose TTFT (and p99 inter-token gap) landed inside the SLO.
    A failed request counts as missed — dropping traffic never helps the
    attainment number."""
    import math

    from repro_torch.serve.scheduler.metrics import nearest_rank

    by_cls: Dict[str, List[ReqResult]] = {}
    for r in results:
        by_cls.setdefault(r.payload.get("priority", "batch"), []).append(r)
    out: Dict[str, Dict] = {}
    for cls, rs in sorted(by_cls.items()):
        met = 0
        for r in rs:
            good = r.ok
            if good and slo_ttft_ms is not None:
                good = (not math.isnan(r.ttft_s)
                        and r.ttft_s * 1e3 <= slo_ttft_ms)
            if good and slo_itl_ms is not None and r.itl_s:
                good = nearest_rank(sorted(r.itl_s), 0.99) * 1e3 \
                    <= slo_itl_ms
            met += bool(good)
        out[cls] = {"n": len(rs), "attained": met / len(rs)}
    return out


def summarize(results: List[ReqResult], wall_s: float,
              slo_ttft_ms: Optional[float] = None,
              slo_itl_ms: Optional[float] = None) -> Dict:
    from repro_torch.serve.scheduler.metrics import nearest_rank

    ok = [r for r in results if r.ok]
    lat = sorted(r.latency_s for r in ok)
    ttft = sorted(r.ttft_s for r in ok)
    itl = sorted(g for r in ok for g in r.itl_s)
    toks = sum(len(r.tokens) for r in ok)
    by_model: Dict[str, int] = {}
    for r in results:
        m = r.payload["model"]
        by_model[m] = by_model.get(m, 0) + 1
    out = {
        "n": len(results), "ok": len(ok), "failed": len(results) - len(ok),
        "retries": sum(r.retries for r in results),
        "throttled_429": sum(r.throttled for r in results),
        "wall_s": wall_s, "tok_s": toks / max(wall_s, 1e-9),
        "latency_p50_ms": nearest_rank(lat, 0.50) * 1e3,
        "latency_p99_ms": nearest_rank(lat, 0.99) * 1e3,
        "ttft_p50_ms": nearest_rank(ttft, 0.50) * 1e3,
        "ttft_p99_ms": nearest_rank(ttft, 0.99) * 1e3,
        "itl_p50_ms": nearest_rank(itl, 0.50) * 1e3,
        "itl_p99_ms": nearest_rank(itl, 0.99) * 1e3,
        "by_model": by_model,
    }
    if slo_ttft_ms is not None or slo_itl_ms is not None:
        out["slo"] = {"ttft_ms": slo_ttft_ms, "itl_ms": slo_itl_ms,
                      "by_class": slo_attainment(results, slo_ttft_ms,
                                                 slo_itl_ms)}
    return out


# ---- verification ----------------------------------------------------------
def verify_replay(results: List[ReqResult], args) -> int:
    """Rebuild the engine from the model flags and replay every completed
    request in-process; returns the stream-mismatch count."""
    import torch

    from repro_torch.launch.api import build_scheduler
    from repro_torch.serve.engine import Request
    from repro_torch.serve.gateway.protocol import resolve_model

    ok = [r for r in results if r.ok]
    if not ok:
        print("verify: no completed requests to replay")
        return 0
    sched, _ = build_scheduler(args)
    reqs = [Request(prompt=torch.tensor(r.payload["prompt"],
                                        dtype=torch.int32),
                    max_new=int(r.payload["max_tokens"]),
                    adapter_id=resolve_model(r.payload["model"]),
                    priority=r.payload.get("priority", "batch"))
            for r in ok]
    sched.serve(reqs)
    mismatches = 0
    for r, req in zip(ok, reqs):
        expect = [int(t) for t in req.out]
        if expect != r.tokens:
            mismatches += 1
            if mismatches <= 5:
                print(f"verify MISMATCH model={r.payload['model']} "
                      f"gateway={r.tokens} replay={expect}")
    print(f"verify: {len(ok)} streams replayed, {mismatches} mismatches")
    return mismatches


# ---- CLI -------------------------------------------------------------------
def main(argv=None) -> None:
    from repro_torch.launch.api import add_model_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--rate", type=float, default=8.0,
                    help="mean Poisson arrival rate, req/s (0 = one burst)")
    ap.add_argument("--models", default="base",
                    help="comma list routed under a Zipf law over order, "
                         "e.g. base,adapter:t0,adapter:t1")
    ap.add_argument("--zipf-a", type=float, default=1.2,
                    help="tenant-skew exponent (0 = uniform)")
    ap.add_argument("--shared-frac", type=float, default=0.0,
                    help="fraction of requests reusing the per-model "
                         "shared prefix")
    ap.add_argument("--prefix-len", type=int, default=32)
    ap.add_argument("--tail-len", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=512,
                    help="token-id space for synthetic prompts; must not "
                         "exceed the server's vocab")
    ap.add_argument("--priorities", default=None,
                    help="tiering-class mix 'cls[:weight],...', e.g. "
                         "interactive:1,batch:2,best_effort:1 — sets the "
                         "'priority' payload extension per request")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="TTFT SLO: report per-class attainment against it")
    ap.add_argument("--slo-itl-ms", type=float, default=None,
                    help="p99 inter-token-gap SLO, per request")
    ap.add_argument("--no-stream", action="store_true",
                    help="blocking JSON instead of SSE (no TTFT/ITL split)")
    ap.add_argument("--traffic-seed", type=int, default=0)
    ap.add_argument("--retries", type=int, default=8,
                    help="max 429/connection retries per request")
    ap.add_argument("--client-timeout", type=float, default=120.0)
    ap.add_argument("--wait-s", type=float, default=0.0,
                    help="poll /healthz up to this long before starting")
    ap.add_argument("--out", default=None,
                    help="write per-request results JSON here")
    ap.add_argument("--verify", action="store_true",
                    help="replay traffic in-process (build_scheduler on "
                         "the model flags below) and require bit-identical "
                         "streams")
    add_model_args(ap)          # --arch/--reduced/--device/... for --verify
    args = ap.parse_args(argv)

    models = [m.strip() for m in args.models.split(",") if m.strip()]
    payloads = make_traffic(
        n=args.n, vocab=args.vocab, models=models, zipf_a=args.zipf_a,
        shared_frac=args.shared_frac, prefix_len=args.prefix_len,
        tail_len=args.tail_len, max_new=args.max_new,
        stream=not args.no_stream, seed=args.traffic_seed,
        priorities=args.priorities)

    async def _go():
        if args.wait_s and not await wait_ready(args.host, args.port,
                                                args.wait_s):
            raise SystemExit(f"gateway at {args.host}:{args.port} not "
                             f"ready after {args.wait_s:g}s")
        return await run_open_loop(
            args.host, args.port, payloads, rate=args.rate,
            seed=args.traffic_seed, retries=args.retries,
            timeout_s=args.client_timeout)

    results, wall_s = asyncio.run(_go())
    summary = summarize(results, wall_s, slo_ttft_ms=args.slo_ttft_ms,
                        slo_itl_ms=args.slo_itl_ms)
    print(json.dumps(summary, indent=2, sort_keys=True))
    for r in results:
        if not r.ok:
            print(f"FAILED status={r.status} error={r.error}",
                  file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary,
                       "results": [vars(r) for r in results]}, f, indent=2)
    bad = summary["failed"]
    if args.verify:
        bad += verify_replay(results, args)
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
