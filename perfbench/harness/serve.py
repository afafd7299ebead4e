"""The serving driver: the measured program's `ContinuousScheduler` over an
`Engine` whose `AdapterBank` holds every tenant's FourierFT adapter
unmerged over one base, driven in process on the wall clock by an open
loop.

Each request is submitted when it is due (or as soon after as the loop
gets to it: that lateness is the sender's lag) and timed from when it was
due. Every `tick()` admits what it can, primes it (the prefill that gives
the first token) and runs one decode round over all slots; the tokens a
tick hands back are stamped when it returns. The window closes to new
arrivals at `--seconds`; requests still in flight are drained after it
and count toward the tails, not toward the window's tokens.

After the drain the program's state is freed and the reference scores a
sample of the finished requests, drawn from the seed with the longest
among them.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from harness import checks, inputs, modelcfg
from harness.record import Run, quantile
from harness.device import empty_cache, max_memory, reset_peak, sync


@dataclass
class Track:
    """One request as the harness sees it."""
    req: inputs.ServeRequest
    submit: Optional[float] = None
    stamps: List[float] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    error: Optional[str] = None


def tenant_id(t: Optional[int]) -> Optional[str]:
    return None if t is None else f"tenant{t}"


def build(ctx):
    """(scheduler, tenant coefficients) for the cell."""
    from repro_torch.models import build as build_model
    from repro_torch.configs.base import PEFTConfig
    from repro_torch.serve import AdapterBank, ContinuousScheduler, Engine

    cfg, mix, dev = ctx.cell.cfg, ctx.cell.mix, ctx.device
    fam = ctx.cell.family
    model = build_model(fam.model_config(cfg), PEFTConfig(method="none"))
    layout = fam.base_layout(cfg)
    checks.layout_matches(model, layout)
    base = inputs.make_base(layout, ctx.seed, dev)
    prof = modelcfg.peft_config(cfg)
    bank = AdapterBank(model, {prof.method: prof},
                       capacity=mix["bank_capacity"], device=dev)
    sites = fam.adapted_sites(cfg)
    coeffs = inputs.make_coeffs(sites, prof.n, ctx.seed, dev,
                                tenants=mix["tenants"])
    for t in range(mix["tenants"]):
        bank.load(tenant_id(t), {s: {"c": c[t]} for s, c in coeffs.items()},
                  prof)
    engine = Engine(model, {"base": base, "peft": {}},
                    batch_slots=mix["slots"], max_len=mix["max_len"],
                    bank=bank, device=dev)
    sched = ContinuousScheduler(engine, paged=True,
                                page_size=mix["page_size"])
    if "altered_token" in ctx.faults:
        decode = sched.model.decode_step
        vocab = cfg["vocab_size"]

        def altered(*a, **k):
            nt, cache = decode(*a, **k)
            return (nt + 1) % vocab, cache
        sched.model.decode_step = altered
    return sched, base, coeffs


def warm(sched, ctx) -> None:
    """One request at each prompt bucket the traffic uses, to completion:
    every prefill shape and the decode round run once before the window."""
    import torch
    from repro_torch.serve import Request
    rng = np.random.default_rng(inputs.subseed(ctx.seed, "warm"))
    for n in ctx.cell.mix["warm_prompts"]:
        p = rng.integers(0, ctx.cell.cfg["vocab_size"], size=n)
        sched.submit(Request(prompt=torch.as_tensor(p, dtype=torch.int32),
                             max_new=ctx.cell.mix["warm_new"],
                             adapter_id=tenant_id(0)), arrival=sched.t)
    while len(sched.queue) or sched.slots.any_active():
        sched.tick()
    sync(ctx.device)
    sched.reset_metrics()


def run(ctx, rate: Optional[float] = None, prepared=None) -> Dict:
    """One window (at the mix's rate unless `rate` is given). `prepared`:
    a (scheduler, base, coefficients) from an earlier `build` + `warm` of
    this process, to run several windows after one set-up (the sweep)."""
    import torch
    from repro_torch.serve import Request

    cfg, mix, dev = ctx.cell.cfg, ctx.cell.mix, ctx.device
    if prepared is None:
        sched, base, coeffs = build(ctx)
        warm(sched, ctx)
    else:
        sched, base, coeffs = prepared
    reqs = inputs.serve_traffic(mix, ctx.seconds, ctx.seed, cfg["vocab_size"],
                                rate=rate)
    tracks = [Track(r) for r in reqs]
    by_rid: Dict[int, Track] = {}
    slot_pos: Dict[int, int] = {}
    peak_setup = max_memory(dev)
    reset_peak(dev)
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"set-up {setup_s:.1f} s")

    rec = Run("serve", cfg, mix, ctx.peaks)
    fam = ctx.cell.family
    n_slots = mix["slots"]
    kv_rounds: List[List[int]] = []
    trace_at = ctx.seconds * mix.get("trace_after", 0.4)
    tracing = False                 # inside the profiled stretch
    window_open = True
    t_open = time.perf_counter()
    nxt = 0

    def now() -> float:
        return time.perf_counter() - t_open

    def submit_due(t: float) -> None:
        nonlocal nxt
        while nxt < len(tracks) and tracks[nxt].req.due <= t:
            tr = tracks[nxt]
            r = tr.req
            try:
                rid = sched.submit(Request(
                    prompt=torch.as_tensor(r.prompt),
                    max_new=r.max_new, adapter_id=tenant_id(r.tenant)),
                    arrival=sched.t)
                by_rid[rid] = tr
            except (ValueError, RuntimeError) as e:
                tr.error = repr(e)
            tr.submit = now()
            nxt += 1

    def one_tick() -> bool:
        """One scheduler round; False when there was nothing to do."""
        before = set(sched.slots.active_slots())
        t0 = time.perf_counter()
        evs = sched.tick()
        t1 = time.perf_counter()
        stamp = t1 - t_open
        admitted = []
        for ev in evs:
            if ev[0] == "admit":
                tr = by_rid[ev[1]]
                slot_pos[ev[2]] = len(tr.req.prompt)
                admitted.append((ev[2], len(tr.req.prompt)))
            elif ev[0] == "token":
                tr = by_rid[ev[1]]
                tr.tokens.append(int(ev[2]))
                tr.stamps.append(stamp)
            elif ev[0] == "done":
                by_rid[ev[1]].done = True
        decoded = sorted(before | {s for s, _ in admitted})
        if not evs and not decoded:
            return False
        kv = [slot_pos[s] + 1 for s in decoded]
        for s in decoded:
            slot_pos[s] += 1
        if window_open and not tracing:
            rec.tick_s.append(t1 - t0)
            rec.busy_rounds_s += t1 - t0
            rec.required_ops += sum(fam.prefill_ops(cfg, p)
                                    for _, p in admitted)
            if decoded:
                rec.required_ops += fam.decode_ops(cfg, kv)
        if tracing and decoded:
            full = [1] * n_slots
            for s, k in zip(decoded, kv):
                full[s] = k
            kv_rounds.append(full)
        return True

    while True:
        t = now()
        submit_due(t)
        if nxt >= len(tracks) and t >= ctx.seconds:
            break
        idle = not sched.slots.any_active() and not len(sched.queue)
        if idle:
            wake = tracks[nxt].req.due if nxt < len(tracks) else ctx.seconds
            time.sleep(max(0.0, wake - now()))
            continue
        if ctx.trace and rec.trace is None and t >= trace_at:
            def stretch():
                nonlocal tracing
                tracing = True
                end = now() + mix["trace_s"]
                while now() < end:
                    submit_due(now())
                    one_tick()
                tracing = False
            rec.trace, _ = ctx.traced(stretch)
            continue
        one_tick()
    rec.window_s = now()
    window_open = False
    # drain what is in flight: it counts toward the tails only
    deadline = time.perf_counter() + mix["drain_timeout_s"]
    while (len(sched.queue) or sched.slots.any_active()) \
            and time.perf_counter() < deadline:
        one_tick()
    sync(dev)
    rec.peak_window_bytes = max_memory(dev)
    peak = max(peak_setup, rec.peak_window_bytes)
    rec.k3_rounds = kv_rounds

    # the sender's lag, leaving out requests due while the profiler ran,
    # started, stopped or was read (traced runs only)
    skip = [(a - t_open, b - t_open) for a, b in ctx.tracing_overhead]
    rec.lag_s = [tr.submit - tr.req.due for tr in tracks
                 if tr.submit is not None
                 and not any(a <= tr.req.due <= b for a, b in skip)]
    # a traced run's request times: only those finished before the
    # profiler first started (its stall delays every later one)
    traced_from = min((a for a, _ in skip), default=float("inf"))
    # a request that erred, was refused or never finished misses every
    # limit: it enters each latency list as infinitely late
    failed = 0
    for tr in tracks:
        if tr.error or not tr.done or len(tr.tokens) != tr.req.max_new:
            failed += 1
            rec.ttft_s.append(float("inf"))
            rec.tpot_s.append(float("inf"))
            continue
        if tr.stamps[-1] >= traced_from:
            continue
        rec.ttft_s.append(tr.stamps[0] - tr.req.due)
        rec.tpot_s.append((tr.stamps[-1] - tr.stamps[0])
                          / max(1, len(tr.tokens) - 1))
    rec.tokens = sum(1 for tr in tracks for s in tr.stamps
                     if s <= rec.window_s)
    out = {"run": rec, "setup_s": setup_s, "attempted": len(tracks),
           "failed": failed, "memory_peak": peak, "tracks": tracks}
    if prepared is not None:
        return out

    ctx.log(f"window {rec.window_s:.1f} s, {len(tracks)} requests, "
            f"drained at {now():.1f} s; ttft ms " + " ".join(
                f"p{int(q * 100)} {1e3 * (quantile(rec.ttft_s, q) or 0):.1f}"
                for q in (0.5, 0.9, 0.95, 0.99)) + "; tpot ms p50 "
            f"{1e3 * (quantile(rec.tpot_s, 0.5) or 0):.1f} p95 "
            f"{1e3 * (quantile(rec.tpot_s, 0.95) or 0):.1f}")

    # ---- the check -------------------------------------------------------
    del sched
    gc.collect()
    empty_cache(dev)
    out["sample"] = sample(tracks, ctx)
    out["inputs"] = (base, coeffs)
    if ctx.check:
        t0 = time.perf_counter()
        out["numbers"] = (
            checks.serve_numbers(ctx.cell.reference, cfg, base,
                                 out["sample"], coeffs)
            if out["sample"] else {"max_logit_gap": float("inf")})
        ctx.log(f"check {time.perf_counter() - t0:.1f} s")
    return out


def sample(tracks: List[Track], ctx) -> List[Dict]:
    """`check_requests` finished requests drawn from the seed, the longest
    (prompt plus output) among them."""
    done = [t for t in tracks if t.done and not t.error]
    if not done:
        return []
    longest = max(done, key=lambda t: len(t.req.prompt) + len(t.tokens))
    rest = [t for t in done if t is not longest]
    rng = np.random.default_rng(inputs.subseed(ctx.seed, "sample"))
    k = min(len(rest), ctx.cell.mix["check_requests"] - 1)
    picked = [longest] + [rest[i] for i in
                          sorted(rng.choice(len(rest), size=k,
                                            replace=False))]
    return [{"prompt": t.req.prompt, "served": t.tokens,
             "tenant": t.req.tenant} for t in picked]
