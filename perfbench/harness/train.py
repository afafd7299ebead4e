"""The training driver: the measured program's train step, built as its
launcher builds it (`train.step.make_sharded_train_step` on the one-device
mesh), driven back to back on seeded token batches.

Set-up builds the step, its model and its optimizer state once and runs
the first steps through the same call and feed as the window: the first
`checked_steps` of them are what the reference follows, the rest warm up.
The window then steps the same state for `--seconds`; each step ends in
its one host read (the loss and the anomaly guard's skip flag). After
the window the program's state is freed and the reference replays the
checked steps.
"""
from __future__ import annotations

import gc
import time
from typing import Dict

from harness import checks, inputs, modelcfg
from harness.device import empty_cache, max_memory, reset_peak, sync
from harness.record import Run


def run(ctx) -> Dict:
    import torch
    from repro_torch.core import peft as peft_mod
    from repro_torch.kernels import fourier_deltaw as fdk
    from repro_torch.kernels import fused_attention as fak
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import build
    from repro_torch.train import step as train_step

    cfg, mix, dev = ctx.cell.cfg, ctx.cell.mix, ctx.device
    fam = ctx.cell.family
    B, S, V = mix["batch"], mix["seq"], cfg["vocab_size"]
    mcfg = fam.model_config(cfg)
    peft = modelcfg.peft_config(cfg, strategy=mix["strategy"])
    model = build(mcfg, peft, remat=mix["remat"])
    tcfg = train_config(mix)
    layout = fam.base_layout(cfg)
    checks.layout_matches(model, layout)
    base = inputs.make_base(layout, ctx.seed, dev)
    sites = fam.adapted_sites(cfg)
    c0 = inputs.make_coeffs(sites, peft.n, ctx.seed, dev)
    adapters = peft_mod.init_adapters(torch.Generator(device=dev),
                                      model.sites, peft, dev)
    for name, ad in adapters.items():
        ad["c"] = c0[name].clone()
    state, frozen = train_step.state_from_params(
        model, {"base": base, "peft": adapters}, tcfg)
    mesh_mod.init_from_env(dev)
    mesh = mesh_mod.make_host_mesh(model=1)
    state, frozen, _, _ = train_step.shard_train_state(model, state, frozen,
                                                       mesh)
    example = inputs.train_batch(ctx.seed, 0, B, S, V, dev)
    step_fn, batch_sh = train_step.make_sharded_train_step(
        model, tcfg, mesh, example)
    rows = B // 2 if "half_batch" in ctx.faults else B

    def step(i: int):
        nonlocal state
        batch = inputs.train_batch(ctx.seed, i, B, S, V, dev)
        batch = {k: v[:rows] for k, v in batch.items()}
        batch = train_step.place_batch(batch, batch_sh, mesh,
                                       tcfg.microbatch)
        new, metrics = step_fn(state, frozen, batch)
        if "unchanged_state" not in ctx.faults:
            state = new
        # the step's one host read
        loss, skipped = torch.stack([metrics["loss"].float(),
                                     metrics["skipped"].float()]).tolist()
        return loss, skipped

    def leaf(tree, site):
        return tree["peft"][site]["c"].detach().to(torch.float32).clone()

    n_check = mix["checked_steps"]
    losses, b1 = [], tcfg.b1
    for i in range(n_check):
        losses.append(step(i)[0])
        if i == 0:
            grad1 = {s: leaf(state["opt"]["mu"], s) / (1 - b1) for s in c0}
    moved = {s: leaf(state["trainable"], s) - c0[s] for s in c0}
    for i in range(n_check, n_check + mix["warm_steps"]):
        step(i)
    sync(dev)
    peak_setup = max_memory(dev)
    reset_peak(dev)
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"set-up {setup_s:.1f} s")

    # ---- the window ------------------------------------------------------
    rec = Run("train", cfg, mix, ctx.peaks, sites=[s for s in sites],
              attention=fam.attention_shape(
                  cfg, B // max(1, tcfg.microbatch), S))
    i = n_check + mix["warm_steps"]
    failed = 0
    trace_at = ctx.seconds * mix.get("trace_after", 0.4)
    t_open = time.perf_counter()
    t_end = t_open
    # a traced run traces its stretch even where a step outlasts the window
    while t_end - t_open < ctx.seconds or (ctx.trace and rec.trace is None):
        if ctx.trace and rec.trace is None and t_end - t_open >= trace_at:
            before = (fdk.launches, fdk.dc_launches, fak.launches,
                      fak.bwd_launches)
            rec.trace, n = ctx.traced(lambda: [step(i + j) for j in
                                               range(mix["trace_steps"])])
            for _, skipped in n:
                failed += int(skipped)
            rec.counters = {
                "k1_launches": fdk.launches - before[0],
                "k2_launches": fdk.dc_launches - before[1],
                "attention_launches": fak.launches - before[2],
                "attention_bwd_launches": fak.bwd_launches - before[3]}
            i += mix["trace_steps"]
            t_end = time.perf_counter()
            continue
        t0 = time.perf_counter()
        _, skipped = step(i)
        t_end = time.perf_counter()
        rec.step_s.append(t_end - t0)
        failed += int(skipped)
        i += 1
    steps = i - (n_check + mix["warm_steps"])
    rec.window_s = t_end - t_open
    # a step the anomaly guard skipped trained nothing
    rec.tokens = (steps - failed) * B * S
    rec.step_ops = fam.train_step_ops(cfg, B, S)
    rec.peak_window_bytes = max_memory(dev)
    peak = max(peak_setup, rec.peak_window_bytes)

    mfu = (100.0 * rec.step_ops * len(rec.step_s)
           / (sum(rec.step_s) * ctx.peaks["bf16_flops"])
           if rec.step_s and "bf16_flops" in ctx.peaks else float("nan"))
    ctx.log(f"window {rec.window_s:.1f} s, {steps} steps, mfu.train "
            f"{mfu:.2f} %")

    # ---- the check -------------------------------------------------------
    del state, frozen, step_fn, adapters
    gc.collect()
    empty_cache(dev)
    readings = {"losses": losses, "grad1": grad1, "moved": moved}
    out = {"run": rec, "setup_s": setup_s, "attempted": steps,
           "failed": failed, "memory_peak": peak, "readings": readings,
           "inputs": (base, c0, tcfg)}
    if ctx.check:
        t0 = time.perf_counter()
        ref = checks.train_reference(ctx.cell.reference, cfg, base, c0,
                                     checked_batches(ctx), tcfg)
        out["numbers"] = checks.train_gaps(ref, **readings)
        ctx.log(f"check {time.perf_counter() - t0:.1f} s")
    return out


def train_config(mix):
    """The step's optimizer settings: AdamW at the mix's constant rate."""
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(learning_rate=mix["learning_rate"], warmup_steps=1,
                       total_steps=1 << 30, schedule="constant",
                       microbatch=mix.get("microbatch", 0))


def checked_batches(ctx):
    mix, cfg = ctx.cell.mix, ctx.cell.cfg
    return [inputs.train_batch(ctx.seed, j, mix["batch"], mix["seq"],
                               cfg["vocab_size"], ctx.device)
            for j in range(mix["checked_steps"])]

