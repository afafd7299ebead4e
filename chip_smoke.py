#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card and hold its
hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, in order; the first failure ends the run with a non-zero exit and
no result line:

1. device   — the card's name and power limit (nvidia-smi).
2. build    — nvcc builds every kernel of `src/repro_torch/kernels/csrc`
              (one process per source, started together).
3. K1       — the FourierFT ΔW kernel against its plain version at the
              slice's shapes (yi-6b wq 4096x4096 and wv 4096x512, n = 1000,
              stacked over L = 2) and one ragged shape, atol 2e-4 in f32
              with TF32 off; kernel, plain and one-`torch.matmul` times.
4. K3       — the paged decode attention kernel against its plain version
              at yi-6b geometry (B 8, H 32, K 4, dh 128, page 16, W 1,
              ragged kv_len from 1 to the full window), bf16 (atol/rtol
              2e-2) and f32 (1e-5); kernel, plain and SDPA times.
5. slice    — yi-6b at full width, cut to 2 layers, bf16, FourierFT
              n = 1000, alpha = 300 on wq/wv: Engine (merge -> K1) and
              ContinuousScheduler (paged -> K3) replay the launcher's
              8-request staggered trace. Every request completes its budget,
              logits are finite, the launch counters show K1 and K3 ran
              (K3 exactly decode steps x layers), and the same trace with
              kernel_backend="einsum" gives merged weights within one bf16
              ulp and the same first token for every request.
6. kernels  — one JSON line with each kernel's launches, error and times.

The last line is {"ok": true, "device": {...}}. The script imports nothing
of JAX; it needs a CUDA device and the repository's `src/` beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

H100_HBM_BYTES_PER_S = 3.35e12        # NVIDIA H100 SXM data sheet
H100_PEAK = {"float32": 67e12,        # FP32 outside the tensor cores
             "bfloat16": 989e12}      # dense bf16 tensor-core rate
SLICE_LAYERS = 2                      # depth cut of yi-6b (time, not memory)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / H100_PEAK[dtype]
    t_mem = nbytes / H100_HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                     else "bytes")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        return fail(f"the port's package is not at {src / 'repro_torch'}")
    sys.path.insert(0, str(src))
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.configs.base import PEFTConfig
    from repro_torch.core.fourierft import fourier_bases, sample_entries
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import fourier_deltaw as fdk
    from repro_torch.kernels import paged_attention as pak
    from repro_torch.launch.serve import demo_prompts, demo_trace
    from repro_torch.models import build
    from repro_torch.serve import ContinuousScheduler, Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    def timed_ms(fn, iters: int, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    # ---- 1. device ---------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(f"[device] {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(smi[0] if smi else "nvidia-smi: no output")

    # ---- 2. build ------------------------------------------------------------
    secs = kbuild.build_all()
    print(f"[build] {len(kbuild.SIGNATURES)} kernel libraries in "
          f"{secs:.1f} s")
    for lib, log in kbuild.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {lib}: {line.strip()}")

    # ---- 3. K1 ---------------------------------------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    k1 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
          "err": 0.0, "flops": 0.0, "bytes": 0.0}
    for d1, d2, n, L, main_path in ((4096, 4096, 1000, 2, True),
                                    (4096, 512, 1000, 2, True),
                                    (300, 520, 37, 1, False)):
        entries = sample_entries(d1, d2, n, seed=7).to(dev)
        npad = -(-n // fdk.NC) * fdk.NC
        c = torch.zeros((L, npad), dtype=torch.float32, device=dev)
        c[:, :n] = torch.randn((L, n), generator=gen, device=dev)
        e = torch.zeros((2, npad), dtype=torch.int32, device=dev)
        e[:, :n] = entries
        u, v = e[0].contiguous(), e[1].contiguous()
        out = fdk.deltaw(c, u, v, d1, d2, 300.0)
        ref = fdk.deltaw_reference(c, u, v, d1, d2, 300.0)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not torch.isfinite(out).all() or err > 2e-4:
            return fail(f"K1 {d1}x{d2} n={n} L={L}: max |kernel - plain| "
                        f"{err:.3e} > 2e-4")
        ms = timed_ms(lambda: fdk.deltaw(c, u, v, d1, d2, 300.0), 5)
        plain_ms = timed_ms(
            lambda: fdk.deltaw_reference(c, u, v, d1, d2, 300.0), 5)
        # one torch.matmul of the pre-built rank-2n factors (per layer
        # A = [c·cosθ, -c·sinθ]·scale, B = [cosφ, sinφ])
        cos_t, sin_t, cos_p, sin_p = fourier_bases(e, d1, d2)
        a = torch.cat([cos_t[None] * c[:, None, :],
                       -sin_t[None] * c[:, None, :]], dim=2) \
            * (300.0 / (d1 * d2))
        b = torch.cat([cos_p, sin_p], dim=1).T.contiguous()
        lib_ms = timed_ms(lambda: torch.matmul(a, b), 5)
        flops = 4.0 * d1 * d2 * n * L
        nbytes = 4.0 * (L * n + 2 * n + L * d1 * d2)
        b_ms, b_by = bound(flops, nbytes, "float32")
        print(f"[K1] {d1}x{d2} n={n} L={L}: max_abs_err {err:.3e} | kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, matmul {lib_ms:.3f} "
              f"ms, bound {b_ms:.3f} ms ({b_by})")
        k1["err"] = max(k1["err"], err)
        if main_path:
            k1["ms"] += ms
            k1["plain_ms"] += plain_ms
            k1["library_ms"] += lib_ms
            k1["flops"] += flops
            k1["bytes"] += nbytes
        del a, b, out, ref
    k1["bound_ms"], k1["bound_by"] = bound(k1["flops"], k1["bytes"],
                                           "float32")

    # ---- 4. K3 ---------------------------------------------------------------
    B, W, H, K, dh, ps, pps = 8, 1, 32, 4, 128, 16, 8     # max_len 128
    n_pages = B + B * pps + 2 * pps
    kv_len = torch.tensor([1, pps * ps, ps, 37, 64, 5, 100, 77],
                          dtype=torch.int32, device=dev)
    perm = torch.randperm(n_pages - B, generator=gen, device=dev) + B
    bt = perm[:B * pps].reshape(B, pps).to(torch.int32).contiguous()
    k3 = {}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        q = torch.randn((B, W, H, dh), generator=gen, device=dev).to(dtype)
        kp = torch.randn((n_pages, ps, K, dh), generator=gen,
                         device=dev).to(dtype)
        vp = torch.randn((n_pages, ps, K, dh), generator=gen,
                         device=dev).to(dtype)
        out = pak.paged_attention(q, kp, vp, bt, kv_len)
        ref = pak.paged_attention_reference(q, kp, vp, bt, kv_len)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        if not torch.isfinite(out.float()).all() or bool(
                (diff > tol + tol * ref.float().abs()).any()):
            return fail(f"K3 {dtype}: kernel disagrees with the plain "
                        f"version (max |diff| {err:.3e}, atol=rtol={tol})")
        ms = timed_ms(lambda: pak.paged_attention(q, kp, vp, bt, kv_len), 100)
        plain_ms = timed_ms(
            lambda: pak.paged_attention_reference(q, kp, vp, bt, kv_len), 100)
        # SDPA over the pre-gathered window (GQA heads expanded beforehand)
        T = pps * ps
        kg = kp[bt.long()].reshape(B, T, K, dh).transpose(1, 2)
        vg = vp[bt.long()].reshape(B, T, K, dh).transpose(1, 2)
        kg = kg.repeat_interleave(H // K, dim=1).contiguous()
        vg = vg.repeat_interleave(H // K, dim=1).contiguous()
        qg = q.transpose(1, 2).contiguous()                   # (B, H, W, dh)
        mask = (torch.arange(T, device=dev)[None, :]
                < kv_len[:, None])[:, None, None, :]
        lib_ms = timed_ms(lambda: F.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=mask), 100)
        elt = torch.finfo(dtype).bits // 8
        rows = float(kv_len.sum())
        nbytes = (2 * B * W * H * dh * elt + 2 * rows * K * dh * elt
                  + 4 * B + 4 * float(((kv_len + ps - 1) // ps).sum()))
        flops = 4.0 * W * H * dh * rows
        dname = "bfloat16" if dtype == torch.bfloat16 else "float32"
        b_ms, b_by = bound(flops, nbytes, dname)
        print(f"[K3] {dname} B={B} H={H} K={K} dh={dh} ps={ps}: "
              f"max_abs_err {err:.3e} | kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by})")
        k3[dname] = {"err": err, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}

    # ---- 5. slice --------------------------------------------------------------
    cfg = configs.get("yi-6b").replace(num_layers=SLICE_LAYERS)
    print(f"[slice] yi-6b at full width (d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), "
          f"depth cut 32 -> {cfg.num_layers} layers, {cfg.dtype}")
    peft = PEFTConfig(method="fourierft", n=1000, alpha=300.0)
    model = build(cfg, peft)
    params = model.init(0, dev)
    slots, max_len = 8, pps * ps
    prompts = demo_prompts(cfg, slots)

    def run(backend: str):
        m = build(cfg, peft.replace(kernel_backend=backend))
        t0 = time.perf_counter()
        engine = Engine(m, params, batch_slots=slots, max_len=max_len,
                        device=dev)
        torch.cuda.synchronize()
        merge_s = time.perf_counter() - t0
        sched = ContinuousScheduler(engine, page_size=ps)
        reqs, arrivals = demo_trace(prompts, 8, 16, 2.0)
        sched.serve(reqs, arrivals)
        torch.cuda.synchronize()
        return engine, sched, reqs, merge_s

    fdk.launches = 0
    pak.launches = 0
    engine, sched, reqs, merge_s = run("auto")
    k1_launches, k3_launches = fdk.launches, pak.launches
    steps = sched.metrics.steps
    for i, r in enumerate(reqs):
        if r.out is None or len(r.out) != r.max_new:
            return fail(f"request {i} emitted {r.out!r}, budget {r.max_new}")
    for p in prompts:
        logits = engine.model.forward(engine.params, {"tokens": p[None].to(dev)})
        if logits.shape != (1, p.shape[0], cfg.vocab) \
                or not torch.isfinite(logits.float()).all():
            return fail(f"logits {tuple(logits.shape)} not finite")
    if k1_launches < 1:
        return fail("the merge never launched the ΔW kernel")
    if k3_launches != steps * cfg.num_layers:
        return fail(f"paged attention kernel launched {k3_launches} times, "
                    f"expected {steps} decode steps x {cfg.num_layers}")
    s = sched.metrics.summary()
    print(f"[slice] kernels: merge {merge_s:.3f} s, {len(reqs)} requests, "
          f"{s['total_tokens']:.0f} tokens in {steps} decode steps | "
          f"{s['tokens_per_s']:.1f} tok/s, ttft {s['ttft_steps_mean']:.2f} "
          f"steps (p90 {s['ttft_steps_p90']:.0f}), prime "
          f"{s['prime_s_mean'] * 1e3:.2f} ms mean | K1 launches "
          f"{k1_launches}, K3 launches {k3_launches}")
    engine_e, sched_e, reqs_e, merge_e = run("einsum")
    for key in ("wq", "wv"):
        # both merges add bf16(ΔW) to the same bf16 W: the f32 ΔWs agree to
        # ~1e-8 (phase 3), but casting them to bf16 can still differ in
        # the last bit, and the sum then rounds once more. Allowed: one
        # bf16 ulp (2^-7 relative) of the merged value plus one of ΔW.
        w = params["base"]["layers"][key].float()
        a = engine.params["base"]["layers"][key].float()
        b = engine_e.params["base"]["layers"][key].float()
        ulp = (torch.maximum(a.abs(), b.abs())
               + torch.maximum((a - w).abs(), (b - w).abs())) * 2.0 ** -7
        diff = (a - b).abs()
        if bool((diff > ulp).any()):
            return fail(f"merged {key}: kernel and plain merges differ by "
                        "more than one bf16 ulp")
        print(f"[slice] merged {key}: {int((diff > 0).sum())} of "
              f"{diff.numel()} bf16 values differ (each within one ulp)")
    first = [r.out[0] for r in reqs] == [r.out[0] for r in reqs_e]
    later = sum(x != y for r, re_ in zip(reqs, reqs_e)
                for x, y in zip(r.out[1:], re_.out[1:]))
    if not first:
        return fail("first tokens differ between the kernel and plain runs")
    s_e = sched_e.metrics.summary()
    print(f"[slice] plain (einsum): merge {merge_e:.3f} s, "
          f"{s_e['tokens_per_s']:.1f} tok/s | merged wq/wv within one bf16 "
          f"ulp, first tokens equal, {later} later token mismatches of "
          f"{sum(len(r.out) - 1 for r in reqs)}")
    # the first run above also paid one-time set-up (library handles,
    # pinned buffers); a second kernel run, after the plain one, is the
    # warm figure to compare with it
    engine_w, sched_w, reqs_w, merge_w = run("auto")
    s_w = sched_w.metrics.summary()
    print(f"[slice] kernels, warm: merge {merge_w:.3f} s, "
          f"{s_w['tokens_per_s']:.1f} tok/s, prime "
          f"{s_w['prime_s_mean'] * 1e3:.2f} ms mean, streams "
          f"{'equal' if [r.out for r in reqs_w] == [r.out for r in reqs] else 'DIFFER'}")

    # ---- 6. kernels line -------------------------------------------------------
    kb = k3["bfloat16"]
    print(json.dumps({"kernels": [
        {"name": "fourier_deltaw", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fourier_deltaw.cu",
         "replaces": "src/repro/kernels/fourier_deltaw.py:86",
         "launches": k1_launches, "max_abs_err": k1["err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"]},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:149",
         "launches": k3_launches,
         "max_abs_err": max(v["err"] for v in k3.values()),
         "ms": kb["ms"], "plain_ms": kb["plain_ms"],
         "bound_ms": kb["bound_ms"], "bound_by": kb["bound_by"],
         "library_ms": kb["library_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
