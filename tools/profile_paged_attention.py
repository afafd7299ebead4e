#!/usr/bin/env python3
"""Where K3's (the paged decode attention kernel's) time goes, on one
NVIDIA card.

    python3 tools/profile_paged_attention.py [--mode step|kernel]
        [--kv-len 4096] [--slots 8] [--steps 10] [--src DIR] [--out FILE]

--mode step (the default): one full-depth decode step at a long context,
    and K3's share of it. yi-6b at all 32 layers and full width, bf16,
    FourierFT (n = 1000, α = 300 on wq/wv) merged into the base by the
    Engine, 8 slots. The paged KV cache (page 16) is filled with seeded
    random K/V at kv_len 4096 for every slot (about 2.1 GB; no prefill),
    and `decode_logits` runs on it through the registry's paged attention
    op:
    1. step time: host clock around `--steps` warm steps, each ending in
       `torch.cuda.synchronize()`;
    2. a `torch.profiler` trace (CUDA activity) of as many steps: device
       time per step, its share of the untraced step's wall time (the
       device's busy share), K3's device time (its kernels: the split
       attention and the combine) and its share of the device time, and
       the five kernels that take most device time;
    3. K3's launches over the steps (steps x layers).
--mode kernel: the K3 wrapper alone at chip_smoke.py's K3 shapes (yi-6b
    geometry, B 8 to 4096 and B 32 at 2048, W 1 and 5), bf16 and f32:
    CUDA-event ms over 50 calls (page pools rotated past the L2) and
    device µs per call and per CUDA kernel (`torch.profiler`).

`--src` imports `repro_torch` from another tree's `src/` (e.g. a
`git archive` of a parent commit), so two versions of the kernel can be
timed in one call on one card. Prints the card's name and power limit
first and one JSON line last (also written to `--out`). Imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
K3_KERNELS = ("paged_attn", "combine_splits")
# chip_smoke.py's K3 shapes: (name, B, W, pages per slot, kv_len per slot)
SHAPES = (
    ("b8_kv128", 8, 1, 8, [1, 128, 16, 37, 64, 5, 100, 77]),
    ("b8_ragged1024", 8, 1, 64, [1, 1024, 512, 700, 1000, 33, 257, 900]),
    ("b8_ragged4096", 8, 1, 256, [1, 4096, 2048, 3000, 4000, 129, 1025,
                                  3500]),
    ("b8_kv4096", 8, 1, 256, [4096] * 8),
    ("b32_kv2048", 32, 1, 128, [2048] * 32),
    ("b8_w5_kv4096", 8, 5, 256, [4092] * 8),
)
H, K, DH, PS = 32, 4, 128, 16


def device_us(fn, n: int = 20):
    """Device µs per call of each CUDA kernel `fn` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0:
            name = ev.key.replace("(anonymous namespace)::", "")
            out[name.replace("void ", "").split("(")[0]] = t / n
    return out


def k3_inputs(gen, dev, dtype, B, W, pps, lens):
    """q, page pools enough to exceed the 50 MB L2, block table, kv_len."""
    import torch
    n_pages = B * pps + 2 * pps
    elt = torch.finfo(dtype).bits // 8
    copies = max(1, min(8, -(-(96 << 20) // (2 * n_pages * PS * K * DH
                                             * elt))))
    bt = torch.randperm(n_pages, generator=gen, device=dev)[:B * pps]
    bt = bt.reshape(B, pps).to(torch.int32).contiguous()
    q = torch.randn((B, W, H, DH), generator=gen, device=dev).to(dtype)
    pools = [tuple(torch.randn((n_pages, PS, K, DH), generator=gen,
                               device=dev).to(dtype) for _ in range(2))
             for _ in range(copies)]
    return q, pools, bt, torch.tensor(lens, dtype=torch.int32, device=dev)


def run_kernel(args, dev, pak):
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    res = {}
    for name, B, W, pps, lens in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            q, pools, bt, kv = k3_inputs(gen, dev, dtype, B, W, pps, lens)
            turn = [0]

            def call():
                kp, vp = pools[turn[0] % len(pools)]
                turn[0] += 1
                return pak.paged_attention(q, kp, vp, bt, kv)

            for _ in range(3):
                call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(50):
                call()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 50
            parts = {k: v for k, v in device_us(call).items()
                     if any(n in k for n in K3_KERNELS)}
            res[f"{name}/{dname}"] = {"ms": ms, "device_us":
                                      sum(parts.values()), "kernels": parts}
            print(f"[kernel] {name} {dname}: {ms:.4f} ms, device "
                  f"{sum(parts.values()):.2f} us "
                  f"({', '.join(f'{k} {v:.2f}' for k, v in parts.items())})")
            del pools
    return res


def run_step(args, dev, pak):
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import PEFTConfig
    from repro_torch.models import build
    from repro_torch.serve import Engine
    cfg = configs.get("yi-6b").replace(num_layers=args.layers)
    peft = PEFTConfig(method="fourierft", n=1000, alpha=300.0)
    model = build(cfg, peft)
    params = model.init(args.seed, dev)
    B, ps = args.slots, args.page_size
    pps = -(-(args.kv_len + 1) // ps)
    engine = Engine(model, params, batch_slots=B, max_len=pps * ps,
                    device=dev)
    del params
    n_pages = B * pps + 1
    cache = engine.model.init_cache(B, pps * ps, torch.bfloat16, dev,
                                    paged=True, page_size=ps,
                                    n_pages=n_pages)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    for key in ("pk", "pv"):
        for layer in cache[key]:
            layer.normal_(generator=gen)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev)
    bt = perm[:B * pps].reshape(B, pps).to(torch.int32).contiguous()
    # each step writes its token at position kv_len - 1 and attends kv_len
    # columns; the position is reset every step, so every step is the same
    cache["pos"].fill_(args.kv_len - 1)
    tokens = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device=dev,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "block_table": bt}
    kv_bytes = sum(cache[k].numel() * cache[k].element_size()
                   for k in ("pk", "pv"))

    @torch.no_grad()
    def step():
        logits, _ = engine.model.decode_logits(engine.params, cache, batch)
        return logits

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    before = pak.launches
    walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = pak.launches - before
    kernels = {k: v * args.steps for k, v in device_us(step, args.steps)
               .items()}
    dev_us = sum(kernels.values()) / args.steps
    k3_us = sum(t for k, t in kernels.items()
                if any(n in k for n in K3_KERNELS)) / args.steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    wall_ms = sorted(walls)[len(walls) // 2] * 1e3
    res = {
        "model": f"yi-6b x{cfg.num_layers} layers bf16, merged",
        "slots": B, "kv_len": args.kv_len, "page_size": ps,
        "kv_cache_gib": kv_bytes / 2 ** 30,
        "step_ms_median": wall_ms,
        "step_ms": [w * 1e3 for w in walls],
        "device_ms_per_step": dev_us / 1e3 if dev_us else None,
        # device time of a traced step over the untraced step's wall time
        "device_busy_share": dev_us / 1e3 / wall_ms if dev_us else None,
        "k3_ms_per_step": k3_us / 1e3 if dev_us else None,
        "k3_share_of_device": k3_us / dev_us if dev_us else None,
        "k3_us_per_layer": k3_us / cfg.num_layers if dev_us else None,
        "k3_launches": launches,
        "top_kernels_ms_per_step": [(k, t / args.steps / 1e3)
                                    for k, t in top],
    }
    if dev_us:
        print(f"[decode] {res['model']}, {B} slots at kv_len {args.kv_len} "
              f"(KV cache {res['kv_cache_gib']:.2f} GiB): step "
              f"{wall_ms:.3f} ms (median of {args.steps}); device "
              f"{res['device_ms_per_step']:.3f} ms/step, busy "
              f"{res['device_busy_share']:.1%}; K3 "
              f"{res['k3_ms_per_step']:.3f} ms/step "
              f"({res['k3_share_of_device']:.1%} of device time, "
              f"{res['k3_us_per_layer']:.1f} us/layer), {launches} launches")
    else:
        print("[decode] the profiler showed no device time: device figures "
              "not measured")
    for k, t in res["top_kernels_ms_per_step"]:
        print(f"[decode]   {t:.4f} ms/step  {k[:100]}")
    if launches != args.steps * cfg.num_layers:
        raise RuntimeError(f"K3 launched {launches} times in {args.steps} "
                           f"steps of {cfg.num_layers} layers")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("step", "kernel"), default="step")
    ap.add_argument("--kv-len", type=int, default=4096)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_paged_attention: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import paged_attention as pak
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    run = {"step": run_step, "kernel": run_kernel}
    res = {"card": smi, "src": args.src, "torch": torch.__version__,
           "mode": args.mode, **run[args.mode](args, dev, pak)}
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
