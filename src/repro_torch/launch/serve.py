"""Serving launcher: `python -m repro_torch.launch.serve --arch <id> [...]`.

Builds a dense decoder with FourierFT on q/v from a seed, merges every ΔW
into the base (on the card through the hand-written ΔW kernel), and decodes
demo prompts through the slot engine. With `--continuous` it replays a
staggered-arrival, mixed-`max_new` trace through the continuous-batching
scheduler over the paged KV cache (decode attention through the
hand-written paged-attention kernel on the card) and prints per-request
outputs plus serving metrics. Prompts and trace are the JAX launcher's.

    python -m repro_torch.launch.serve --arch yi-6b --continuous
    python -m repro_torch.launch.serve --arch yi-6b --reduced --continuous \
        --device cpu

It runs on `cuda` unless `--device` says otherwise, and fails when there is
no CUDA device and no `--device`.
"""
from __future__ import annotations

import argparse
from typing import List, Tuple

import torch

from repro_torch import configs
from repro_torch.configs.base import ModelConfig, PEFTConfig
from repro_torch.devices import resolve_device
from repro_torch.models import build
from repro_torch.serve import ContinuousScheduler, Engine, Request


def demo_prompts(cfg: ModelConfig, slots: int) -> List[torch.Tensor]:
    """The JAX launcher's demo prompts: slot i gets 4 + i tokens."""
    return [(torch.arange(4 + i, dtype=torch.int32) + 3 * i) % cfg.vocab
            for i in range(slots)]


def demo_trace(prompts: List[torch.Tensor], n: int, max_new: int,
               arrival_every: float) -> Tuple[List[Request], List[float]]:
    """The JAX launcher's replay trace: request i reuses prompt i mod
    len(prompts), asks for 1 + (5i + 3) mod max_new tokens and arrives at
    step i * arrival_every."""
    reqs = [Request(prompt=prompts[i % len(prompts)],
                    max_new=1 + (5 * i + 3) % max_new) for i in range(n)]
    return reqs, [i * arrival_every for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--alpha", type=float, default=300.0)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--continuous", action="store_true",
                    help="replay a staggered-arrival trace through the "
                         "continuous-batching scheduler (paged KV cache)")
    ap.add_argument("--trace-n", type=int, default=12,
                    help="--continuous: number of replayed requests")
    ap.add_argument("--arrival-every", type=float, default=2.0,
                    help="--continuous: arrival gap in decode steps")
    ap.add_argument("--page-size", type=int, default=16,
                    help="--continuous: paged-cache page size (tokens)")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="--continuous: constrain the device page pool")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg).replace(vocab=min(cfg.vocab, 512))
    model = build(cfg, PEFTConfig(method="fourierft", n=args.n,
                                  alpha=args.alpha))
    params = model.init(args.seed, device)
    slots = 2
    engine = Engine(model, params, batch_slots=slots, max_len=args.max_len,
                    device=device)
    print(engine.kernel_policy.explain())
    prompts = demo_prompts(cfg, slots)
    if args.continuous:
        sched = ContinuousScheduler(engine, page_size=args.page_size,
                                    n_pages=args.n_pages)
        reqs, arrivals = demo_trace(prompts, args.trace_n, args.max_new,
                                    args.arrival_every)
        sched.serve(reqs, arrivals)
        for i, r in enumerate(reqs):
            print(f"request {i} (arrival {arrivals[i]:g}, "
                  f"max_new {r.max_new}): {r.out}")
        s = sched.metrics.summary()
        print(f"continuous: {s['n_requests']:.0f} requests, "
              f"{s['total_tokens']:.0f} tokens in {s['steps']:.0f} steps | "
              f"occupancy {s['occupancy_mean']:.2f}, "
              f"ttft {s['ttft_steps_mean']:.1f} steps (p90 "
              f"{s['ttft_steps_p90']:.1f}), "
              f"{s['tokens_per_s']:.0f} tok/s on {device}")
        return
    outs = engine.generate(prompts, max_new=args.max_new)
    for i, o in enumerate(outs):
        print(f"prompt {i}: {o.tolist()}")


if __name__ == "__main__":
    main()
