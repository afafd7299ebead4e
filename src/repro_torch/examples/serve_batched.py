"""Serving example: merged-adapter batched decoding (the JAX package's
`examples/serve_batched.py` on the port).

Trains FourierFT adapters for a small LM, merges ΔW into the base weights
(zero added inference latency — paper §3.1), and serves a batch of prompts
with greedy decoding through the slot-based engine. Also demonstrates that
many adapters can be stored cheaply and hot-swapped: three "customers"
fine-tuned on different tasks share one base model.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched
    PYTHONPATH=src python -m repro_torch.examples.serve_batched --device cpu

`--steps` cuts each adapter's 40 training steps.
"""
import argparse
import time

import torch

from repro_torch import configs
from repro_torch.configs.base import PEFTConfig, TrainConfig
from repro_torch.data import SyntheticLM
from repro_torch.devices import resolve_device
from repro_torch.models import build
from repro_torch.serve import Engine
from repro_torch.train import step as train_step


def train_adapter(model, frozen, task_seed: int, device, steps: int = 40):
    tcfg = TrainConfig(learning_rate=2e-2, total_steps=steps, warmup_steps=4)
    state, f0 = train_step.init_state(model, tcfg, task_seed, device)
    frozen = {"base": frozen["base"], "peft": f0["peft"]}
    step_fn = train_step.make_train_step(model, tcfg)
    data = SyntheticLM(vocab=model.cfg.vocab, batch=8, seq=32,
                       task_seed=task_seed)
    for i in range(steps):
        batch = {k: v.to(device) for k, v in data.batch_at(i).items()}
        state, m = step_fn(state, frozen, batch)
    # the trained coefficients with the frozen entries they index
    params = train_step.join_params(model, state["trainable"], frozen)
    return params["peft"], float(m["loss"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without one)")
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = configs.reduced(configs.get("yi-6b"), layers=4, width=128).replace(
        vocab=256)
    peft = PEFTConfig(method="fourierft", n=64, alpha=20.0)
    model = build(cfg, peft)
    params0 = model.init(0, device)
    frozen = {"base": params0["base"], "peft": {}}

    # three customers, three adapters — each ~64*L*2 floats of storage
    adapters, losses = {}, {}
    for task in (11, 22, 33):
        ad, loss = train_adapter(model, frozen, task, device, args.steps)
        n_bytes = sum(v.numel() * 4 for d in ad.values()
                      for k, v in d.items() if k == "c")
        adapters[task], losses[task] = ad, loss
        print(f"adapter for task {task}: final loss {loss:.3f}, "
              f"{n_bytes/1024:.1f} KiB checkpoint")

    prompts = [torch.arange(6, dtype=torch.int32),
               torch.arange(3, dtype=torch.int32) + 7,
               torch.tensor([1, 2, 3, 5, 8, 13], dtype=torch.int32)]
    served = {}
    for task, ad in adapters.items():
        params = {"base": params0["base"], "peft": ad}
        t0 = time.perf_counter()
        engine = Engine(model, params, batch_slots=len(prompts), max_len=64,
                        device=device)
        outs = engine.generate(prompts, max_new=8)
        dt = time.perf_counter() - t0
        print(f"task {task}: served {len(prompts)} prompts in {dt:.2f}s "
              f"(merged; per-token graph identical to the base model)")
        # the example prints each tenant's outputs, once a tenant
        # repro: allow(host-sync-in-loop) — printed below
        served[task] = [o.tolist() for o in outs]
        for i, o in enumerate(served[task]):
            print(f"  prompt {i}: {o}")
    return {"losses": losses, "served": served}


if __name__ == "__main__":
    main()
