"""Quickstart: fine-tune a small decoder LM with FourierFT in ~30 lines of
public API, then merge the adapter for zero-latency serving (the JAX
package's `examples/quickstart.py` on the port).

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

`--steps` cuts the 200 training steps; `--dtype float32` trains the model
in f32 instead of the arch's bf16; checkpoints go to a fresh temporary
directory, so a second run starts over.
"""
import argparse
import tempfile

import torch

from repro_torch import configs
from repro_torch.configs.base import PEFTConfig, TrainConfig
from repro_torch.data import SyntheticLM
from repro_torch.devices import resolve_device
from repro_torch.models import build
from repro_torch.serve import Engine
from repro_torch.train import loop
from repro_torch.train import step as train_step
from repro_torch.tree import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without one)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dtype", default=None, choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. pick an architecture config (any of the 10 registered archs works;
    #    `reduced` shrinks it to laptop scale for this demo)
    cfg = configs.reduced(configs.get("yi-6b"), layers=4, width=128).replace(
        vocab=256)
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype, param_dtype=args.dtype)

    # 2. attach the paper's technique: n spectral coefficients per q/v matrix.
    #    kernel_backend picks how ΔW materializes: "auto" launches the
    #    hand-written CUDA kernels for tensors on the card and uses the plain
    #    PyTorch version on the CPU; explain_kernels() shows what each site
    #    resolved to.
    peft = PEFTConfig(method="fourierft", n=128, alpha=20.0, train_head=True,
                      kernel_backend="auto")
    model = build(cfg, peft)
    params = model.init(0, device)
    print(f"arch={cfg.name}  trainable params={model.trainable_params():,} "
          f"(vs {sum(x.numel() for x in tree_leaves(params['base'])):,} "
          "frozen)")
    print(model.explain_kernels(device))

    # 3. train with the fault-tolerant loop (async checkpoints, anomaly guard)
    tcfg = TrainConfig(learning_rate=5e-2, total_steps=args.steps,
                       warmup_steps=10)
    state, frozen = train_step.state_from_params(model, params, tcfg)
    step_fn = train_step.make_train_step(model, tcfg)
    data = SyntheticLM(vocab=cfg.vocab, batch=16, seq=64, task_seed=5)
    # (markov teacher => loss floor ~= teacher entropy; adapters+head close
    #  most of the gap from the random-base starting point)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_quickstart_")
    state, report = loop.run(step_fn, state, frozen, data, tcfg,
                             ckpt_dir=ckpt_dir, ckpt_every=50)
    print(f"loss {report.losses[0]:.3f} -> {report.final_loss:.3f} "
          f"({report.steps_run} steps, {report.anomalies} anomalies)")

    # 4. merge ΔW into the base weights and serve (paper §3.1: no latency)
    params = train_step.join_params(model, state["trainable"], frozen)
    engine = Engine(model, params, batch_slots=2, max_len=96, device=device)
    outs = engine.generate([torch.arange(8, dtype=torch.int32),
                            torch.arange(4, dtype=torch.int32)], max_new=12)
    # repro: allow(host-sync) — the example prints what it generated
    generated = [o.tolist() for o in outs]
    print("generated:", generated)
    return {"losses": report.losses, "generated": generated,
            "anomalies": report.anomalies}


if __name__ == "__main__":
    main()
