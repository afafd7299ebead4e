"""Training launcher: `python -m repro_torch.launch.train --arch <id> [...]`.

Fine-tunes adapter coefficients (`--method`: FourierFT, or the cosine-basis
`dct`) on a dense decoder through the merged train step and the
fault-tolerant loop: on the card every step's forward materializes ΔW with
the method's hand-written ΔW kernel (K1 or K4) and its backward takes the
coefficients' gradient with its hand-written dc kernel (K2 or K5). Data is the
step-keyed synthetic Markov task; `--ckpt-dir` checkpoints every
`--ckpt-every` steps and a rerun of the same command resumes.

    python -m repro_torch.launch.train --arch yi-6b --steps 20
    python -m repro_torch.launch.train --arch yi-6b --reduced --steps 3 \
        --device cpu
    python -m repro_torch.launch.train --arch yi-6b --method dct \
        --steps 20 --ckpt-dir /tmp/dct

It runs on `cuda` unless `--device` says otherwise, and fails when there is
no CUDA device and no `--device`. The mesh, FSDP, gradient-compression and
sharding-plan flags of the JAX launcher come with the distributed slice
(ROADMAP queue 9).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch.configs.base import PEFTConfig, TrainConfig
from repro_torch.core import adapter as adapter_api
from repro_torch.data import SyntheticLM
from repro_torch.devices import resolve_device
from repro_torch.models import build
from repro_torch.train import loop, step as train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-runnable)")
    ap.add_argument("--method", default="fourierft",
                    choices=adapter_api.registered_methods())
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--alpha", type=float, default=300.0)
    ap.add_argument("--strategy", default="merged",
                    choices=["merged", "factored"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--task-seed", type=int, default=7)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without one)")
    args = ap.parse_args(argv)

    if args.strategy == "factored":
        raise NotImplementedError(
            "--strategy factored comes with a later slice (ROADMAP queue 1: "
            "the factored strategy); train merged adapters")
    device = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg).replace(vocab=min(cfg.vocab, 512))
    peft = PEFTConfig(method=args.method, n=args.n, alpha=args.alpha,
                      strategy=args.strategy)
    model = build(cfg, peft, remat=args.remat)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 10, 1),
                       microbatch=args.microbatch, seed=args.seed)
    print(f"arch={cfg.name} layers={cfg.num_layers} method={args.method} "
          f"device={device} trainable={model.trainable_params():,}")
    print(model.kernel_policy(device).explain())
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state, frozen = train_step.init_state(model, tcfg, args.seed, device)
    data = SyntheticLM(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                       seed=args.seed, task_seed=args.task_seed,
                       codebooks=cfg.n_codebooks)
    step_fn = train_step.make_train_step(model, tcfg)
    state, report = loop.run(
        step_fn, state, frozen, data, tcfg, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every if args.ckpt_dir else 0,
        resume=not args.no_resume, log_every=max(args.steps // 20, 1))
    print(f"done: steps={report.steps_run} final_loss={report.final_loss:.4f} "
          f"anomalies={report.anomalies} slow_steps={report.slow_steps}"
          + (f" (resumed from {report.resumed_from})"
             if report.resumed_from else ""))
    if report.step_s:
        warm = report.step_s[1:] or report.step_s
        ms = 1e3 * sum(warm) / len(warm)
        line = (f"time: first step {report.step_s[0] * 1e3:.1f} ms, later "
                f"steps {ms:.1f} ms mean, "
                f"{args.batch * args.seq / (ms / 1e3):.1f} tokens/s")
        if device.type == "cuda":
            from repro_torch.kernels import dct_deltaw as ddk
            from repro_torch.kernels import fourier_deltaw as fdk
            line += (f", peak device memory "
                     f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} "
                     f"GiB on {torch.cuda.get_device_name(device)}; kernel "
                     f"launches: K1 {fdk.launches}, K2 {fdk.dc_launches}, "
                     f"K4 {ddk.launches}, K5 {ddk.dc_launches}")
        print(line)


if __name__ == "__main__":
    main()
