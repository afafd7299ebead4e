"""Training launcher: `python -m repro_torch.launch.train --arch <id> [...]`.

Fine-tunes a model of any token-input family (dense, moe, audio with
codebooks, the pure-SSM mamba2-2.7b and the hybrid zamba2-7b) with any
registered method (`--method`) through the train step and the
fault-tolerant loop. mamba2's default targets are its in/out projections
(wx / wo_ssm); zamba2 adapts the shared block's q/v, applied factored once
per application. With the merged strategy (the
default) on the card, every FourierFT or `dct` step's forward materializes
ΔW with the method's hand-written ΔW kernel (K1 or K4) and its backward
takes the coefficients' gradient with its hand-written dc kernel (K2 or
K5). `--strategy factored` differentiates through the methods' factored
applies instead (no ΔW, no K1/K2); `--method full` (the FF baseline) trains
the whole base. Data is the step-keyed synthetic Markov task; `--ckpt-dir`
checkpoints every `--ckpt-every` steps and a rerun of the same command
resumes.

    python -m repro_torch.launch.train --arch yi-6b --steps 20
    python -m repro_torch.launch.train --arch yi-6b --reduced --steps 3 \
        --device cpu
    python -m repro_torch.launch.train --arch yi-6b --method dct \
        --steps 20 --ckpt-dir /tmp/dct
    python -m repro_torch.launch.train --arch yi-6b --reduced --steps 3 \
        --strategy factored --device cpu
    python -m repro_torch.launch.train --arch mamba2-2.7b --reduced \
        --steps 3 --device cpu

Everything routes through the mesh path, as in the JAX launcher. Without a
process group the mesh is the one device and placement is the identity;
under `torchrun` every rank joins the group (NCCL on the card, gloo with
`--device cpu`), the ranks form a (data, model) mesh with
`--model-parallel` ranks on `model`, and the state, the frozen base and
each batch are DTensors placed by `--sharding-plan` (rules, search or a
plan file; `--fsdp` forces FSDP over `data` on or off, auto by default).
`--grad-compression int8_ef` compresses the gradients the optimizer
receives with int8 error feedback. Rank 0 prints and writes checkpoints.

    torchrun --nproc-per-node 1 -m repro_torch.launch.train --arch yi-6b \
        --grad-compression int8_ef --sharding-plan search --steps 4
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch yi-6b \
        --reduced --model-parallel 2 --fsdp --grad-compression int8_ef \
        --sharding-plan search --steps 3 --device cpu

Every family trains on a mesh: moe expert-parallel (experts over
`model`), ssm and hybrid with the mixer on each rank's local heads.

It runs on `cuda` unless `--device` says otherwise, and fails when there is
no CUDA device and no `--device`.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import configs
from repro_torch.configs.base import PEFTConfig, ShapeConfig, TrainConfig
from repro_torch.core import adapter as adapter_api
from repro_torch.data import SyntheticLM
from repro_torch.devices import resolve_device
from repro_torch.dist import plan as plan_mod
from repro_torch.dist.dtensor import to_plain
from repro_torch.launch import mesh as mesh_mod
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
    ap.add_argument("--lora-r", type=int, default=8)
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
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="TP axis size; remaining devices form `data`")
    ap.add_argument("--fsdp", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="--fsdp forces FSDP on, --no-fsdp off; default "
                         "auto per dist.sharding.fsdp_default")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--sharding-plan", default="rules",
                    help="rules|search|<plan.json>: where placements come "
                         "from (dist/plan.py); search runs the planner once "
                         "at startup")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without one)")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if not cfg.embed_inputs:
        raise SystemExit(f"{cfg.name} takes embeddings (batch['embeds']), "
                         "and this launcher has no embeddings source: its "
                         "synthetic data is tokens")
    device = resolve_device(args.device)
    mesh_mod.init_from_env(device)
    # everything routes through the mesh path: a 1x1 mesh degenerates to
    # the single-device behavior, larger rank counts shard
    mesh = mesh_mod.make_host_mesh(model=args.model_parallel)
    say = mesh_mod.rank0_print
    if args.reduced:
        cfg = configs.reduced(cfg).replace(vocab=min(cfg.vocab, 512))
    peft = PEFTConfig(method=args.method, n=args.n, alpha=args.alpha,
                      lora_r=args.lora_r, strategy=args.strategy)
    model = build(cfg, peft, remat=args.remat)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 10, 1),
                       microbatch=args.microbatch, seed=args.seed,
                       grad_compression=args.grad_compression)
    say(f"arch={cfg.name} layers={cfg.num_layers} method={args.method} "
        f"device={device} mesh={mesh_mod.describe(mesh)} "
        f"trainable={model.trainable_params():,}")
    say(model.kernel_policy(device).explain())
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state, frozen = train_step.init_state(model, tcfg, args.seed, device)
    data = SyntheticLM(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                       seed=args.seed, task_seed=args.task_seed,
                       codebooks=cfg.n_codebooks)
    plan_src = plan_mod.resolve(
        args.sharding_plan, model=model, mesh=mesh,
        shape=ShapeConfig("runtime", args.seq, args.batch, "train"),
        workload="train")
    if plan_src.kind != "rules":
        say(f"sharding plan: {plan_src.describe()}")
    state, frozen, state_sh, _ = train_step.shard_train_state(
        model, state, frozen, mesh, fsdp=args.fsdp, plan=plan_src)
    step_fn, batch_sh = train_step.make_sharded_train_step(
        model, tcfg, mesh, data.batch_at(0), plan=plan_src)
    state, report = loop.run(
        step_fn, state, frozen, data, tcfg, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every if args.ckpt_dir else 0,
        resume=not args.no_resume, log_every=max(args.steps // 20, 1),
        mesh=mesh, batch_sharding=batch_sh, state_sharding=state_sh,
        log_fn=say)
    say(f"done: steps={report.steps_run} final_loss={report.final_loss:.4f} "
          f"anomalies={report.anomalies} slow_steps={report.slow_steps}"
          + (f" (resumed from {report.resumed_from})"
             if report.resumed_from else ""))
    say("losses: " + json.dumps(report.losses))
    # the trained leaves' norms, after the run; every rank joins the
    # gathers, rank 0 prints
    say("adapter_norms: " + json.dumps({
        # repro: allow(host-sync) — once, after the last step
        f"{site}/{leaf}": float(to_plain(t).float().norm())
        for site, ad in state["trainable"].get("peft", {}).items()
        for leaf, t in ad.items()}))
    say("step_ms: " + json.dumps([t * 1e3 for t in report.step_s]))
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
        say(line)
    mesh_mod.shutdown()


if __name__ == "__main__":
    main()
