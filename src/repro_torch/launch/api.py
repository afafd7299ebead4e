"""OpenAI-compatible serving gateway launcher:
`python -m repro_torch.launch.api --arch <id> [...]` (the JAX package's
`launch/api.py`).

Boots the continuous-batching scheduler (paged KV cache, decode attention
through the hand-written paged-attention kernel on the card; optional
adapter bank, speculative decoding and tiering — the flags of
`repro_torch.launch.serve --continuous`) behind the asyncio HTTP gateway:
`/v1/chat/completions` and `/v1/completions` with SSE streaming, per-tenant
adapter routing through the `model` field (`adapter:<id>` names resolve
through the bank, loading non-resident tenants from `--bank-dir` exports at
admission), backpressure 429s past `--max-queue`, and `/metrics` in
Prometheus text.

`build_scheduler(args)` is importable: a replay check rebuilds the same
engine from the same flags and serves the collected traffic in process,
and the gateway's streams must equal it token for token.

It runs on `cuda` unless `--device` says otherwise, and fails when there is
no CUDA device and no `--device`. The weights are random, made from
`--seed`. `--model-parallel` and `--sharding-plan` are the JAX launcher's
mesh flags: the engine routes through the mesh path and places its params
and caches by the plan. Under `torchrun` every rank builds the same
scheduler; rank 0 runs the gateway, and its pump broadcasts each round's
submissions and cancellations to the other ranks, which follow it
(`serve/gateway/bridge.py`: `RankSync`, `follow`) and open no socket.

    python -m repro_torch.launch.api --arch yi-6b --reduced \\
        --export-demo-bank /tmp/demo --device cpu
    python -m repro_torch.launch.api --arch yi-6b --reduced \\
        --bank-dir /tmp/demo --port 8080 --device cpu
    curl -N localhost:8080/v1/chat/completions -d '{"model": "base", \\
        "messages": [{"role": "user", "content": "hi"}], "stream": true}'
"""
from __future__ import annotations

import argparse
import asyncio
import os
import signal

import torch

from repro_torch import configs
from repro_torch.configs.base import PEFTConfig
from repro_torch.devices import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import build


def add_model_args(ap: argparse.ArgumentParser) -> None:
    """Engine/scheduler flags, shared with the replay check, so that it
    rebuilds exactly the served model."""
    ap.add_argument("--arch", default="yi-6b", choices=list(configs.ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth cut: serve this many layers at the arch's "
                         "widths (default: the arch's depth)")
    ap.add_argument("--dtype", default=None, choices=("bfloat16", "float32"),
                    help="weights and activations (default: the arch's); "
                         "float32, with TF32 off, makes streams exact "
                         "across batch compositions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots (continuous batch width)")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--dense-cache", action="store_true",
                    help="dense per-slot KV cache instead of paged")
    ap.add_argument("--bank-dir", default=None,
                    help="adapter-only export dir: serve a multi-tenant "
                         "bank routed by model name (adapter:<id>)")
    ap.add_argument("--bank-capacity", type=int, default=8)
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop token (finish_reason 'stop'); default none")
    ap.add_argument("--speculative", action="store_true")
    ap.add_argument("--drafter", default="self", choices=("self", "ngram"))
    ap.add_argument("--draft-k", type=int, default=4)
    # tiered-memory serving (serve/tiering)
    ap.add_argument("--n-pages", type=int, default=None,
                    help="constrain the device page pool (default: enough "
                         "for every slot at max_len)")
    ap.add_argument("--preempt", action="store_true",
                    help="evict lower-class slots under pressure instead "
                         "of deferring higher-class admissions")
    ap.add_argument("--preempt-mode", default="auto",
                    choices=("auto", "swap", "recompute"),
                    help="victim KV disposition (auto = cost estimate)")
    ap.add_argument("--host-kv-pages", type=int, default=0,
                    help="host-memory KV tier capacity in pages (0 "
                         "disables): swap snapshots and demoted prefix pages")
    ap.add_argument("--host-adapter-slots", type=int, default=0,
                    help="host-memory adapter tier rows (0 disables): bank "
                         "evictions spill here; admission refills without "
                         "re-reading the checkpoint")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without one)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="TP axis size; remaining devices replicate/batch")
    ap.add_argument("--sharding-plan", default="rules",
                    help="rules|search|<plan.json>: where placements come "
                         "from (dist/plan.py); search runs the planner once "
                         "at startup")


def _model_cfg(args):
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg).replace(vocab=min(cfg.vocab, 512))
    if args.layers is not None:
        cfg = cfg.replace(num_layers=args.layers)
    if args.dtype is not None:
        cfg = cfg.replace(dtype=args.dtype, param_dtype=args.dtype)
    return cfg


def export_demo_bank(args, directory: str) -> None:
    """Write two synthetic tenants (`t0` fourierft, `t1` lora) compatible
    with the model the flags build — something to route at
    (`adapter:t0`, `adapter:t1`) without a training run. Made on the CPU
    from `--seed`: the export is the same whatever `--device` says."""
    from repro_torch.checkpoint import adapters as adapter_ckpt
    from repro_torch.core import adapter as adapter_api
    from repro_torch.core import peft as peft_mod

    model = build(_model_cfg(args), PEFTConfig(method="none"))
    profiles = {
        "fourierft": PEFTConfig(method="fourierft", n=16, alpha=25.0,
                                param_dtype="float32"),
        "lora": PEFTConfig(method="lora", lora_r=2, param_dtype="float32"),
    }
    for i, (tid, m) in enumerate(zip(("t0", "t1"), ("fourierft", "lora"))):
        prof = profiles[m]
        gen = torch.Generator()
        gen.manual_seed(args.seed + 10 + i)
        tree = peft_mod.init_adapters(gen, model.sites, prof, "cpu")
        trainable = set(adapter_api.resolve(m).trainable_leaves(prof))
        tree = {s: {k: v + 0.05 for k, v in d.items() if k in trainable}
                for s, d in tree.items()}
        adapter_ckpt.export_adapter(directory, tid, tree, prof)
    print(f"exported demo tenants "
          f"{adapter_ckpt.list_adapters(directory)} -> {directory}")


def build_scheduler(args):
    """(ContinuousScheduler, tenant ids) from parsed model args —
    deterministic in the flags: two builds from equal flags serve the same
    streams (the replay check leans on this)."""
    from repro_torch.launch.serve import open_bank
    from repro_torch.serve import (
        ContinuousScheduler, Engine, NGramDrafter, SelfDrafter, TieringConfig,
    )

    device = resolve_device(args.device)
    mesh_mod.init_from_env(device)
    mesh = mesh_mod.make_host_mesh(model=args.model_parallel)
    cfg = _model_cfg(args)
    model = build(cfg, PEFTConfig(method="none"))
    if not model.supports_slot_cache:
        raise SystemExit(
            f"{cfg.name} ({cfg.family}) has no per-slot cache path, which "
            "the gateway's continuous scheduler needs: serve it lockstep "
            "with repro_torch.launch.serve")
    params = model.init(args.seed, device)
    bank, tenant_ids = None, []
    if args.bank_dir:
        bank, tenant_ids = open_bank(model, args.bank_dir,
                                     args.bank_capacity, device)
    engine = Engine(model, params, batch_slots=args.slots,
                    max_len=args.max_len, bank=bank, device=device,
                    mesh=mesh, plan=args.sharding_plan)
    drafter = None
    if args.speculative:
        drafter = (SelfDrafter(k=args.draft_k) if args.drafter == "self"
                   else NGramDrafter(k=args.draft_k))
    tiering = None
    if args.preempt or args.host_kv_pages or args.host_adapter_slots:
        tiering = TieringConfig(host_kv_pages=args.host_kv_pages,
                                host_adapter_slots=args.host_adapter_slots,
                                preempt=args.preempt,
                                mode=args.preempt_mode)
    sched = ContinuousScheduler(engine, eos_id=args.eos_id,
                                paged=not args.dense_cache,
                                page_size=args.page_size,
                                n_pages=args.n_pages, drafter=drafter,
                                tiering=tiering)
    return sched, tenant_ids


def rank_sync():
    """The pump's broadcast across the process group's ranks (a gloo
    group, made on every rank alike), or None without a group."""
    import torch.distributed as dist
    from repro_torch.serve.gateway.bridge import RankSync
    if not dist.is_initialized():
        return None
    return RankSync(dist.new_group(backend="gloo"))


async def _run(args, sched, tenant_ids, sync) -> None:
    from repro_torch.serve.gateway import GatewayServer

    server = GatewayServer(
        sched, eos_id=args.eos_id, max_queue=args.max_queue,
        min_free_page_frac=args.min_free_page_frac,
        retry_after_s=args.retry_after,
        request_timeout_s=args.timeout,
        default_max_new=args.default_max_new, sync=sync)
    await server.start(args.host, args.port)
    print(f"gateway listening on {server.url} "
          f"({len(tenant_ids)} tenants, {sched.n_slots} slots, "
          f"max_len {sched.max_len}, {sched.device}, "
          f"{mesh_mod.world_size()} ranks, pid {os.getpid()})", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    try:
        await stop.wait()
    finally:
        print("gateway shutting down", flush=True)
        await server.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    add_model_args(ap)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080,
                    help="0 picks an ephemeral port (printed at startup)")
    ap.add_argument("--max-queue", type=int, default=32,
                    help="queued-request watermark: at/above it new "
                         "requests get 429 + Retry-After")
    ap.add_argument("--min-free-page-frac", type=float, default=0.0,
                    help="page-pool watermark: with a non-empty queue and "
                         "less than this fraction free, 429 (0 disables)")
    ap.add_argument("--retry-after", type=float, default=1.0,
                    help="Retry-After seconds advertised on 429")
    ap.add_argument("--timeout", type=float, default=None,
                    help="per-request deadline in seconds (cancels the "
                         "request mid-stream on overrun)")
    ap.add_argument("--default-max-new", type=int, default=16)
    ap.add_argument("--export-demo-bank", metavar="DIR", default=None,
                    help="write two synthetic tenants for the model flags "
                         "into DIR and exit (no server)")
    args = ap.parse_args(argv)
    if args.export_demo_bank:
        export_demo_bank(args, args.export_demo_bank)
        return
    sched, tenant_ids = build_scheduler(args)
    sync = rank_sync()
    import torch.distributed as dist
    try:
        if sync is not None and dist.get_rank() != 0:
            from repro_torch.serve.gateway.bridge import follow
            # rank 0 decides the shutdown and broadcasts it: a signal to
            # the whole group must not stop a follower first
            for sig in (signal.SIGINT, signal.SIGTERM):
                signal.signal(sig, signal.SIG_IGN)
            follow(sched, sync)       # no socket: rank 0 serves
        else:
            asyncio.run(_run(args, sched, tenant_ids, sync))
    finally:
        mesh_mod.shutdown()


if __name__ == "__main__":
    main()
