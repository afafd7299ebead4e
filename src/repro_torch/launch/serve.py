"""Serving launcher: `python -m repro_torch.launch.serve --arch <id> [...]`.

Builds a model of any token-input family (dense, moe, audio with
codebooks, mamba2, zamba2) with an adapter on its default targets
(`--method`, FourierFT by default) from a seed, optionally restores
trained coefficients from a `launch.train` checkpoint (`--adapters <ckpt
dir>`), merges every ΔW into the base (on the card through the method's
hand-written ΔW kernel), and
decodes demo prompts through the slot engine. With `--continuous` it
replays a staggered-arrival, mixed-`max_new` trace through the
continuous-batching scheduler over the paged KV cache (decode attention
through the hand-written paged-attention kernel on the card) and prints
per-request outputs plus serving metrics. Prompts and trace are the JAX
launcher's.

With `--bank-dir` it serves a multi-tenant adapter bank instead: every
adapter-only export in the directory (checkpoint/adapters.py, any method)
joins the bank's groups, up to `--bank-capacity` of them are loaded
resident, and the demo prompts (or, with `--continuous`, the trace's
requests) cycle over the tenants; the scheduler loads and evicts the rest
at admission. Without `--adapters` the bank runs over the clean base; with
it the trained adapter is merged into the base first (K1 on the card) and
the bank attaches on top.

With `--continuous --speculative` the scheduler decodes draft-then-verify
(`--drafter self`: the base model drafts `--draft-k` tokens through the
decode step; `--drafter ngram`: prompt lookup on the host) and verifies
each window in one forward (on the card the paged-attention kernel at
W = k+1 rows). In f32 (TF32 off on the card) the streams are the plain
loop's; in bf16 on the card they can part from it where two logits nearly
tie. `--dense-cache` serves from the dense per-slot cache instead of the
paged one. The recurrent families (mamba2, zamba2) and codebook models
have no per-slot cache: they serve lockstep, and `--continuous` is refused
before any weight is made.

With `--continuous --preempt` (or a host tier) the scheduler serves tiered
(serve/tiering): a blocked higher-class request evicts a lower-class slot,
whose KV pages leave by a snapshot to pinned host memory (`--preempt-mode
swap`) or are recomputed at resume (`recompute`; `auto` picks by cost);
`--host-kv-pages` sizes the host tier for snapshots and demoted prefix
pages, `--host-adapter-slots` the one for evicted bank rows, `--n-pages`
constrains the device page pool, and `--interactive-every N` marks every
Nth request of the trace `interactive` (the rest stay `batch`, the JAX
launcher's trace). The preemption and host-tier counters are printed.

With `--continuous --analyze` it then prints the signatures each of the
scheduler's dispatch points handed the model (`compiled_signatures`) and
audits them against the scheduler's declared bounds, as the JAX launcher
does: `analyze: recompile audit clean`, or the findings and exit 1.

    python -m repro_torch.launch.serve --arch yi-6b --continuous
    python -m repro_torch.launch.serve --arch yi-6b --reduced --continuous \
        --device cpu
    python -m repro_torch.launch.serve --arch yi-6b --method dct \
        --adapters /tmp/dct --continuous
    python -m repro_torch.launch.serve --arch yi-6b --reduced \
        --bank-dir /tmp/tenants --bank-capacity 2 --continuous --device cpu
    python -m repro_torch.launch.serve --arch yi-6b --continuous \
        --speculative --drafter self --draft-k 4
    python -m repro_torch.launch.serve --arch yi-6b --reduced --continuous \
        --speculative --drafter ngram --dense-cache --device cpu
    python -m repro_torch.launch.serve --arch yi-6b --continuous --analyze
    python -m repro_torch.launch.serve --arch yi-6b --reduced --continuous \
        --preempt --n-pages 10 --page-size 8 --max-len 64 \
        --host-kv-pages 16 --interactive-every 3 --arrival-every 1 \
        --device cpu

Everything routes through the mesh path, as in the JAX launcher. Without a
process group the mesh is the one device and nothing is placed; under
`torchrun` the ranks form a (data, model) mesh with `--model-parallel`
ranks on `model`, and the engine places its params by `--sharding-plan`
(rules, search or a plan file), merges them on the mesh (each rank's ΔW
shard from K1 on local tensors) and places every cache by the plan's
cache specs: decode attention runs K3 on each rank's local KV heads.
Every rank serves the same trace; rank 0 prints.

    torchrun --nproc-per-node 1 -m repro_torch.launch.serve --arch yi-6b \
        --continuous --sharding-plan search
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --arch yi-6b \
        --reduced --continuous --model-parallel 2 --device cpu

Every family, and the adapter bank (its rows replicated), serves on a
mesh.

It runs on `cuda` unless `--device` says otherwise, and fails when there is
no CUDA device and no `--device`.
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch import configs
from repro_torch.checkpoint import adapters as adapter_ckpt
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import ModelConfig, PEFTConfig
from repro_torch.core import adapter as adapter_api
from repro_torch.devices import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import build
from repro_torch.serve import (AdapterBank, ContinuousScheduler, Engine,
                               NGramDrafter, Request, SelfDrafter,
                               TieringConfig)

# the tiering counters the launcher prints (ServingMetrics.COUNTERS)
TIERING_COUNTERS = ("preemptions", "preempt_swap", "preempt_recompute",
                    "resumed", "kv_pages_spilled", "kv_pages_filled",
                    "kv_fills_degraded", "prefix_host_hits",
                    "adapter_spills", "adapter_host_hits")
from repro_torch.train.step import join_params, split_params


def demo_prompts(cfg: ModelConfig, slots: int) -> List[torch.Tensor]:
    """The JAX launcher's demo prompts: slot i gets 4 + i tokens, tiled
    over the codebooks ((4 + i, CB)) for a codebook model."""
    prompts = [(torch.arange(4 + i, dtype=torch.int32) + 3 * i) % cfg.vocab
               for i in range(slots)]
    if cfg.n_codebooks:
        prompts = [p[:, None].repeat(1, cfg.n_codebooks) for p in prompts]
    return prompts


def demo_trace(prompts: List[torch.Tensor], n: int, max_new: int,
               arrival_every: float,
               tenants: Sequence[Optional[str]] = (),
               interactive_every: int = 0
               ) -> Tuple[List[Request], List[float]]:
    """The JAX launcher's replay trace: request i reuses prompt i mod
    len(prompts), asks for 1 + (5i + 3) mod max_new tokens, arrives at
    step i * arrival_every and, given `tenants`, is served by tenant
    i mod len(tenants). With `interactive_every` N > 0, requests N-1,
    2N-1, ... are `interactive` and the rest `batch`."""
    def priority(i):
        if interactive_every and (i + 1) % interactive_every == 0:
            return "interactive"
        return "batch"

    reqs = [Request(prompt=prompts[i % len(prompts)],
                    max_new=1 + (5 * i + 3) % max_new,
                    adapter_id=tenants[i % len(tenants)] if tenants else None,
                    priority=priority(i))
            for i in range(n)]
    return reqs, [i * arrival_every for i in range(n)]


def open_bank(model, bank_dir: str, capacity: int,
              device) -> Tuple[AdapterBank, List[str]]:
    """An AdapterBank over every export in `bank_dir`: one group per method
    (the first export of each method sets its profile), the first
    `capacity` loadable tenants resident. Returns (bank, every tenant id
    that matches its group's profile)."""
    tenant_ids = list(adapter_ckpt.list_adapters(bank_dir))
    if not tenant_ids:
        raise SystemExit(f"no adapter exports under {bank_dir}")
    manifests = {tid: adapter_ckpt.read_manifest(bank_dir, tid)
                 for tid in tenant_ids}
    profiles = {}
    for peft in manifests.values():
        profiles.setdefault(peft.method, peft)
    bank = AdapterBank(model, profiles, capacity=capacity,
                       checkpoint_dir=bank_dir, device=device)
    served = []
    for tid in tenant_ids:
        if not bank.matches(manifests[tid]):
            # e.g. the same method exported under another n or entry seed
            print(f"skipping tenant {tid!r}: its config does not match the "
                  f"{manifests[tid].method!r} group's")
            continue
        served.append(tid)
        if len(bank.resident_ids) < capacity:
            bank.load_from_checkpoint(tid)
    if not served:
        raise SystemExit("no loadable tenants for the bank profiles")
    return bank, served


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--method", default="fourierft",
                    choices=adapter_api.registered_methods())
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--alpha", type=float, default=300.0)
    ap.add_argument("--adapters", default=None,
                    help="checkpoint dir from repro_torch.launch.train "
                         "(--method/--n/--alpha must match its run)")
    ap.add_argument("--bank-dir", default=None,
                    help="adapter-only export dir: serve a multi-tenant bank")
    ap.add_argument("--bank-capacity", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--continuous", action="store_true",
                    help="replay a staggered-arrival trace through the "
                         "continuous-batching scheduler (paged KV cache)")
    ap.add_argument("--trace-n", type=int, default=12,
                    help="--continuous: number of replayed requests")
    ap.add_argument("--arrival-every", type=float, default=2.0,
                    help="--continuous: arrival gap in decode steps")
    ap.add_argument("--dense-cache", action="store_true",
                    help="--continuous: the dense per-slot KV cache instead "
                         "of the default paged cache")
    ap.add_argument("--page-size", type=int, default=16,
                    help="--continuous: paged-cache page size (tokens)")
    ap.add_argument("--speculative", action="store_true",
                    help="--continuous: draft-then-verify speculative "
                         "decoding; greedy outputs equal the plain loop's "
                         "in f32 (TF32 off on the card), and in bf16 on "
                         "the card can part from them where logits nearly "
                         "tie")
    ap.add_argument("--drafter", default="self", choices=("self", "ngram"),
                    help="--speculative: base-row self-drafter (the bank's "
                         "zero row) or host-side n-gram prompt lookup")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="--speculative: draft tokens per slot per step")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="--continuous: constrain the device page pool")
    ap.add_argument("--preempt", action="store_true",
                    help="--continuous: tiered scheduling — evict "
                         "lower-class slots under pressure instead of "
                         "deferring higher-class admissions")
    ap.add_argument("--preempt-mode", default="auto",
                    choices=("auto", "swap", "recompute"),
                    help="--preempt: victim KV disposition (auto = cost "
                         "estimate)")
    ap.add_argument("--host-kv-pages", type=int, default=0,
                    help="--continuous: host-memory KV tier pages (0 off): "
                         "swap snapshots and demoted prefix pages")
    ap.add_argument("--host-adapter-slots", type=int, default=0,
                    help="--continuous: host-memory adapter tier rows (0 "
                         "off): evicted bank rows reload without a "
                         "checkpoint read")
    ap.add_argument("--interactive-every", type=int, default=0,
                    help="--continuous: every Nth request of the trace is "
                         "`interactive` (0: all `batch`)")
    ap.add_argument("--analyze", action="store_true",
                    help="--continuous: after the replay, audit the live "
                         "scheduler's dispatch signature counts against its "
                         "declared bounds (repro_torch.analysis recompile "
                         "pass) and exit non-zero on any finding")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="TP axis size; remaining devices replicate/batch")
    ap.add_argument("--sharding-plan", default="rules",
                    help="rules|search|<plan.json>: where placements come "
                         "from (dist/plan.py); search runs the planner once "
                         "at startup")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without one)")
    args = ap.parse_args(argv)

    if args.analyze and not args.continuous:
        raise SystemExit("--analyze audits the continuous scheduler's "
                         "signatures: it needs --continuous")
    cfg = configs.get(args.arch)
    if not cfg.embed_inputs:
        raise SystemExit(f"{cfg.name} takes embeddings (batch['embeds']), "
                         "and this launcher has no embeddings source: it "
                         "serves token prompts only")
    device = resolve_device(args.device)
    mesh_mod.init_from_env(device)
    mesh = mesh_mod.make_host_mesh(model=args.model_parallel)
    say = mesh_mod.rank0_print
    if args.reduced:
        cfg = configs.reduced(cfg).replace(vocab=min(cfg.vocab, 512))
    # bank-only serving runs over the clean base: random-init adapters of a
    # live method would otherwise be merged into it before the bank attaches
    if args.bank_dir and not args.adapters:
        peft = PEFTConfig(method="none")
    else:
        peft = PEFTConfig(method=args.method, n=args.n, alpha=args.alpha)
    model = build(cfg, peft)
    if args.continuous and not model.supports_slot_cache:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) has no per-slot cache path, which "
            "--continuous needs: serve it lockstep (without --continuous)")
    params = model.init(args.seed, device)
    if args.adapters:
        state, at = ckpt.restore(args.adapters, device=device)
        _, frozen = split_params(model, params)
        params = join_params(model, state["trainable"], frozen)
        say(f"loaded adapters from step {at}")
    bank, tenants = None, []
    if args.bank_dir:
        bank, tenants = open_bank(model, args.bank_dir, args.bank_capacity,
                                  device)
        say(f"bank: {len(bank.resident_ids)} of {len(tenants)} tenants "
              f"resident over groups {sorted(bank.profiles)}, frozen "
              f"tables {bank.table_bytes / 2 ** 20:.2f} MiB")
    slots = max(2, len(bank.resident_ids)) if bank is not None else 2
    engine = Engine(model, params, batch_slots=slots, max_len=args.max_len,
                    bank=bank, device=device, mesh=mesh,
                    plan=args.sharding_plan)
    say(f"mesh={mesh_mod.describe(mesh)}")
    if engine.plan_source.kind != "rules":
        say(f"sharding plan: {engine.plan_source.describe()}")
    say(engine.kernel_policy.explain())
    prompts = demo_prompts(cfg, slots)
    if args.continuous:
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
        sched = ContinuousScheduler(engine, paged=not args.dense_cache,
                                    page_size=args.page_size,
                                    n_pages=args.n_pages, drafter=drafter,
                                    tiering=tiering)
        reqs, arrivals = demo_trace(prompts, args.trace_n, args.max_new,
                                    args.arrival_every, tenants,
                                    args.interactive_every)
        sched.serve(reqs, arrivals)
        for i, r in enumerate(reqs):
            tag = f" [{r.adapter_id}]" if r.adapter_id else ""
            if r.priority != "batch":
                tag += f" ({r.priority})"
            say(f"request {i}{tag} (arrival {arrivals[i]:g}, "
                  f"max_new {r.max_new}): {r.out}")
        if bank is not None:
            say(f"bank: {bank.loads} loads, resident "
                  f"{list(bank.resident_ids)}")
        s = sched.metrics.summary()
        say(f"continuous: {s['n_requests']:.0f} requests, "
              f"{s['total_tokens']:.0f} tokens in {s['steps']:.0f} steps | "
              f"occupancy {s['occupancy_mean']:.2f}, "
              f"ttft {s['ttft_steps_mean']:.1f} steps (p90 "
              f"{s['ttft_steps_p90']:.1f}), "
              f"{s['tokens_per_s']:.0f} tok/s on {device}")
        if "spec_accept_rate" in s:
            say(f"speculative ({args.drafter}, k={args.draft_k}): "
                  f"{s['spec_tokens_per_step']:.2f} tokens/step/slot, "
                  f"accept rate {s['spec_accept_rate']:.2f}, "
                  f"{s['spec_drafts_wasted']:.0f} drafts wasted over "
                  f"{s['spec_slot_steps']:.0f} slot-steps")
        if tiering is not None:
            say("tiering: " + " ".join(
                f"{k}={s[k + '_total']:.0f}" for k in TIERING_COUNTERS))
        if device.type == "cuda":
            from repro_torch.kernels import fourier_deltaw as fdk
            from repro_torch.kernels import paged_attention as pa
            say(f"kernel launches: K1 {fdk.launches}, K3 {pa.launches}")
        if args.analyze:
            from repro_torch.analysis import dispatch_lint
            found = dispatch_lint.scheduler_recompile_findings(sched)
            sigs = sched.compiled_signatures()
            say("analyze: compiled signatures "
                  + ", ".join(f"{k}={v}" for k, v in sorted(sigs.items())))
            for f in found:
                say(f.render())
            if found:
                raise SystemExit(1)
            say("analyze: recompile audit clean")
        mesh_mod.shutdown()
        return
    ids = None
    if bank is not None:
        resident = list(bank.resident_ids)
        ids = [resident[i % len(resident)] for i in range(slots)]
    outs = engine.generate(prompts, max_new=args.max_new, adapter_ids=ids)
    for i, o in enumerate(outs):
        tag = f" [{ids[i]}]" if ids else ""
        # repro: allow(host-sync-in-loop) — the demo prints its outputs
        say(f"prompt {i}{tag}: {o.tolist()}")
    mesh_mod.shutdown()


if __name__ == "__main__":
    main()
