"""The hot paths the dispatch lint runs (the JAX package's
`src/repro/analysis/graphs.py`).

The dispatch lint needs a run to record. This module drives the two hot
paths the port ships through `dispatch_lint.DispatchRecorder`, on a given
device and at a given size:

- **train_step**: `train/step.py`'s merged step (yi-6b with FourierFT; at
  the reduced size n 16, α 10, width 64, vocab 64, the JAX suite's tiny
  recipe), each step one loop region, checked for host transfers,
  f32-literal upcasts and donation (every state tensor's `data_ptr()`
  before and after a step).
- **train_step/mesh**: the same step through the mesh path (`train/
  step.py`'s `shard_train_state` and `make_sharded_train_step`) on a
  one-rank process group: DTensors, the DTensor boundary of the ΔW
  (`dist.dtensor.sharded_delta`), the gradient reduction. The recorder
  sees the local ops and collectives DTensor issues.
- **serve**: a traffic replay through the paged `ContinuousScheduler`, and
  its `SelfDrafter(k=2)` variant, each scheduler round one loop region
  (named `decode` when it admitted nothing, else `admit`), checked for
  host transfers per round and against the scheduler's own
  `expected_compile_bounds()` contract — the decode loop is where one
  stray sync costs a stall PER TOKEN.

`run(device)` is the reduced pass the CLI runs (seconds on the CPU);
`lint_train` and `lint_serve` take any model and trace, so `chip_smoke.py`
runs the same pass at full width on the card.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis import dispatch_lint
from repro_torch.analysis.dispatch_lint import DispatchRecorder
from repro_torch.analysis.report import Finding


def tiny_train_model():
    from repro_torch import configs
    from repro_torch.configs.base import PEFTConfig
    from repro_torch.models import build
    cfg = configs.reduced(configs.get("yi-6b")).replace(vocab=64)
    return build(cfg, PEFTConfig(method="fourierft", n=16, alpha=10.0))


def tiny_serve_model():
    from repro_torch import configs
    from repro_torch.configs.base import PEFTConfig
    from repro_torch.models import build
    # f32 like the serving tests: bit-exactness there pins this recipe
    cfg = configs.reduced(configs.get("yi-6b")).replace(
        vocab=64, dtype="float32", param_dtype="float32")
    return build(cfg, PEFTConfig(method="none"))


def tiny_trace(budgets: Sequence[int], vocab: int = 64):
    """The JAX pass's tiny trace: request i has prompt (3i + j) mod vocab,
    j < 3 + i, and budget budgets[i]."""
    from repro_torch.serve import Request
    return [Request(prompt=torch.tensor([(3 * i + j) % vocab
                                         for j in range(3 + i)],
                                        dtype=torch.int32), max_new=b)
            for i, b in enumerate(budgets)]


def lint_train(model, params, batches: Sequence[Dict], device, mesh=None
               ) -> Tuple[List[Finding], DispatchRecorder]:
    """Run `len(batches)` merged train steps of `model` from `params`
    under a recorder, each a `train_step` region (`train_step/mesh`
    through the mesh path when `mesh`, a DeviceMesh, is given: state and
    batches placed by the rules); -> (host-transfer, upcast and donation
    findings, the recorder). The first step is recorded like the rest
    (nothing is compiled in eager PyTorch)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train import step as train_step
    label = "train_step" if mesh is None else "train_step/mesh"
    tcfg = TrainConfig(total_steps=max(4, len(batches)))
    state, frozen = train_step.state_from_params(model, params)
    if mesh is None:
        step = train_step.make_train_step(model, tcfg)
    else:
        state, frozen, _, _ = train_step.shard_train_state(
            model, state, frozen, mesh)
        step, b_sh = train_step.make_sharded_train_step(
            model, tcfg, mesh, batches[0])
        batches = [train_step.place_batch(b, b_sh, mesh, tcfg.microbatch)
                   for b in batches]
    rec = DispatchRecorder(device)
    out: List[Finding] = []
    with rec:
        for i, batch in enumerate(batches):
            before = dispatch_lint.data_ptrs(state)
            with rec.region(label, loop=True):
                state, _ = step(state, frozen, batch)
            if i == 0:
                out += dispatch_lint.donation_findings(before, state, label)
    out = rec.findings() + out
    return out, rec


def lint_serve(engine, requests, label: str, device,
               arrivals: Optional[Sequence[float]] = None,
               page_size: int = 8, drafter=None,
               on_round: Optional[Callable] = None
               ) -> Tuple[List[Finding], DispatchRecorder, object]:
    """Replay `requests` through a paged ContinuousScheduler over `engine`
    (with `drafter`, speculative), one loop region a scheduler round,
    named `<label>/decode` or `<label>/admit`. -> (host-transfer and
    recompile findings, the recorder, the scheduler). `on_round(events)`,
    when given, runs inside each round's region, after the round."""
    from repro_torch.serve import ContinuousScheduler
    sched = ContinuousScheduler(engine, page_size=page_size, drafter=drafter)
    rec = DispatchRecorder(device)
    for i, r in enumerate(requests):
        sched.submit(r, arrivals[i] if arrivals is not None else 0.0)
    sched.metrics.start()
    with rec:
        while len(sched.queue) or sched.slots.any_active():
            t_before = sched.t
            with rec.region(f"{label}/decode", loop=True) as reg:
                evs = sched.tick()
                if any(e[0] in ("admit", "resume") for e in evs):
                    reg.label = f"{label}/admit"
                if on_round is not None:
                    on_round(evs)
            if not evs and not sched.slots.any_active() \
                    and sched.t == t_before and len(sched.queue):
                raise RuntimeError("scheduler stalled: arrived requests "
                                   "cannot be admitted")
    sched.metrics.stop()
    out = [f for f in rec.findings() if f.where.startswith(label + "/")]
    out += dispatch_lint.scheduler_recompile_findings(sched, label)
    return out, rec, sched


def train_findings(device="cpu") -> List[Finding]:
    from repro_torch.data import SyntheticLM
    model = tiny_train_model()
    params = model.init(0, device)
    data = SyntheticLM(vocab=64, batch=2, seq=16, seed=0)
    batches = [{k: t.to(device) for k, t in data.batch_at(i).items()}
               for i in range(3)]
    return lint_train(model, params, batches, device)[0]


def one_rank_mesh(device):
    """(a 1x1 DeviceMesh over the process group, whether this call made
    the group): the group torchrun made, else a one-rank group of its own
    (gloo in process for the CPU, NCCL for the card)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    made = not dist.is_initialized()
    if made:
        dev = torch.device(device)
        if dev.type == "cuda":
            dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                    world_size=1)
        else:
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                    world_size=1)
    return mesh_mod.make_mesh((1, 1), ("data", "model")), made


def mesh_train_findings(device="cpu") -> List[Finding]:
    """`train_findings`' steps through the mesh path on a one-rank group
    (at world size 1 under torchrun, or a group made here and left)."""
    import torch.distributed as dist
    from repro_torch.data import SyntheticLM
    mesh, made = one_rank_mesh(device)
    try:
        model = tiny_train_model()
        params = model.init(0, device)
        data = SyntheticLM(vocab=64, batch=2, seq=16, seed=0)
        batches = [{k: t.to(device) for k, t in data.batch_at(i).items()}
                   for i in range(3)]
        return lint_train(model, params, batches, device, mesh=mesh)[0]
    finally:
        if made:
            dist.destroy_process_group()


def serve_findings(device="cpu") -> List[Finding]:
    from repro_torch.serve import Engine, SelfDrafter
    model = tiny_serve_model()
    params = model.init(0, device)
    out: List[Finding] = []
    eng = Engine(model, params, batch_slots=2, max_len=32, device=device)
    out += lint_serve(eng, tiny_trace([3, 2, 4]), "serve/paged", device)[0]
    eng2 = Engine(model, params, batch_slots=2, max_len=32, device=device)
    out += lint_serve(eng2, tiny_trace([4, 3]), "serve/spec", device,
                      drafter=SelfDrafter(k=2))[0]
    return out


def run(device="cpu") -> List[Finding]:
    out = train_findings(device) + serve_findings(device)
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() == 1:
        out += mesh_train_findings(device)
    return out
