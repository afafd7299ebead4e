"""Dry-run library: run one rank's step of every (arch × shape × mesh) cell
on fake tensors inside a fake process group, with the production
placements, and derive per-device op statistics, memory and the roofline
terms (the JAX package's `launch/dryrun_lib.py`).

JAX forces 512 host devices and compiles each cell; PyTorch has no
compile-only path. Here a cell runs for real, on rank 0 of a fake process
group of 256 (16x16) or 512 (2x16x16) ranks (`torch.distributed`'s "fake"
backend: collectives return at once), its tensors `FakeTensor`s (shapes,
dtypes and a device; no storage), its placements DTensors over an
`init_device_mesh` of that group. What one rank dispatches is what every
rank does (SPMD), so:

- `dist.opstats.OpStats` counts the step's flops, bytes and collectives
  per device (the counterpart of `dist/hlo.py` over the compiled HLO; the
  hand-written kernels as one op each, `kernels.custom_ops.COSTS`);
- `MemoryTracker` records the argument, output, aliased and temporary
  bytes and the peak of live bytes on this rank (the counterpart of
  `memory_analysis()`).

A process group is global, so a cell runs in a process of its own
(`launch/dryrun.py` starts one per cell; `run_cell` initializes the group
and refuses to run where one exists).

Two routes. `card` (the default) traces what the card runs: fake CUDA
tensors, the merged ΔW through K1/K2 (`kernels.custom_ops`), K3 where a
paged cache decodes. Autograd on fake CUDA tensors needs a CUDA build of
torch (no card), so off one the card route refuses and `plain` traces the
plain versions (`kernel_backend="einsum"`) on fake CPU tensors — the
route the tests hold against the JAX package's dry run, which lowers its
einsum ΔW on CPU devices.

The result JSON keeps the JAX package's keys, except `xla_cost_analysis`
(XLA's own unscaled cost analysis, which has no counterpart here);
`compile_seconds` is the trace's wall time, and `route`, `kernel_counts`
and `leaf_specs` (each argument leaf's spec) are added. The constants are the H100's
(`dist/cost_model.py`): the bf16 tensor-core peak, the HBM rate, NVLink
for `data` and `model` and InfiniBand for `pod`; `fits_hbm` compares the
peak with the card's memory, or the data sheet's 80 GB without a card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import time
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.configs.base import (ModelConfig, PEFTConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.dist import cost_model
from repro_torch.dist import opstats
from repro_torch.dist import plan as plan_mod
from repro_torch.dist import sharding as shd
from repro_torch.dist.dtensor import is_dtensor, local_shape_and_offset
from repro_torch.dist.sharding import P, axis_size
from repro_torch.models.registry import Model, build
from repro_torch.train import step as train_step_mod
from repro_torch.tree import tree_leaves, tree_map

PEAK_FLOPS = cost_model.PEAK_FLOPS          # bf16 tensor cores, FLOP/s
HBM_BW = cost_model.HBM_BW                  # bytes/s
LINK_BW = {axis: link.beta_bytes_s          # per axis: NVLink, IB for pod
           for axis, link in cost_model.DEFAULT_LINKS.items()}

# per-device activation-boundary budget for auto-microbatch (the JAX
# package's policy, kept so both packages pick the same factor)
ACT_BUDGET_BYTES = 4e9

ROUTES = ("card", "plain")


def long_context_skip(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k runs only for sub-quadratic (SSM/hybrid) archs."""
    return shape.name == "long_500k" and not cfg.subquadratic


def auto_microbatch(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """Gradient-accumulation factor so the per-device scan-boundary
    activation set (L · B_mb_local · S · d · 2 B) fits the budget."""
    baxes = shd.batch_axes(mesh, shape.global_batch)
    nshard = int(np.prod([axis_size(mesh, a) for a in baxes])) or 1
    b_loc = shape.global_batch // nshard
    budget = ACT_BUDGET_BYTES / (2 if cfg.moe is not None else 1)

    def per_mb(k):
        return (cfg.num_layers * max(b_loc // k, 1) * shape.seq_len
                * cfg.d_model * 2)
    k = 1
    while k < b_loc and per_mb(k) > budget:
        k *= 2
    return 0 if k == 1 else k


def _strip_axis(spec: P, axis: str) -> P:
    """Drop one mesh axis from a spec (the gathered copy of an
    FSDP-scattered weight loses its `data` shard)."""
    out = []
    for e in tuple(spec):
        if e == axis:
            out.append(None)
        elif isinstance(e, tuple):
            kept = tuple(a for a in e if a != axis)
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            out.append(e)
    return P(*out)


def make_constrain(mesh, cfg: ModelConfig, fsdp: bool = False,
                   source: Optional[plan_mod.PlanSource] = None):
    """The `Model.constrain` hook (the JAX package's, spec for spec): the
    MoE dispatch buffer 2-D expert-parallel (`moe/dispatch`: sequences
    over the batch axes, experts over `model`) and its combined tokens
    batch-sharded (`moe/tokens`); activations at layer boundaries
    batch-sharded (`act/hidden`; qwen2-vl-72b's d_model ≥ 8000 also shards
    S over `model`); under FSDP each weight slice gathered over `data`
    inside the layer loop (`fsdp_gather/<name>`); any other path the
    source's storage spec. A DTensor is redistributed to the spec's
    placements; a plain tensor passes through. `constrain.spec(path, x)`
    is the spec alone."""
    source = source or plan_mod.RulesSource()
    seq_parallel = cfg.d_model >= 8000

    def spec(path: str, x) -> Optional[P]:
        if path == "moe/dispatch":
            bax = shd.batch_axes(mesh, x.shape[0])
            return P(bax if bax else None,
                     shd._maybe(x.shape[1], mesh, "model"), None, None)
        if path == "moe/tokens":
            bax = shd.batch_axes(mesh, x.shape[0])
            return P(bax if bax else None, None, None)
        if path.startswith("act/"):
            bax = shd.batch_axes(mesh, x.shape[0])
            sax = ("model" if (seq_parallel and x.ndim == 3
                               and x.shape[1] % axis_size(mesh, "model") == 0
                               and x.shape[1] > 1) else None)
            return P(bax if bax else None, sax, *([None] * (x.ndim - 2)))
        if path.startswith("fsdp_gather/"):
            if not fsdp:
                return None
            return _strip_axis(source.param_spec(
                path[len("fsdp_gather/"):], tuple(x.shape), mesh, cfg,
                fsdp=False), "data")
        return source.param_spec(path, tuple(x.shape), mesh, cfg, fsdp=fsdp)

    def constrain(path: str, x):
        if not is_dtensor(x):
            return x
        sp = spec(path, x)
        if sp is None:
            return x
        return x.redistribute(x.device_mesh,
                              shd.placements(sp, x.device_mesh))

    constrain.spec = spec
    return constrain


def peft_for(cfg: ModelConfig, kind: str, route: str = "card") -> PEFTConfig:
    """train: the paper's technique (n=1000, merged). serve: adapters merged
    offline (method none) except the hybrid's shared-block adapters
    (factored by construction). The plain route asks for the plain ΔW."""
    backend = "auto" if route == "card" else "einsum"
    if kind == "train":
        return PEFTConfig(method="fourierft", n=1000, alpha=300.0,
                          strategy="merged", kernel_backend=backend)
    if cfg.family == "hybrid":
        return PEFTConfig(method="fourierft", n=1000, alpha=300.0,
                          strategy="factored", kernel_backend=backend)
    return PEFTConfig(method="none", kernel_backend=backend)


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    model: Model
    step_fn: object
    args: Tuple            # meta trees (shapes and dtypes of the inputs)
    specs: Tuple           # spec trees, one per argument
    donate: Tuple[int, ...]
    plan_source: Optional[plan_mod.PlanSource] = None
    fsdp: bool = False
    # a train step of k microbatches is traced as one microbatch's step on
    # B/k rows, its statistics counted k times (the JAX package's HLO
    # counts a scanned body times its trip count): `trace` holds that
    # step, its argument trees and their specs
    repeat: int = 1
    trace: Optional[Tuple] = None


def build_cell(arch: str, shape_name: str, mesh, *,
               peft: Optional[PEFTConfig] = None, remat: str = "full",
               microbatch: Optional[int] = None,
               sharding_plan=None, route: str = "card") -> Cell:
    """The cell's model, step function, argument trees (meta tensors) and
    their specs on `mesh` (a DeviceMesh or an abstract mesh).
    sharding_plan: rules|search|<plan.json> (or a resolved PlanSource) —
    which source places every tree of this cell."""
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; one of {ROUTES}")
    cfg = configs.get(arch)
    shape = configs.shape_for(shape_name)
    fsdp = shd.fsdp_default(cfg, mesh)
    if long_context_skip(cfg, shape):
        raise ValueError(f"{arch} skips {shape_name} (full attention)")
    workload = shape.kind

    def source_for(model):
        if isinstance(sharding_plan, plan_mod.PlanSource):
            return sharding_plan
        return plan_mod.resolve(sharding_plan, model=model, mesh=mesh,
                                shape=shape, workload=workload)

    if shape.kind == "train":
        model = build(cfg, peft or peft_for(cfg, "train", route),
                      remat=remat)
        src = source_for(model)
        model.constrain = make_constrain(mesh, cfg, fsdp, source=src)
        tcfg = TrainConfig(microbatch=(auto_microbatch(cfg, shape, mesh)
                                       if microbatch is None else microbatch))
        state, frozen = train_step_mod.state_from_params(
            model, model.init_shapes(), tcfg)
        batch = model.input_specs(shape)
        specs = (src.state_specs(state, mesh, cfg, fsdp),
                 src.state_specs(frozen, mesh, cfg, fsdp),
                 src.batch_specs(batch, mesh, shape))
        cell = Cell(arch, shape, model,
                    train_step_mod.make_train_step(model, tcfg),
                    (state, frozen, batch), specs, (0,), src, fsdp)
        k = tcfg.microbatch or 1
        if k > 1:
            mb = dataclasses.replace(shape,
                                     global_batch=shape.global_batch // k)
            mbatch = model.input_specs(mb)
            cell.repeat = k
            cell.trace = (
                train_step_mod.make_train_step(
                    model, dataclasses.replace(tcfg, microbatch=0)),
                (state, frozen, mbatch),
                specs[:2] + (src.batch_specs(mbatch, mesh, mb),))
        return cell
    model = build(cfg, peft or peft_for(cfg, "serve", route), remat="none")
    src = source_for(model)
    model.constrain = make_constrain(mesh, cfg, fsdp, source=src)
    params = model.init_shapes()
    batch = model.input_specs(shape)
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            return model.forward(params, batch)[:, -1].to(torch.float32)

        specs = (src.state_specs(params, mesh, cfg, fsdp),
                 src.batch_specs(batch, mesh, shape))
        return Cell(arch, shape, model, prefill_step, (params, batch), specs,
                    (), src, fsdp)

    def serve_step(params, cache, batch):
        # the lockstep cache's position is a Python int; the spec tree
        # carries it as the int32 scalar the JAX package's cache holds
        cache = {**cache, "pos": shape.seq_len - 1}
        return model.decode_step(params, cache, batch)

    cache = model.cache_specs(shape)
    specs = (src.state_specs(params, mesh, cfg, fsdp),
             src.cache_specs(cache, mesh, cfg, shape),
             src.batch_specs(batch, mesh, shape))
    return Cell(arch, shape, model, serve_step, (params, cache, batch),
                specs, (1,), src, fsdp)


# ---------------------------------------------------------------------------
# Fake tracing: placement of fake tensors, memory tracking
# ---------------------------------------------------------------------------

def _on_real_tensors(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes():
            return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def dtensor_metadata_on_real_tensors():
    """DTensor's sharding propagation, its redistribute planning and a
    strided shard's offsets work on metadata, but build small index
    tensors and read them back (under a fake mode those reads fail) and
    run ops on global shapes (which OpStats would count). Run them with
    every dispatch mode off: what they compute depends on no tensor's
    values."""
    from torch.distributed.tensor import _redistribute as rd
    from torch.distributed.tensor import _sharding_prop as sp
    from torch.distributed.tensor import placement_types as pt
    patched = []

    def patch(owner, name):
        raw = owner.__dict__.get(name) if isinstance(owner, type) \
            else getattr(owner, name, None)
        if raw is None:
            return
        if isinstance(raw, staticmethod):
            new = staticmethod(_on_real_tensors(raw.__func__))
        else:
            new = _on_real_tensors(raw)
        patched.append((owner, name, raw))
        setattr(owner, name, new)

    patch(sp.ShardingPropagator, "propagate")
    patch(sp.ShardingPropagator, "propagate_op_sharding_non_cached")
    patch(rd, "_gen_transform_infos")
    patch(rd, "_gen_transform_infos_non_cached")
    strided = getattr(pt, "_StridedShard", None)
    if strided is not None:
        patch(strided, "local_shard_size_and_offset")
    try:
        yield
    finally:
        for owner, name, raw in reversed(patched):
            setattr(owner, name, raw)


def fake_placed(tree, placements, mesh, device):
    """Meta tensors -> this rank's fake shards as DTensors on `mesh` (an
    empty fake local tensor of the shard's shape; nothing is materialized
    or moved). Call under the fake mode."""
    from torch.distributed.tensor import DTensor

    def one(t, pl):
        if not torch.is_tensor(t):
            return t
        lshape, _ = local_shape_and_offset(tuple(t.shape), mesh, pl)
        local = torch.empty(lshape, dtype=t.dtype, device=device)
        out = DTensor.from_local(local, mesh, pl, run_check=False,
                                 shape=t.shape,
                                 stride=torch.empty(t.shape,
                                                    device="meta").stride())
        return out.requires_grad_(t.requires_grad)
    return tree_map(one, tree, placements)


def _local_tensors(tree):
    for leaf in opstats._tensors(tree):
        yield leaf.to_local() if is_dtensor(leaf) else leaf


def _storage_bytes(tree) -> Dict[int, int]:
    out = {}
    for t in _local_tensors(tree):
        st = t.untyped_storage()
        out[id(st)] = st.nbytes()
    return out


class MemoryTracker(TorchDispatchMode):
    """Live bytes on this rank while a step runs: every storage an op
    creates counts from its creation until its last tensor dies (a
    finalizer on the storage). `memory()` -> JAX's memory_analysis keys:
    argument bytes (the inputs' local shards), output bytes, aliased bytes
    (outputs that are input storages: the in-place caches), temporary
    bytes (the peak of everything else alive beyond the new outputs) and
    the peak estimate args + temp + out - alias."""

    def __init__(self, args):
        super().__init__()
        self._args = _storage_bytes(args)
        self.argument_bytes = sum(self._args.values())
        self._seen = weakref.WeakKeyDictionary()
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs it; we see its locals
        out = func(*args, **(kwargs or {}))
        for t in opstats._tensors(out):
            st = t.untyped_storage()
            if id(st) in self._args or st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live += n
            weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)
        return out

    def memory(self, outputs) -> Dict:
        out = _storage_bytes(outputs)
        alias = sum(n for k, n in out.items() if k in self._args)
        output_bytes = sum(out.values())
        temp = max(0, self.peak - (output_bytes - alias))
        peak = self.argument_bytes + temp + output_bytes - alias
        return {"argument_bytes": int(self.argument_bytes),
                "output_bytes": int(output_bytes),
                "temp_bytes": int(temp), "alias_bytes": int(alias),
                "peak_estimate_bytes": int(peak)}


def trace_cell(cell: Cell, mesh, device: str):
    """Run the cell's step once on fake shards of its arguments under
    OpStats and a MemoryTracker. -> (ModuleStats, memory dict, seconds).
    `mesh`: a DeviceMesh over the (fake) process group."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.time()
    step, trees, specs = cell.trace or (cell.step_fn, cell.args, cell.specs)
    with FakeTensorMode(allow_non_fake_inputs=True), \
            dtensor_metadata_on_real_tensors():
        whole = tuple(fake_placed(a, shd.named(a, s, mesh), mesh, device)
                      for a, s in zip(cell.args, cell.specs))
        args = whole if cell.trace is None else tuple(
            fake_placed(a, shd.named(a, s, mesh), mesh, device)
            for a, s in zip(trees, specs))
        tracker = MemoryTracker(args)
        with opstats.OpStats() as rec, tracker:
            out = step(*args)
        mem = tracker.memory(out)
        mem = _with_arguments(mem, sum(_storage_bytes(whole).values()))
    return _repeated(rec.stats, cell.repeat), mem, time.time() - t0


def _with_arguments(mem: Dict, argument_bytes: int) -> Dict:
    """The memory record with the whole step's argument bytes."""
    out = dict(mem)
    out["peak_estimate_bytes"] += argument_bytes - mem["argument_bytes"]
    out["argument_bytes"] = int(argument_bytes)
    return out


def _repeated(stats: opstats.ModuleStats, k: int) -> opstats.ModuleStats:
    """Statistics of `k` repeats of the traced step (group sizes stay)."""
    if k == 1:
        return stats
    scaled = {key: (val * k if isinstance(val, (int, float))
                    else {g: v * k for g, v in val.items()})
              for key, val in dataclasses.asdict(stats).items()
              if key != "group_by_kind"}
    return opstats.ModuleStats(group_by_kind=dict(stats.group_by_kind),
                               **scaled)


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------

def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if torch.is_tensor(x))


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def backbone_params(model: Model) -> Tuple[int, int]:
    """(N_total_backbone, N_active_backbone): the base's leaves without
    embed/lm_head; an MoE expert weight counts top_k / num_experts of
    itself as active."""
    shapes = model._mod.init_params(torch.Generator(), model.cfg, "meta")
    total = active = 0
    cfg = model.cfg
    for path, leaf in _walk(shapes):
        last = path.split("/")[-1]
        if last in ("embed", "lm_head"):
            continue
        n = int(np.prod(leaf.shape))
        total += n
        if last.startswith("we_") and cfg.moe is not None:
            active += n * cfg.moe.top_k // cfg.moe.num_experts
        else:
            active += n
    return total, active


def model_flops(model: Model, shape: ShapeConfig) -> float:
    """Useful-work convention: 6·N_active·tokens (train), 2·N_active·tokens
    (prefill, and decode at one token a sequence)."""
    _, n_active = backbone_params(model)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def collective_seconds(stats: opstats.ModuleStats, mesh) -> float:
    """Each collective's bytes over the link of the mesh axis its group
    spans (matched by group size; on a tie the slower link)."""
    axes = shd.mesh_axes(mesh)
    t = 0.0
    for size, nbytes in stats.bytes_by_group.items():
        links = [LINK_BW.get(a, LINK_BW["model"])
                 for a, s in axes.items() if s == int(size)]
        t += nbytes / (min(links) if links else LINK_BW["pod"])
    return t


def analyze(cell: Cell, stats: opstats.ModuleStats, memory: Dict, mesh,
            seconds: float, route: str = "card",
            hbm_bytes: Optional[float] = None) -> Dict:
    chips = cost_model.MeshSpec.from_mesh(mesh).size
    flops_dev = float(stats.flops)
    bytes_dev = float(stats.bytes_min)
    bytes_dev_upper = float(stats.bytes)
    coll_dev = float(stats.collective_bytes)
    t_compute = flops_dev / PEAK_FLOPS
    # the memory term counts only materializing ops (fused elementwise
    # chains); every op's reads and writes are the upper bound beside it
    t_memory = bytes_dev / HBM_BW
    t_coll = collective_seconds(stats, mesh)
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "memory_s_upper": bytes_dev_upper / HBM_BW,
             "collective_s": t_coll}
    dominant = max(
        {k: terms[k] for k in ("compute_s", "memory_s", "collective_s")},
        key=terms.get)
    mf = model_flops(cell.model, cell.shape)
    useful_ratio = mf / (flops_dev * chips) if flops_dev else 0.0
    bound = max(t_compute, t_memory, t_coll)
    ideal = mf / (chips * PEAK_FLOPS)
    roofline_frac = ideal / bound if bound > 0 else 0.0
    if hbm_bytes is None:
        hbm_bytes = cost_model.device_hbm_bytes()
    mem = dict(memory)
    mem["fits_hbm"] = bool(mem["peak_estimate_bytes"] < hbm_bytes)
    mem["hbm_bytes"] = float(hbm_bytes)
    plan_info = None
    if cell.plan_source is not None:
        plan_info = dict(cell.plan_source.describe())
        try:
            from repro_torch.dist import planner
            plan_info["predicted"] = planner.score_source(
                cell.model, cost_model.MeshSpec.from_mesh(mesh), cell.shape,
                cell.plan_source).to_json()
        except Exception as e:           # a prediction never sinks a run
            plan_info["predicted_error"] = f"{type(e).__name__}: {e}"
    return {
        "arch": cell.arch,
        "shape": cell.shape.name,
        "kind": cell.shape.kind,
        "mesh": "x".join(str(s) for s in shd.mesh_axes(mesh).values()),
        "chips": chips,
        "route": route,
        "flops_per_device": flops_dev,
        "dot_flops_per_device": float(stats.dot_flops),
        "bytes_per_device": bytes_dev,
        "bytes_per_device_upper": bytes_dev_upper,
        "collective_bytes_per_device": coll_dev,
        "collectives": dict(stats.bytes_by_kind),
        "collective_counts": dict(stats.count_by_kind),
        "kernel_counts": dict(stats.kernel_counts),
        "terms": terms,
        "dominant": dominant,
        "model_flops": mf,
        "useful_flops_ratio": useful_ratio,
        "roofline_fraction": roofline_frac,
        "memory": mem,
        "compile_seconds": seconds,
        "sharding_plan": plan_info,
    }


# ---------------------------------------------------------------------------
# One cell in this process
# ---------------------------------------------------------------------------

def card_route_available() -> bool:
    """The card route traces fake CUDA tensors through autograd, which a
    CPU-only build of torch cannot (no card is needed)."""
    return torch.version.cuda is not None


def init_fake_group(world: int) -> None:
    """Rank 0 of a fake process group of `world` ranks (collectives return
    at once, nothing leaves the process)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized: a "
                           "dry-run cell needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def mesh_dims(multi_pod: bool, mesh_shape: Optional[str] = None):
    from repro_torch.launch.mesh import parse_mesh_shape
    if mesh_shape:
        return parse_mesh_shape(mesh_shape)
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def cell_tag(arch: str, shape_name: str, multi_pod: bool,
             variant: str = "baseline") -> str:
    tag = f"{arch}__{shape_name}__{'multi' if multi_pod else 'single'}"
    return tag if variant == "baseline" else f"{tag}__{variant}"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = None, *,
             peft: Optional[PEFTConfig] = None, variant: str = "baseline",
             remat: str = "full", microbatch: Optional[int] = None,
             mesh_shape: Optional[str] = None, sharding_plan=None,
             route: str = "card") -> Dict:
    """One cell on rank 0 of a fake group of the mesh's size (initialized
    here: one cell a process). mesh_shape: an optional "DxM" remap of the
    same ranks (perf variants); sharding_plan: rules|search|<plan.json>."""
    from torch.distributed.device_mesh import init_device_mesh
    if route == "card" and not card_route_available():
        raise SystemExit("the card route traces fake CUDA tensors through "
                         "autograd and needs a CUDA build of torch (no "
                         "card); --route plain traces the plain versions")
    import torch.distributed as dist
    dims, axes = mesh_dims(multi_pod, mesh_shape)
    init_fake_group(int(np.prod(dims)))
    try:
        device = "cuda" if route == "card" else "cpu"
        mesh = init_device_mesh(device, dims, mesh_dim_names=axes)
        cell = build_cell(arch, shape_name, mesh, peft=peft, remat=remat,
                          microbatch=microbatch,
                          sharding_plan=sharding_plan, route=route)
        stats, memory, seconds = trace_cell(cell, mesh, device)
        result = analyze(cell, stats, memory, mesh, seconds, route)
        result["leaf_specs"] = leaf_specs(cell)
    finally:
        # the group is this cell's: the next cell of this process (the
        # tests' mini sweep) makes its own
        dist.destroy_process_group()
    result["variant"] = variant
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = cell_tag(arch, shape_name, multi_pod, variant)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def leaf_specs(cell: Cell) -> Dict[str, Tuple]:
    """{argument index/leaf path: spec as a tuple} of every tensor leaf of
    the cell's arguments (what the tests hold to the JAX package's
    in_shardings)."""
    out = {}
    for i, specs in enumerate(cell.specs):
        for path, sp in _walk_specs_flat(specs):
            out[f"{i}/{path}"] = tuple(sp)
    return out


def _walk_specs_flat(tree, prefix=""):
    if isinstance(tree, P):
        yield prefix[:-1], tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk_specs_flat(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk_specs_flat(v, f"{prefix}{i}/")

