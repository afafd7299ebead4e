"""Train-step factory: PEFT-filtered gradients, microbatch accumulation,
int8 error-feedback gradient compression, anomaly-guarded updates, and
the placement of the state on a mesh (the JAX package's `train/step.py`).

Parameters are split into (trainable, frozen). Gradients are taken with
`torch.autograd.grad` w.r.t. the trainable leaves only: the frozen base
needs no gradient of its own, and on the card the merged forward's ΔW
kernel hands the coefficients theirs through the dc kernel
(`kernels.ops.FourierDeltaW`). The factored strategy (`peft.strategy ==
"factored"`) differentiates through each method's `factored_apply` inside
the layers instead, and materializes no ΔW. The `full` method (the FF
baseline, `trains_base`) trains the whole base: every base leaf is
trainable and AdamW holds its state.

Anomaly guard (fault tolerance): a non-finite or exploding loss or gradient
norm skips the update (parameters and optimizer state keep their old
values, chosen on the device with `torch.where`) and increments
`anomalies`. A step reads nothing back to the host: the loop's one sync
per step is its read of the loss.

On a mesh (`shard_train_state`, `make_sharded_train_step`) the state, the
frozen base and each batch are DTensors placed by the plan's specs, and
the same step runs on them: DTensor partitions every op, the merged ΔW
goes through `dist.dtensor.sharded_delta` (K1/K2 on local tensors), and
the gradients, partial over the batch axes, are all-reduced once (f32)
before the optimizer. `int8_ef` compresses what the optimizer receives,
as the JAX step does (`dist/compression.py`).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.peft import trainable_adapter_tree
from repro_torch.devices import resolve_device
from repro_torch.dist import dtensor
from repro_torch.models.registry import Model
from repro_torch.optim import adamw, schedules
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def split_params(model: Model, params: Dict) -> Tuple[Dict, Dict]:
    """-> (trainable, frozen). frozen = {"base": ..., "peft": ... (frozen
    leaves)}. The trainable/frozen boundary inside each adapter dict comes
    from the method's `trainable_leaves`; `train_head` moves `lm_head`;
    `full` makes the whole base trainable."""
    peft = model.peft
    if model.method.trains_base:
        return {"base": params["base"]}, {"base": {}, "peft": {}}
    trainable: Dict = {"peft": trainable_adapter_tree(params["peft"], peft)}
    frozen_adapters = {
        site: {k: v for k, v in d.items()
               if k not in trainable["peft"].get(site, {})}
        for site, d in params["peft"].items()
    }
    base = params["base"]
    if peft.train_head:
        base = dict(base)
        trainable["head"] = base.pop("lm_head")
    return trainable, {"base": base, "peft": frozen_adapters}


def join_params(model: Model, trainable: Dict, frozen: Dict) -> Dict:
    return model.join(trainable, frozen)


GRAD_COMPRESSION = ("none", "int8_ef")


def _check_supported(tcfg: TrainConfig) -> None:
    if tcfg.grad_compression not in GRAD_COMPRESSION:
        raise ValueError(f"unknown grad_compression "
                         f"{tcfg.grad_compression!r}; one of "
                         f"{GRAD_COMPRESSION}")


def init_state(model: Model, tcfg: TrainConfig, seed: int,
               device=None) -> Tuple[Dict, Dict]:
    """-> (state, frozen) for params `model.init(seed)` made on `device`
    (default `cuda`; raises without a card unless the caller names a
    device)."""
    _check_supported(tcfg)
    return state_from_params(model, model.init(seed, resolve_device(device)),
                             tcfg)


def state_from_params(model: Model, params: Dict,
                      tcfg: TrainConfig = None) -> Tuple[Dict, Dict]:
    """-> (state, frozen). state = {step, trainable, opt, loss_ema,
    anomalies} (+ ef_residual when `tcfg` asks for int8 error-feedback
    compression) on the device of the params' trainable leaves."""
    trainable, frozen = split_params(model, params)
    dev = tree_leaves(trainable)[0].device
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "trainable": trainable,
        "opt": adamw.init(trainable),
        "loss_ema": torch.zeros((), dtype=torch.float32, device=dev),
        "anomalies": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if tcfg is not None and tcfg.grad_compression == "int8_ef":
        from repro_torch.dist import compression
        state["ef_residual"] = compression.init_residual(trainable)
    return state, frozen


def _loss_for(model: Model) -> Callable:
    def loss_f(trainable, frozen, batch):
        return model.loss_from_parts(trainable, frozen["base"],
                                     frozen["peft"], batch)
    return loss_f


def _value_and_grad(loss_f: Callable, trainable: Dict, frozen: Dict,
                    batch: Dict):
    """(loss, grads) with grads shaped like `trainable`, taken w.r.t. its
    leaves only (detached views that require grad; the frozen trees
    never do)."""
    live = [t.detach().requires_grad_(True) for t in tree_leaves(trainable)]
    with torch.enable_grad():
        loss = loss_f(tree_unflatten(trainable, live), frozen, batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, live)]
    return loss.detach(), tree_unflatten(trainable, grads)


def _microbatch(key: str, x: torch.Tensor, k: int, i: int) -> torch.Tensor:
    """Microbatch i of k of one batch entry, split along the batch axis:
    axis 1 of the (3, B, S) M-RoPE positions, axis 0 of everything else.
    A batch placed on a mesh (a DTensor, its rows sharded over the batch
    axes) takes every k-th row instead of k contiguous slices, so each
    rank splits the rows it holds without communication; `place_batch`
    ordered its rows so that these are JAX's contiguous microbatches."""
    strided = dtensor.is_dtensor(x)
    if key == "positions" and x.ndim == 3:
        if strided:
            return x.reshape((3, x.shape[1] // k, k) + x.shape[2:])[:, :, i]
        return x.reshape((3, k, x.shape[1] // k) + x.shape[2:])[:, i]
    if strided:
        return x.reshape((x.shape[0] // k, k) + x.shape[1:])[:, i]
    return x.reshape((k, x.shape[0] // k) + x.shape[1:])[i]


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """-> train_step(state, frozen, batch) -> (state, metrics). The first
    call checks that every targeted (site, op) of the model resolves to a
    backend on the state's device (a site the CUDA kernel cannot take
    raises there, before any work)."""
    _check_supported(tcfg)
    loss_f = _loss_for(model)
    validated = set()

    def grads_of(trainable, frozen, batch):
        k = tcfg.microbatch
        if not k or k <= 0:
            return _value_and_grad(loss_f, trainable, frozen, batch)
        # k contiguous slices of the batch (on a mesh, every k-th placed
        # row: the same slices, `place_batch`); losses and f32 gradients
        # are summed in order, then scaled by 1/k (JAX's scan over
        # microbatches)
        mbs = [{key: _microbatch(key, x, k, i) for key, x in batch.items()}
               for i in range(k)]
        ref = batch.get("tokens", batch.get("embeds"))
        loss = torch.zeros((), dtype=torch.float32, device=ref.device)
        grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         trainable)
        for mb in mbs:
            l, g = _value_and_grad(loss_f, trainable, frozen, mb)
            loss = loss + l
            grads = tree_map(torch.add, grads, g)
        scale = 1.0 / k
        return loss * scale, tree_map(lambda g: g * scale, grads)

    compress = tcfg.grad_compression == "int8_ef"
    if compress:
        from repro_torch.dist import compression

    def train_step(state: Dict, frozen: Dict, batch: Dict):
        device = state["step"].device
        if device not in validated:
            model.kernel_policy(device).validate()
            validated.add(device)
        # on a mesh: plain tensors meeting DTensors count as replicated
        with dtensor.ops_context(state):
            return _step(state, frozen, batch)

    def _step(state: Dict, frozen: Dict, batch: Dict):
        loss, grads = grads_of(state["trainable"], frozen, batch)
        # the gradient all-reduce over the batch axes, f32, once
        grads = tree_map(dtensor.reduce_partial, grads)
        if compress:
            # what the cross-node all-reduce would transport: int8 + carried
            # quantization residual (dist/compression.py)
            grads, new_residual = compression.compress_with_feedback(
                grads, state["ef_residual"])
        grads, gnorm = adamw.clip_by_global_norm(grads, tcfg.grad_clip)
        lr = schedules.lr_at(state["step"], tcfg)
        new_params, new_opt = adamw.update(grads, state["opt"],
                                           state["trainable"], lr, tcfg)
        bad = (~torch.isfinite(loss)) | (~torch.isfinite(gnorm)) \
            | (loss > tcfg.anomaly_threshold)
        keep_old = lambda new, old: tree_map(
            lambda n, o: torch.where(bad, o, n), new, old)
        ema = state["loss_ema"]
        state_out = {
            "step": state["step"] + 1,
            "trainable": keep_old(new_params, state["trainable"]),
            "opt": keep_old(new_opt, state["opt"]),
            "loss_ema": torch.where(
                state["step"] == 0, loss,
                0.99 * ema + 0.01 * torch.where(bad, ema, loss)),
            "anomalies": state["anomalies"] + bad.to(torch.int32),
        }
        if compress:
            state_out["ef_residual"] = keep_old(new_residual,
                                                state["ef_residual"])
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "skipped": bad.to(torch.int32)}
        return state_out, metrics

    return train_step


# ---------------------------------------------------------------------------
# Mesh placement (dist/plan.py sources; rules remain the default)
# ---------------------------------------------------------------------------

def _plan_source(plan):
    from repro_torch.dist import plan as plan_mod
    if plan is None or isinstance(plan, plan_mod.PlanSource):
        return plan or plan_mod.RulesSource()
    # a ShardingPlan object or a plan-file path
    if isinstance(plan, str):
        return plan_mod.PlanTableSource(plan_mod.ShardingPlan.load(plan))
    return plan_mod.PlanTableSource(plan)


def _state_placements(model: Model, tree: Dict, mesh, fsdp, src):
    from repro_torch.dist import sharding as shd
    return shd.named(tree, src.state_specs(tree, mesh, model.cfg, fsdp),
                     mesh)


def shard_train_state(model: Model, state: Dict, frozen: Dict, mesh,
                      fsdp: bool = None, plan=None):
    """Place (state, frozen) on `mesh` per the resolved plan source
    (`plan`: None/rules | PlanSource | ShardingPlan | plan-file path;
    `fsdp` None = `sharding.fsdp_default`). Returns (state, frozen,
    state_placements, frozen_placements): DTensors on a DeviceMesh, the
    trees unchanged on the abstract one-device mesh."""
    from repro_torch.dist import sharding as shd
    src = _plan_source(plan)
    if fsdp is None:
        fsdp = shd.fsdp_default(model.cfg, mesh)
    st_sh = _state_placements(model, state, mesh, fsdp, src)
    fr_sh = _state_placements(model, frozen, mesh, fsdp, src)
    return (shd.distribute(state, st_sh, mesh),
            shd.distribute(frozen, fr_sh, mesh), st_sh, fr_sh)


def microbatch_order(batch: Dict, k: int) -> Dict:
    """The global batch with its rows reordered for the placed step's
    microbatch split: row m·k + i of the result is row i·(B/k) + m of
    `batch` (axis 1 of the (3, B, S) positions, axis 0 of every other
    entry). The step takes every k-th placed row as microbatch i, so
    microbatch i is JAX's contiguous slice i, its rows in their order,
    and each rank's share of it is a contiguous run of that slice. The
    identity at k <= 1."""
    if not k or k <= 1:
        return batch

    def order(key, x):
        axis = 1 if key == "positions" and x.ndim == 3 else 0
        B = x.shape[axis]
        if B % k:
            raise ValueError(f"batch {key!r} has {B} rows, not a multiple "
                             f"of microbatch {k}")
        idx = torch.arange(B, device=x.device).reshape(k, B // k).T
        return x.index_select(axis, idx.reshape(-1))
    return {key: order(key, x) for key, x in batch.items()}


def place_batch(batch: Dict, placements, mesh, microbatch: int = 0) -> Dict:
    """Place a global batch for the sharded step: on a device mesh, rows
    ordered by `microbatch_order` (so its microbatches are JAX's) and
    distributed by `placements` (from `make_sharded_train_step`); on the
    abstract mesh (or None) the batch as it is."""
    from repro_torch.dist import sharding as shd
    if not shd.is_device_mesh(mesh):
        return batch
    return shd.distribute(microbatch_order(batch, microbatch), placements,
                          mesh)


def make_sharded_train_step(model: Model, tcfg: TrainConfig, mesh,
                            batch_example: Dict, plan=None):
    """The train step for a state placed on `mesh` (by shard_train_state:
    a DTensor carries its own placements, so the step needs nothing more),
    and the placements of its batches. `batch_example`'s leading dim is
    the global batch. Returns (step, batch_placements) — place batches
    with `place_batch(batch, batch_placements, mesh, tcfg.microbatch)`
    (train/loop.py does this when given `batch_sharding`)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import sharding as shd
    src = _plan_source(plan)
    ref = batch_example.get("tokens", batch_example.get("embeds"))
    shape = ShapeConfig("runtime", int(ref.shape[1]), int(ref.shape[0]),
                        "train")
    b_sh = shd.named(batch_example,
                     src.batch_specs(batch_example, mesh, shape), mesh)
    return make_train_step(model, tcfg), b_sh
