"""Train-step factory: PEFT-filtered gradients, microbatch accumulation,
anomaly-guarded updates (the JAX package's `train/step.py`, without the
mesh placement and the int8 error-feedback compression, which come with
the distributed slice, ROADMAP queue 9).

Parameters are split into (trainable, frozen). Gradients are taken with
`torch.autograd.grad` w.r.t. the trainable leaves only: the frozen base
needs no gradient of its own, and on the card the merged forward's ΔW
kernel hands the coefficients theirs through the dc kernel
(`kernels.ops.FourierDeltaW`).

Anomaly guard (fault tolerance): a non-finite or exploding loss or gradient
norm skips the update (parameters and optimizer state keep their old
values, chosen on the device with `torch.where`) and increments
`anomalies`. A step reads nothing back to the host: the loop's one sync
per step is its read of the loss.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.peft import trainable_adapter_tree
from repro_torch.devices import resolve_device
from repro_torch.models.registry import Model
from repro_torch.optim import adamw, schedules
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def split_params(model: Model, params: Dict) -> Tuple[Dict, Dict]:
    """-> (trainable, frozen). frozen = {"base": ..., "peft": ... (frozen
    leaves)}. The trainable/frozen boundary inside each adapter dict comes
    from the method's `trainable_leaves`; `train_head` moves `lm_head`."""
    peft = model.peft
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


def _check_supported(tcfg: TrainConfig) -> None:
    if tcfg.grad_compression != "none":
        raise NotImplementedError(
            f"grad_compression={tcfg.grad_compression!r} comes with the "
            "distributed slice (ROADMAP queue 9)")


def init_state(model: Model, tcfg: TrainConfig, seed: int,
               device=None) -> Tuple[Dict, Dict]:
    """-> (state, frozen) for params `model.init(seed)` made on `device`
    (default `cuda`; raises without a card unless the caller names a
    device)."""
    _check_supported(tcfg)
    return state_from_params(model, model.init(seed, resolve_device(device)))


def state_from_params(model: Model, params: Dict) -> Tuple[Dict, Dict]:
    """-> (state, frozen). state = {step, trainable, opt, loss_ema,
    anomalies} on the device of the params' trainable leaves."""
    trainable, frozen = split_params(model, params)
    dev = tree_leaves(trainable)[0].device
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "trainable": trainable,
        "opt": adamw.init(trainable),
        "loss_ema": torch.zeros((), dtype=torch.float32, device=dev),
        "anomalies": torch.zeros((), dtype=torch.int32, device=dev),
    }
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
        # k contiguous slices of the batch; losses and f32 gradients are
        # summed in order, then scaled by 1/k (JAX's scan over microbatches)
        mbs = [{key: x.reshape((k, x.shape[0] // k) + x.shape[1:])[i]
                for key, x in batch.items()} for i in range(k)]
        loss = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
        grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         trainable)
        for mb in mbs:
            l, g = _value_and_grad(loss_f, trainable, frozen, mb)
            loss = loss + l
            grads = tree_map(torch.add, grads, g)
        scale = 1.0 / k
        return loss * scale, tree_map(lambda g: g * scale, grads)

    def train_step(state: Dict, frozen: Dict, batch: Dict):
        device = state["step"].device
        if device not in validated:
            model.kernel_policy(device).validate()
            validated.add(device)
        loss, grads = grads_of(state["trainable"], frozen, batch)
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
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "skipped": bad.to(torch.int32)}
        return state_out, metrics

    return train_step
