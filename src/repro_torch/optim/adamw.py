"""AdamW with decoupled weight decay, from scratch (the JAX package's
`optim/adamw.py`).

Functional, as there: `init(params) -> opt_state`, `update(grads,
opt_state, params, lr, cfg) -> (new_params, new_opt_state)` over nested
dicts of tensors; moments are f32 whatever the parameter dtype. Nothing is
updated in place: the trainable trees of a FourierFT run are the n
coefficients per site, so the copies cost nothing worth saving, and the
train step's anomaly guard picks between the old and the new trees.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.tree import tree_leaves, tree_map


def init(params) -> Dict:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.tensor(0.0)
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in leaves))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def update(grads, opt_state: Dict, params, lr, cfg: TrainConfig) -> Tuple:
    count = opt_state["count"] + 1
    b1, b2 = cfg.b1, cfg.b2
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                  opt_state["mu"], grads)
    nu = tree_map(
        lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(torch.float32)),
        opt_state["nu"], grads)
    c1 = 1 - b1 ** count.to(torch.float32)
    c2 = 1 - b2 ** count.to(torch.float32)

    def upd(p, m, v):
        step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if cfg.weight_decay:
            step = step + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * step).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, {"mu": mu, "nu": nu, "count": count}
