"""LR schedules: warmup + {linear, cosine, constant} (the JAX package's
`optim/schedules.py`). `step` may be an int or a tensor; the result is an
f32 tensor on the step's device, so a train step reads no scalar back to
the host."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig


def lr_at(step, cfg: TrainConfig) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = max(cfg.warmup_steps, 1)
    # (step + 1): the very first step trains at lr/warmup, not zero
    warm_frac = torch.clamp((step + 1.0) / warm, max=1.0)
    total = max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / total, 0.0, 1.0)
    if cfg.schedule == "linear":
        decay = 1.0 - prog
    elif cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * prog))
    else:
        decay = torch.ones_like(prog)
    return cfg.learning_rate * warm_frac * decay
