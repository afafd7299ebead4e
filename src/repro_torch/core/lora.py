"""LoRA baseline (Hu et al. 2021), the paper's primary comparator (the JAX
package's `core/lora.py`).

Convention: weights are (d_in, d_out), y = x @ W. ΔW = A @ B with
A (d_in, r) ~ N(0, 1/r) and B (r, d_out) = 0, scaled by lora_alpha / r.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch


def init_lora(gen: torch.Generator, d_in: int, d_out: int, r: int,
              stack: Optional[int] = None, dtype=torch.float32,
              device="cpu") -> Dict[str, torch.Tensor]:
    """{"lora_a", "lora_b"}: A drawn from `gen` (on `device`), B zero, so
    fine-tuning starts at the base model."""
    shape_a = (d_in, r) if stack is None else (stack, d_in, r)
    shape_b = (r, d_out) if stack is None else (stack, r, d_out)
    a = torch.randn(shape_a, generator=gen, device=device,
                    dtype=torch.float32) * (1.0 / math.sqrt(r))
    return {"lora_a": a.to(dtype),
            "lora_b": torch.zeros(shape_b, dtype=dtype, device=device)}


def lora_delta(a: torch.Tensor, b: torch.Tensor, lora_alpha: float, r: int,
               out_dtype=None) -> torch.Tensor:
    """ΔW = A @ B · lora_alpha / r in f32, for one layer or a stack."""
    dw = torch.matmul(a.to(torch.float32), b.to(torch.float32)) \
        * (lora_alpha / r)
    return dw.to(out_dtype) if out_dtype is not None else dw
