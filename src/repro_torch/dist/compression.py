"""int8 error-feedback gradient compression (the JAX package's
`dist/compression.py`, the same arithmetic: bitwise the same results on
the same f32 or bf16 gradients).

For cross-node data parallelism the per-step gradient all-reduce payload is
the binding constraint: FourierFT's coefficient gradients are tiny, but
full-FT / head-training payloads are not. Symmetric per-tensor int8
quantization cuts the payload 4x; the quantization residual is carried to
the next step (error feedback), so the *accumulated* update stays unbiased
— the classic EF-SGD argument (residuals stay bounded while the signal
accumulates; property-tested in tests/test_torch_dist.py).

Opt-in: `TrainConfig.grad_compression = "int8_ef"` — train/step.py then
threads an `ef_residual` tree through the state and compresses gradients
before the optimizer update (what the optimizer receives is what the wire
would carry). As in the JAX package the all-reduce itself stays f32: a
gradient that is a DTensor partial over the batch axes is reduced by its
first non-linear op here (the max of |y|), and the compression runs on the
reduced value.

Rounding is half to even (`torch.round`, as `jnp.round`), the codes are
clipped to ±127.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q int8, scale f32 scalar) with
    x ≈ q · scale and |x - q·scale| ≤ scale/2 elementwise."""
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) \
        .to(torch.float32) / 127.0
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_residual(tree) -> Dict:
    """Zero error-feedback residual matching a gradient tree (f32)."""
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), tree)


def _one(g: torch.Tensor, r: torch.Tensor):
    y = g.to(torch.float32) + r
    q, scale = quantize_int8(y)
    # the residual must track what the optimizer actually receives —
    # including the g.dtype down-cast rounding — or low-precision grads
    # (bf16) accumulate a persistent bias the EF property promises away
    sent = dequantize(q, scale).to(g.dtype)
    return sent, y - sent.to(torch.float32)


def compress_with_feedback(grads, residual) -> Tuple[Dict, Dict]:
    """Per-leaf: y = g + residual; send quantize(y); carry y - sent.
    Returns (sent_grads — what the all-reduce would transport — and the new
    residual tree)."""
    pairs = tree_map(_one, grads, residual)
    sent = tree_map(lambda g, p: p[0], grads, pairs)
    new_r = tree_map(lambda g, p: p[1], grads, pairs)
    return sent, new_r


def payload_bytes(tree) -> Tuple[int, int]:
    """(f32 payload, int8+scale payload) for a gradient tree — the wire-size
    comparison."""
    leaves = tree_leaves(tree)
    n = sum(int(x.numel()) for x in leaves)
    return 4 * n, n + 4 * len(leaves)
