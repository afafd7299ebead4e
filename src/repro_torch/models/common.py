"""Shared model building blocks: norms, RoPE (incl. M-RoPE), inits,
cross-entropy."""
from __future__ import annotations

from typing import Tuple

import torch


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(torch.float32)).to(x.dtype)


def dense_init(gen: torch.Generator, shape, dtype, device,
               scale: float = 0.02) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * scale).to(dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    """Qwen2-VL's split of the rotary half-dim among the (t, h, w) position
    streams: (16, 24, 24) for head_dim 128."""
    half = head_dim // 2
    hw = (3 * half) // 8
    return (half - 2 * hw, hw, hw)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope: bool = False) -> torch.Tensor:
    """x: (B, S, N, head_dim). positions: (B, S) int, or (3, B, S) for
    M-RoPE (rotary dim i takes its angle from the stream its section
    names)."""
    half = x.shape[-1] // 2
    inv = rope_freqs(x.shape[-1], theta, x.device)          # (half,)
    if mrope:
        idx = torch.cat([torch.full((s,), i, dtype=torch.int64,
                                    device=x.device)
                         for i, s in enumerate(mrope_sections(x.shape[-1]))])
        pos = positions.to(torch.float32).index_select(0, idx)  # (half,B,S)
        angles = torch.einsum("hbs,h->bsh", pos, inv)       # (B, S, half)
    else:
        angles = positions.to(torch.float32)[..., None] * inv  # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]                  # (B, S, 1, half)
    sin = torch.sin(angles)[:, :, None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean token CE in f32. logits (..., V), labels (...) int. Logits
    sharded over the vocab (a DTensor from a column-parallel head) are
    gathered along it first (`dist.dtensor.unshard_dim`)."""
    from repro_torch.dist.dtensor import unshard_dim
    logits = unshard_dim(logits.to(torch.float32), -1)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse * lse
    return torch.mean(loss)
