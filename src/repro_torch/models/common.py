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
    gathered along it first (`dist.dtensor.unshard_dim`), and the rest
    runs on each rank's batch rows (`_placed_cross_entropy`)."""
    from repro_torch.dist.dtensor import is_dtensor, unshard_dim
    logits = unshard_dim(logits.to(torch.float32), -1)
    if is_dtensor(logits):
        return _placed_cross_entropy(logits, labels, z_loss)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse * lse
    return torch.mean(loss)


def _placed_cross_entropy(logits, labels, z_loss: float) -> torch.Tensor:
    """cross_entropy of whole-vocab DTensor logits on each rank's batch
    rows (local tensors: the label gather's backward then scatters into
    the local rows, not into a zero tensor of the global logits' size);
    the mean sums over the batch shards. Returns a replicated DTensor
    scalar."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.dist.dtensor import sum_over_shards
    mesh = logits.device_mesh
    bpl = [Shard(0) if p.is_shard(0) else Replicate()
           for p in logits.placements]
    rep = [Replicate()] * mesh.ndim
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, rep, run_check=False)
    local = logits.redistribute(mesh, bpl).to_local()
    lab = labels.redistribute(mesh, bpl).to_local()
    lse = torch.logsumexp(local, dim=-1)
    ll = torch.gather(local, -1, lab.to(torch.int64)[..., None])[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse * lse
    if not any(p.is_shard() for p in bpl):
        # the whole batch on every rank: the plain path's mean, bit for bit
        return DTensor.from_local(torch.mean(loss), mesh, rep,
                                  run_check=False)
    total = sum_over_shards(loss.sum(), mesh, bpl)
    return DTensor.from_local(total / logits.shape[:-1].numel(), mesh, rep,
                              run_check=False)
