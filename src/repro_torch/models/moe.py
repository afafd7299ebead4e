"""Token-choice top-k MoE with per-sequence static capacity (the JAX
package's `models/moe.py`).

Slot assignment is per sequence: the dispatch buffer is (B, E, C, d), each
sequence's tokens fill each expert's C slots in token order (top-k
priority first), and a token routed past an expert's capacity is dropped
there. The expert products are batched matrix products over the experts;
the combine gathers every (token, k) contribution back and reduces over k,
weighted by the gate (zero for a dropped contribution).

Auxiliary load-balance loss (Switch): E · Σ_e f_e · P_e over all tokens.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig


def capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    c = int(math.ceil(cfg.capacity_factor * tokens_per_group * cfg.top_k
                      / cfg.num_experts))
    return max(8, -(-c // 8) * 8)  # round up to 8, as the JAX package does


def route(router_logits: torch.Tensor, cfg: MoEConfig):
    """router_logits (..., E) -> gates (..., k) f32, ids (..., k) int64,
    aux scalar f32."""
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    gates, ids = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    E = probs.shape[-1]
    flat_ids = ids.reshape(-1)
    f = torch.bincount(flat_ids, minlength=E).to(torch.float32) \
        / flat_ids.numel()
    p = probs.reshape(-1, E).mean(dim=0)
    aux = E * torch.sum(f * p)
    return gates, ids, aux


def assign_slots(ids: torch.Tensor, num_experts: int, cap: int):
    """Greedy position-in-expert assignment honouring top-k priority:
    choice j of every token is placed after all choices < j. ids (..., T, k)
    -> slots (..., T, k) int64, keep (..., T, k) bool (slot < cap). Leading
    dims are independent groups (the JAX package vmaps over sequences)."""
    k = ids.shape[-1]
    counts = torch.zeros(ids.shape[:-2] + (num_experts,), dtype=torch.int64,
                         device=ids.device)
    slots = []
    for j in range(k):                                   # k is small
        oh = F.one_hot(ids[..., j], num_experts)         # (..., T, E)
        pos = torch.cumsum(oh, dim=-2) * oh              # 1-based within oh
        slot = (pos.sum(-1) - 1) + torch.gather(counts, -1, ids[..., j])
        counts = counts + oh.sum(dim=-2)
        slots.append(slot)
    slots = torch.stack(slots, dim=-1)
    return slots, slots < cap


def moe_ffn(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: MoEConfig,
            gated: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d); p: router (d, E) f32, we_i/we_g (E, d, f), we_o
    (E, f, d). Returns (y (B, S, d) in x's dtype, aux loss)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    logits = torch.einsum("bsd,de->bse", x.to(torch.float32),
                          p["router"].to(torch.float32))
    gates, ids, aux = route(logits, cfg)                 # (B, S, k)
    cap = capacity(S, cfg)
    slots, keep = assign_slots(ids, E, cap)              # (B, S, k)

    # ---- dispatch: scatter into (B, E, C, d) ----
    # a contribution past capacity is dropped: it is routed to one spare
    # slot past the last, which is cut off (no host sync on the keep mask)
    rows = torch.arange(B, device=x.device)[:, None, None].expand_as(ids)
    buf = torch.zeros((B, E, cap + 1, d), dtype=x.dtype, device=x.device)
    contrib = x[:, :, None, :].expand(B, S, k, d)
    buf.index_put_((rows, ids, torch.where(keep, slots, cap)), contrib,
                   accumulate=True)
    buf = buf[:, :, :cap]
    # ---- expert FFN ----
    h = torch.einsum("becd,edf->becf", buf, p["we_i"])
    if gated:
        g = torch.einsum("becd,edf->becf", buf, p["we_g"])
        h = F.silu(g.to(torch.float32)).to(h.dtype) * h
    else:
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(h.dtype)
    out = torch.einsum("becf,efd->becd", h, p["we_o"])
    # ---- combine: gather back and reduce over k (a dropped contribution's
    # slot is clamped in range and weighted by zero) ----
    gathered = out[rows, ids, torch.clamp(slots, max=cap - 1)]  # (B,S,k,d)
    w = (gates * keep).to(torch.float32)
    y = torch.einsum("bskd,bsk->bsd", gathered.to(torch.float32), w)
    return y.to(x.dtype), aux
