"""Token-choice top-k MoE with per-sequence static capacity (the JAX
package's `models/moe.py`).

Slot assignment is per sequence: the dispatch buffer is (B, E, C, d), each
sequence's tokens fill each expert's C slots in token order (top-k
priority first), and a token routed past an expert's capacity is dropped
there. The expert products are batched matrix products over the experts;
the combine gathers every (token, k) contribution back and reduces over k,
weighted by the gate (zero for a dropped contribution).

Auxiliary load-balance loss (Switch): E · Σ_e f_e · P_e over all tokens.

On a mesh (x a DTensor) the layer runs 2-D expert-parallel, as the JAX
package's does under its `moe/dispatch` constraint: routing, slot
assignment, the dispatch scatter and the combine gather are per-token
work and run on each rank's local batch shard (DTensor has no sharding
strategy for the expert counts, `topk`'s data-dependent indices or the
indexed scatter); the dispatch buffer then takes the (data, model)
placement —
sequences over the batch axes, experts over `model` — and the expert
products run on DTensors against the expert-sharded weights. The combine
gathers every expert's rows along `model` first. The aux loss sums its
routing statistics over the batch shards, so it is the whole batch's.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.dist.dtensor import is_dtensor, sum_over_shards


def capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    c = int(math.ceil(cfg.capacity_factor * tokens_per_group * cfg.top_k
                      / cfg.num_experts))
    return max(8, -(-c // 8) * 8)  # round up to 8, as the JAX package does


def expert_counts(flat_ids: torch.Tensor, E: int) -> torch.Tensor:
    """Choices per expert, (E,) f32: an exact integer count (a scatter-add
    of ones, whose output shape does not depend on the ids' values, so
    fake tensors trace it)."""
    counts = torch.zeros((E,), dtype=torch.int64, device=flat_ids.device)
    counts.scatter_add_(0, flat_ids, torch.ones_like(flat_ids))
    return counts.to(torch.float32)


def route(router_logits: torch.Tensor, cfg: MoEConfig, reduce=None):
    """router_logits (..., E) -> gates (..., k) f32, ids (..., k) int64,
    aux scalar f32. `reduce` (a sum over the batch shards, on a mesh)
    makes the load statistics the whole batch's."""
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    gates, ids = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    E = probs.shape[-1]
    flat_ids = ids.reshape(-1)
    if reduce is None:
        f = expert_counts(flat_ids, E) / flat_ids.numel()
        p = probs.reshape(-1, E).mean(dim=0)
    else:
        total = reduce(torch.full((), float(flat_ids.numel()),
                                  device=probs.device))
        f = reduce(expert_counts(flat_ids, E)) / total
        p = reduce(probs.reshape(-1, E).sum(dim=0)) / (total / cfg.top_k)
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


def _dispatch(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
              reduce=None):
    """Route x (B, S, d) and scatter it into the dispatch buffer (B, E, C,
    d). -> (buf, gates, ids, slots, keep, aux)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    logits = torch.einsum("bsd,de->bse", x.to(torch.float32),
                          router.to(torch.float32))
    gates, ids, aux = route(logits, cfg, reduce)         # (B, S, k)
    cap = capacity(S, cfg)
    slots, keep = assign_slots(ids, E, cap)              # (B, S, k)
    # a contribution past capacity is dropped: it is routed to one spare
    # slot past the last, which is cut off (no host sync on the keep mask)
    rows = torch.arange(B, device=x.device)[:, None, None].expand_as(ids)
    buf = torch.zeros((B, E, cap + 1, d), dtype=x.dtype, device=x.device)
    contrib = x[:, :, None, :].expand(B, S, k, d)
    buf.index_put_((rows, ids, torch.where(keep, slots, cap)), contrib,
                   accumulate=True)
    return buf[:, :, :cap], gates, ids, slots, keep, aux


def _combine(out: torch.Tensor, gates, ids, slots, keep) -> torch.Tensor:
    """Gather every (token, k) row back from the expert outputs (B, E, C,
    d) and reduce over k (a dropped contribution's slot is clamped in
    range and weighted by zero). -> (B, S, d) f32."""
    cap = out.shape[2]
    rows = torch.arange(out.shape[0], device=out.device)[:, None, None] \
        .expand_as(ids)
    gathered = out[rows, ids, torch.clamp(slots, max=cap - 1)]  # (B,S,k,d)
    w = (gates * keep).to(torch.float32)
    return torch.einsum("bskd,bsk->bsd", gathered.to(torch.float32), w)


def _experts(buf, p, gated: bool):
    """The batched expert FFN over the dispatch buffer (B, E, C, d)."""
    h = torch.einsum("becd,edf->becf", buf, p["we_i"])
    if gated:
        g = torch.einsum("becd,edf->becf", buf, p["we_g"])
        h = F.silu(g.to(torch.float32)).to(h.dtype) * h
    else:
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(h.dtype)
    return torch.einsum("becf,efd->becd", h, p["we_o"])


def moe_ffn(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: MoEConfig,
            gated: bool = True, constrain=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d); p: router (d, E) f32, we_i/we_g (E, d, f), we_o
    (E, f, d). Returns (y (B, S, d) in x's dtype, aux loss). A DTensor x
    runs expert-parallel on its mesh (module docstring); `constrain` (the
    `Model.constrain` hook) then places the dispatch buffer
    (`moe/dispatch`) and the combined tokens (`moe/tokens`)."""
    if is_dtensor(x):
        return _moe_ffn_placed(x, p, cfg, gated, constrain)
    buf, gates, ids, slots, keep, aux = _dispatch(x, p["router"], cfg)
    out = _experts(buf, p, gated)
    return _combine(out, gates, ids, slots, keep).to(x.dtype), aux


def _batch_placements(x):
    """x's placements with only its batch-dim (dim 0) shards kept."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0) if p.is_shard(0) else Replicate() for p in x.placements]


def _moe_ffn_placed(x, p, cfg: MoEConfig, gated: bool, constrain):
    """moe_ffn on a mesh (module docstring)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    bpl = _batch_placements(x)
    xl = x.redistribute(mesh, bpl).to_local()
    router = p["router"]
    if is_dtensor(router):
        router = router.full_tensor()
    # with the whole batch on every rank, the plain statistics (bit for bit)
    reduce = None if not any(q.is_shard() for q in bpl) \
        else (lambda t: sum_over_shards(t, mesh, bpl))
    buf, gates, ids, slots, keep, aux = _dispatch(xl, router, cfg, reduce)
    place = constrain or default_constrain
    buf = place("moe/dispatch",
                DTensor.from_local(buf, mesh, bpl, run_check=False))
    out = place("moe/dispatch", _experts(buf, p, gated))
    # the combine reads any expert's rows: gather the experts along `model`
    out = out.redistribute(mesh, bpl).to_local()
    y = _combine(out, gates, ids, slots, keep)
    y = DTensor.from_local(y, mesh, bpl, run_check=False)
    if constrain is not None:
        y = constrain("moe/tokens", y)
    # every rank holds the whole batch's aux loss: a replicated DTensor, so
    # its gradient comes back through `from_local` as a plain tensor
    aux = DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return y.to(x.dtype), aux


def default_constrain(path: str, x):
    """The `moe/dispatch` placement without a hook: sequences stay on the
    batch shards, experts shard over `model` when it divides them (the
    JAX package's 2-D expert-parallel spec)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    pl = list(x.placements)
    if "model" in names:
        i = names.index("model")
        m = mesh.size(i)
        if m > 1 and x.shape[1] % m == 0 and not pl[i].is_shard():
            pl[i] = Shard(1)
    return x.redistribute(mesh, pl)

