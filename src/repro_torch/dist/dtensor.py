"""The DTensor boundary: where placed tensors meet the hand-written kernels
and the few ops DTensor has no sharding strategy for.

A sharded model runs its ordinary code on DTensors: DTensor propagates
each op's sharding and inserts the collectives (the counterpart of XLA's
SPMD partitioner). Three places need more than that, and each is here:

- `sharded_delta` — the ΔW of a merged adapter site (K1/K2 or K4/K5 on the
  card, their plain versions on the CPU). The adapter leaves replicate by
  decision, so every rank materializes the whole ΔW from its local leaves
  and keeps its shard of the weight's placement: a local slice, no
  collective. Backward: the ΔW cotangent arrives with the weight's
  placement, partial over the batch axes. A shard over `model` is
  zero-padded to the whole (d1, d2) locally and counted as partial too
  (the VJP is linear in g, so the sum over ranks of the padded pieces'
  VJPs is the VJP of the whole), and the local VJP — K2 on the card —
  runs on it as it is. The coefficients' gradient leaves partial over
  those mesh dims: n floats to reduce instead of d1·d2.
- `local_paged_attention` — K3 on the local KV heads. The query heads
  follow `wq`'s column shard and the page pools shard their KV-head dim
  (`sharding.cache_leaf_spec`); when both shard over `model` the local
  query heads map onto the local KV heads as the whole ones do, and K3
  runs on the local tensors with no collective. When the pool replicates
  its heads (too few KV heads to divide), the queries are gathered along
  `model` first (an explicit redistribute of B·W·H·dh numbers).
- `index_put_` — the caches' indexed writes (page pools, per-slot rows)
  on each rank's local shard: DTensor registers no sharding strategy for
  `aten.index_put_` in every torch release (the card's 2.11 has none).
- `unshard_dim` — an explicit redistribute of the logits to whole rows
  over the vocabulary before the cross entropy's gather and the greedy
  argmax (DTensor's masked-partial gather does not survive the select
  that follows it, and its sharded argmax does not take every shape).

The families' per-head and per-token work runs on local shards too
(so that every local call has one home):

- `local_attention` — full-sequence and lockstep attention on each rank's
  batch rows and query heads, the KV heads those read; `batch_local` —
  a per-row op (circulant's FFT apply) on each rank's batch rows;
- `split_heads` — a column shard finer than a head gathered before the
  heads split; `shard_like_columns` — a factored apply's output bases
  sharded like the column-parallel weight they add to;
- `sum_over_shards` — a sum over the batch shards (the cross entropy's,
  the MoE load statistics) with an identity backward: every rank seeds
  the same loss, so its local term's gradient is the sum's;
  `summed_grad_placements` — the gradient layout of a tensor every rank
  reads whole while its heads shard (each rank's gradient a term).

`ops_context()` makes plain tensors count as replicated wherever they
meet a DTensor (positions, masks, host-built block tables): the same host
values on every rank, as every rank makes the same host decisions.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def any_dtensor(tree) -> bool:
    if isinstance(tree, dict):
        return any(any_dtensor(v) for v in tree.values())
    return is_dtensor(tree)


def ops_context(tree=None):
    """Plain tensors meeting a DTensor count as replicated (DTensor's
    implicit replication) — entered when `tree` holds a DTensor, or
    always when `tree` is None."""
    if tree is not None and not any_dtensor(tree):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def to_plain(t):
    """A DTensor's whole value as a plain tensor on this rank (gathered
    where it is sharded); anything else as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def reduce_partial(t):
    """A DTensor partial over some mesh dims (a gradient summed over the
    batch shards) all-reduced there, so it replicates; anything else as
    it is."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in t.placements])


def write_at(t, dim: int, i: int, value) -> None:
    """t.select(dim, i)[...] = value, in place (a slot's row of a per-slot
    cache, its position). On a DTensor it is `index_put_` over dims
    0..dim, so each rank writes what it holds of the row."""
    if not is_dtensor(t):
        t.select(dim, i)[...] = value
        return
    dev = t.to_local().device
    lead = tuple(torch.arange(t.shape[d], device=dev).reshape(
        (-1,) + (1,) * (dim - 1 - d)) for d in range(dim))
    idx = lead + (torch.tensor(i, device=dev),)
    if not torch.is_tensor(value):
        value = torch.tensor(value, dtype=t.dtype, device=dev)
    index_put_(t, idx, value.expand(tuple(t.shape[:dim])
                                    + tuple(t.shape[dim + 1:])))


def index_put_(t, indices: tuple, values) -> None:
    """t[indices] = values, in place, with advanced indexing over t's
    leading len(indices) dims (a page pool's (page, offset), a cache's
    (row, column)). On a DTensor each rank writes its local shard: the
    values take the shard layout of t's other dims (a KV-head shard over
    `model`), and where an indexed dim is sharded (a per-slot cache's
    rows over `data`) a rank keeps the entries whose index it holds.
    DTensor has no sharding strategy for index_put_ in every torch
    release."""
    if not is_dtensor(t):
        t[indices] = values
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    n = len(indices)
    idx = torch.broadcast_tensors(*(to_plain(i) for i in indices))
    nb = idx[0].ndim
    mesh = t.device_mesh
    v = values if is_dtensor(values) else DTensor.from_local(
        values, mesh, [Replicate()] * mesh.ndim, run_check=False)
    pl = [Shard(p.dim - n + nb) if p.is_shard() and p.dim >= n
          else Replicate() for p in t.placements]
    v = v.redistribute(mesh, pl).to_local().to(t.dtype)
    local = t.to_local()
    if not any(p.is_shard() and p.dim < n for p in t.placements):
        local[idx] = v
        return
    lshape, off = local_shape_and_offset(t.shape, mesh, t.placements)
    keep = torch.ones(idx[0].shape, dtype=torch.bool, device=idx[0].device)
    for d in range(n):
        keep &= (idx[d] >= off[d]) & (idx[d] < off[d] + lshape[d])
    local[tuple(i[keep] - off[d] for d, i in enumerate(idx))] = v[keep]


class _SumOverRanks(torch.autograd.Function):
    """Forward: a local tensor summed over the mesh dims `part` marks
    Partial (an all-reduce). Backward: the identity — every rank seeds the
    same replicated loss, so d loss / d (its local term) is the summed
    value's gradient itself, unscaled."""

    @staticmethod
    def forward(ctx, t, mesh, part):
        from torch.distributed.tensor import DTensor, Replicate
        with torch.no_grad():
            return DTensor.from_local(t, mesh, part, run_check=False) \
                .redistribute(mesh, [Replicate()] * mesh.ndim).to_local()

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_over_shards(t, mesh, placements):
    """A local term of a sum over the batch rows summed over the mesh dims
    where `placements` shards (its other dims replicate): the whole sum on
    every rank, differentiable (`_SumOverRanks`)."""
    from torch.distributed.tensor import Partial, Replicate
    part = [Partial() if p.is_shard() else Replicate() for p in placements]
    if not any(p.is_partial() for p in part):
        return t
    return _SumOverRanks.apply(t, mesh, part)


def summed_grad_placements(placements, mesh_dims):
    """`placements` with the mesh dims in `mesh_dims` Partial: the gradient
    layout of a local tensor that several ranks along those dims read
    differently (each rank's gradient is a term of the whole one)."""
    from torch.distributed.tensor import Partial
    return [Partial() if i in mesh_dims else p
            for i, p in enumerate(placements)]


def local_attention(fn: Callable, q, k, v, kv_len=None, **kw):
    """fn(q, k, v[, kv_len], **kw) — attention over q (B, Sq, H, dh), k
    and v (B, Skv, K, dh) — on each rank's local batch rows and query
    heads when any input is a DTensor (attention is per-head work: no
    sharding strategy is needed for its blocks, masks and softmax). The
    query heads shard over `model` where it divides them into whole
    groups' worth of slices; each rank then takes the KV heads its query
    heads read (its shard when the KV heads shard alike, else a slice of
    the gathered heads). Plain inputs go to `fn` unchanged."""
    if kv_len is not None:
        kw = {**kw, "kv_len": kv_len}
    if not any(is_dtensor(t) for t in (q, k, v, kv_len)):
        return fn(q, k, v, **kw)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = next(t for t in (q, k, v, kv_len)
                if is_dtensor(t)).device_mesh
    rep = [Replicate()] * mesh.ndim

    def placed(t):
        return t if is_dtensor(t) else DTensor.from_local(
            t, mesh, rep, run_check=False)

    q, k, v = placed(q), placed(k), placed(v)
    batch = [Shard(0) if p.is_shard(0) else Replicate()
             for p in q.placements]
    H, K = q.shape[2], k.shape[2]
    G = H // K
    heads = list(batch)
    names = mesh.mesh_dim_names or ()
    if "model" in names:
        i = names.index("model")
        m = mesh.size(i)
        hl = H // m if H % m == 0 else 0
        if m > 1 and hl and (hl % G == 0 or G % hl == 0):
            heads[i] = Shard(2)
    ql = q.redistribute(mesh, heads).to_local()
    _, off = local_shape_and_offset(q.shape, mesh, heads)
    h0, hl = off[2], ql.shape[2]
    k0, kn = h0 // G, max(1, hl // G)
    kv_pl = batch
    # the KV heads stay whole on each rank while the query heads shard:
    # each rank's KV gradient is its heads' term of the whole
    split = [i for i, (a, b) in enumerate(zip(heads, batch)) if a != b]

    def kv_local(t):
        t = t.redistribute(mesh, kv_pl).to_local(
            grad_placements=summed_grad_placements(kv_pl, split))
        return t[:, :, k0:k0 + kn] if kn != K else t
    if torch.is_tensor(kv_len):
        kw["kv_len"] = placed(kv_len).redistribute(mesh, batch).to_local()
    out = fn(ql, kv_local(k), kv_local(v), **kw).contiguous()
    shape = q.shape[:3] + out.shape[3:]
    return DTensor.from_local(out, mesh, heads, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def batch_local(fn: Callable, x, table, rows: bool):
    """fn(x, table) on each rank's batch rows when either is a DTensor (an
    op DTensor has no strategy for in every torch release, as the FFT of
    circulant's apply): x (B, ...) takes its batch placement; `table`
    follows x's rows when `rows` (a per-row table (B, ...)), else it is
    whole on every rank and hands back its gradient as a partial sum over
    the batch shards. The result is placed like x's rows."""
    if not (is_dtensor(x) or is_dtensor(table)):
        return fn(x, table)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = (x if is_dtensor(x) else table).device_mesh
    rep = [Replicate()] * mesh.ndim

    def placed(t):
        return t if is_dtensor(t) else DTensor.from_local(
            t, mesh, rep, run_check=False)

    x, table = placed(x), placed(table)
    bpl = [Shard(0) if p.is_shard(0) else Replicate() for p in x.placements]
    xl = x.redistribute(mesh, bpl).to_local()
    if rows:
        tl = table.redistribute(mesh, bpl).to_local()
    else:
        sharded = [i for i, p in enumerate(bpl) if p.is_shard()]
        tl = table.redistribute(mesh, rep).to_local(
            grad_placements=summed_grad_placements(rep, sharded))
    return DTensor.from_local(fn(xl, tl), mesh, bpl, run_check=False)


def split_heads(t, heads: int, head_dim: int):
    """(B, S, heads·head_dim) -> (B, S, heads, head_dim). A DTensor whose
    last dim is sharded finer than whole heads (a column shard over more
    ranks than there are heads) is gathered along it first: DTensor cannot
    split a shard inside a head."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate
        last = t.ndim - 1
        ways = 1
        for i, p in enumerate(t.placements):
            if p.is_shard(last):
                ways *= t.device_mesh.size(i)
        if heads % ways:
            t = t.redistribute(t.device_mesh, [
                Replicate() if p.is_shard(last) else p
                for p in t.placements])
    return t.reshape(t.shape[0], -1, heads, head_dim)


def shard_like_columns(table, x):
    """A (d_out, ...) table whose rows index an adapter's output columns,
    as a DTensor on `x`'s mesh with those rows sharded over `model` where
    it divides them (replicated elsewhere): the factored apply then
    computes this rank's output columns only, as the column-parallel
    projection it adds to does."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    if not is_dtensor(table):
        table = DTensor.from_local(table, mesh, rep, run_check=False)
    names = mesh.mesh_dim_names or ()
    pl = list(rep)
    if "model" in names:
        i = names.index("model")
        if mesh.size(i) > 1 and table.shape[0] % mesh.size(i) == 0:
            pl[i] = Shard(0)
    return table.redistribute(mesh, pl)


def unshard_dim(t, dim: int):
    """`t` whole along tensor dim `dim`: no longer sharded there (Shard(dim)
    -> Replicate) and no longer partial (a row-parallel product's pending
    sum, reduced); a plain tensor as is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    dim = dim % t.ndim
    pl = [Replicate() if (p.is_shard(dim) or p.is_partial()) else p
          for p in t.placements]
    if list(pl) == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, pl)


def local_shape_and_offset(shape, mesh, placements):
    """This rank's shard of a DTensor of global `shape`: (local shape,
    global offset). Computed on real tensors even under a fake-tensor
    mode (the dry run's), where the mesh's coordinate lookup could not
    read its values, and outside any op-recording mode."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        return compute_local_shape_and_global_offset(shape, mesh,
                                                     placements)


def _local_slices(shape, mesh, placements):
    lshape, off = local_shape_and_offset(shape, mesh, placements)
    return tuple(slice(o, o + n) for o, n in zip(off, lshape))


class ShardedDelta(torch.autograd.Function):
    """fn(local leaves) -> whole local ΔW; returns this rank's shard of it
    as a DTensor with the weight's placements (module docstring)."""

    @staticmethod
    def forward(ctx, fn, names, like, *leaves):
        mesh, placements, shape, stride = like
        live = [leaf.to_local().detach().requires_grad_(leaf.requires_grad)
                for leaf in leaves]
        with torch.enable_grad():
            full = fn(dict(zip(names, live)))
        from torch.autograd.graph import get_gradient_edge
        from torch.distributed.tensor import DTensor
        # the local graph's output edge, not the ΔW itself: nothing holds
        # the whole ΔW past this call
        ctx.edge = get_gradient_edge(full) if full.requires_grad else None
        ctx.live = live
        ctx.meta = (mesh, shape, full.dtype)
        local = full.detach()[_local_slices(shape, mesh, placements)]
        return DTensor.from_local(local.contiguous(), mesh, placements,
                                  run_check=False, shape=shape,
                                  stride=stride)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        mesh, shape, dtype = ctx.meta
        out_pl = [Partial() if (p.is_shard() or p.is_partial())
                  else Replicate() for p in g.placements]
        gl = g.to_local()
        if any(p.is_shard() for p in g.placements):
            whole = gl.new_zeros(shape)
            whole[_local_slices(shape, mesh, g.placements)] = gl
            gl = whole
        want = [i for i, t in enumerate(ctx.live) if t.requires_grad]
        grads = [None] * len(ctx.live)
        if ctx.edge is not None and want:
            got = torch.autograd.grad([ctx.edge],
                                      [ctx.live[i] for i in want],
                                      [gl.to(dtype)], allow_unused=True)
            for i, gi in zip(want, got):
                if gi is None:
                    gi = torch.zeros_like(ctx.live[i])
                grads[i] = DTensor.from_local(gi, mesh, out_pl,
                                              run_check=False)
        ctx.edge = ctx.live = None
        return (None, None, None, *grads)


def sharded_delta(fn: Callable[[Dict], torch.Tensor], leaves: Dict,
                  like) -> torch.Tensor:
    """ΔW = fn(adapter leaves) placed like the weight DTensor `like` (its
    mesh, placements and global shape), from replicated adapter DTensors
    (module docstring). Plain leaves are taken as replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    names = list(leaves)
    rep = [Replicate()] * mesh.ndim
    # a leaf some plan sharded (FSDP over a large adapter leaf) is gathered
    # first: every rank materializes the whole ΔW
    vals = [v.redistribute(mesh, rep) if is_dtensor(v)
            else DTensor.from_local(v, mesh, rep, run_check=False)
            for v in leaves.values()]
    spec = (mesh, like.placements, like.shape, like.stride())
    return ShardedDelta.apply(fn, names, spec, *vals)


def local_paged_attention(fn: Callable) -> Callable:
    """K3 (or its plain version) on the local tensors of DTensor inputs
    (module docstring); plain inputs go to `fn` unchanged. q (B, W, H, dh)
    and the pools (n_pages, page_size, K, dh) of one layer; the block
    table and kv_len ride along replicated."""
    def call(q, k_pages, v_pages, block_table, kv_len):
        if not is_dtensor(q) and not is_dtensor(k_pages):
            return fn(q, k_pages, v_pages, block_table, kv_len)
        from torch.distributed.tensor import DTensor, Replicate
        mesh = (q if is_dtensor(q) else k_pages).device_mesh
        rep = [Replicate()] * mesh.ndim

        def placed(t, pl):
            if not is_dtensor(t):
                t = DTensor.from_local(t, mesh, rep, run_check=False)
            return t.redistribute(mesh, pl)

        # heads stay sharded only where the pools shard their KV heads
        pool_pl = tuple(Replicate() if not p.is_shard(2) else p
                        for p in (k_pages.placements if is_dtensor(k_pages)
                                  else rep))
        q_pl = tuple(p if p.is_shard(2) else Replicate() for p in pool_pl)
        ql = placed(q, q_pl)
        kl = placed(k_pages, pool_pl)
        vl = placed(v_pages, pool_pl)
        out = fn(ql.to_local().contiguous(), kl.to_local(), vl.to_local(),
                 placed(block_table, rep).to_local().contiguous(),
                 placed(kv_len, rep).to_local().contiguous())
        return DTensor.from_local(out, mesh, q_pl, run_check=False,
                                  shape=q.shape, stride=out.stride())
    return call
