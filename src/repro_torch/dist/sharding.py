"""Named-sharding rule engine (the JAX package's `dist/sharding.py`).

Mesh axes (any subset may be present):

    pod    — cross-node data parallelism (the slow hop)
    data   — in-node data parallelism; also the FSDP shard axis
    model  — tensor/expert parallelism

Rules are keyed on the *leaf name* (the last `/` path component), so the same
engine covers every tree we place: raw param trees `{"base":…, "peft":…}`,
train states `{step, trainable, opt, …}`, frozen trees, optimizer moments
(they inherit the rule of the weight they mirror, because `mu/…/wq` ends in
`wq`), and adapter trees (whose leaves — `c`, `entries`, `b1`, `lora_a`, … —
replicate by decision: FourierFT coefficients are ~n·L numbers, sharding
them would cost more in collectives than it saves).

Weight table (trailing dims; leading stack dims (L,) / (L,E) stay unsharded
so per-layer slices keep their spec):

    column-parallel (`model` on last dim):    wq wk wv wi wg wz wx wbc wdt
                                              lm_head/head conv_b  (+ biases)
    row-parallel (`model` on 2nd-to-last):    wo wo_mlp wo_ssm embed conv_w
    expert-parallel (`model` on expert dim):  we_i we_g we_o
    replicated:                               norms, router, A_log, dt_bias,
                                              Dp, adapter leaves
                                              (c/entries/b1/b2/lora_*/kernel/
                                              delta_b), scalars

FSDP (opt-in, default from `fsdp_default`): additionally shards the largest
free matrix dim of big weights over `data`; DTensor gathers a weight where
an op needs it whole.

A spec is `P`, a tuple whose entries are None, an axis, or a tuple of axes
(the counterpart of JAX's PartitionSpec; plan files encode both alike).
`named(tree, specs, mesh)` maps specs onto DTensor placements: an axis on
tensor dim d becomes `Shard(d)` on that mesh dimension and every other mesh
dimension `Replicate()`. `place(tree, specs, mesh)` distributes a tree of
tensors accordingly. On a mesh without devices (the abstract `MeshSpec`,
which is what a run without a process group has) placement is the identity.

Every rank holds the same full values before placing (each makes the same
params and batches from the same seed), so `place` takes each rank's shard
locally, with no communication — the counterpart of `jax.device_put` of a
global array.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.tree import tree_map


class P(tuple):
    """Partition spec: one entry per tensor dim, each None (replicate), an
    axis name, or a tuple of axis names (sharded over their product, the
    first outermost). A one-axis tuple normalizes to the axis and an empty
    one to None, as JAX's PartitionSpec does."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


# Batch dims shard over these axes, outermost first.
BATCH_AXES = ("pod", "data")

# FSDP default threshold: shard base weights over `data` when the
# model-parallel-sharded copy alone would eat this fraction of the card's
# memory (cost_model.device_hbm_bytes: the card's total_memory).
FSDP_FRACTION = 0.35

# Only weights at least this many elements participate in FSDP sharding
# (below it the per-layer all-gather latency outweighs the memory win).
FSDP_MIN_ELEMS = 1 << 16

_COLUMN = {"wq", "wk", "wv", "wi", "wg", "wz", "wx", "wbc", "wdt",
           "lm_head", "head", "conv_b"}
_ROW = {"wo", "wo_mlp", "wo_ssm", "embed", "conv_w"}
_EXPERT = {"we_i", "we_g", "we_o"}
# Leaves that replicate BY DECISION, not by fall-through: norms and small
# per-layer vectors (sharding them buys nothing and costs collectives),
# the MoE router (d × num_experts — num_experts is tiny), SSM per-head
# scalars, and adapter leaves (FourierFT coefficients are ~n·L numbers).
# `repro.analysis`'s sharding-coverage audit flags any param leaf matching
# NONE of the four tables — add new leaf names here (or to a sharded
# table) rather than relying on the silent replicate fall-through.
_REPLICATE = {
    # norms (all families)
    "attn_norm", "mlp_norm", "final_norm", "norm", "gnorm",
    "q_norm", "k_norm",
    # moe router, ssm per-head parameters
    "router", "A_log", "dt_bias", "Dp",
    # adapter leaves (core/adapter.py methods)
    "c", "entries", "b1", "b2", "kernel", "lora_a", "lora_b", "delta_b",
}


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or an abstract mesh."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def axis_size(mesh, axis: str) -> int:
    """Size of `axis` in `mesh`, 1 if absent."""
    return int(mesh_axes(mesh).get(axis, 1))


def _maybe(n: int, mesh, axis: str) -> Optional[str]:
    """`axis` if present, non-trivial, and divides `n` — else None
    (replicate rather than produce an invalid uneven sharding)."""
    s = axis_size(mesh, axis)
    return axis if (s > 1 and n % s == 0) else None


def batch_axes(mesh, global_batch: int) -> Tuple[str, ...]:
    """Longest (pod, data) prefix whose combined size divides `global_batch`.
    Empty tuple means the batch dim replicates."""
    out, prod = [], 1
    for a in BATCH_AXES:
        s = axis_size(mesh, a)
        if s <= 1:
            continue
        if global_batch % (prod * s):
            break
        out.append(a)
        prod *= s
    return tuple(out)


def _backbone_param_estimate(cfg: ModelConfig) -> int:
    """Analytic backbone size (excl. embed/lm_head) for the FSDP heuristic."""
    d, L = cfg.d_model, cfg.num_layers
    attn = d * (cfg.attn_dim + 2 * cfg.kv_dim) + cfg.attn_dim * d \
        if cfg.n_heads else 0
    if cfg.moe is not None:
        mlp = cfg.moe.num_experts * 3 * d * cfg.moe.d_ff_expert \
            + d * cfg.moe.num_experts
    elif cfg.d_ff:
        mlp = (3 if cfg.gated_mlp else 2) * d * cfg.d_ff
    else:
        mlp = 0
    if cfg.ssm is not None:
        d_inner = cfg.ssm.expand * d
        ssm = (2 * d * d_inner + 2 * d * cfg.ssm.n_groups * cfg.ssm.state
               + d_inner * d)
        if cfg.family == "hybrid":
            return L * ssm + attn + mlp        # shared block stored once
        return L * ssm
    return L * (attn + mlp)


def fsdp_default(cfg: ModelConfig, mesh,
                 hbm_bytes: Optional[float] = None) -> bool:
    """FSDP on iff the TP-sharded bf16 weight copy would exceed the HBM
    budget fraction and there is a non-trivial `data` axis to shard over.
    `hbm_bytes`: the device memory to budget against (default: the card's,
    `cost_model.device_hbm_bytes`)."""
    if axis_size(mesh, "data") <= 1:
        return False
    if hbm_bytes is None:
        from repro_torch.dist.cost_model import device_hbm_bytes
        hbm_bytes = device_hbm_bytes()
    per_dev = 2.0 * _backbone_param_estimate(cfg) / axis_size(mesh, "model")
    return per_dev > FSDP_FRACTION * hbm_bytes


def rule_kind(path: str, shape: Tuple[int, ...]) -> Optional[str]:
    """Which rule table a param leaf resolves through: "expert" | "column" |
    "row" | "replicate" | "scalar", or None when the name matches NO table
    and the spec comes from the silent replicate fall-through. None is what
    `repro.analysis`'s sharding-coverage audit flags: a new model family's
    weight that nobody decided a placement for."""
    name = path.split("/")[-1]
    base = name[:-3] if name.endswith("__b") else name
    if not shape:
        return "scalar"
    if base in _EXPERT:
        # a named-but-underdimensioned leaf (e.g. a 1-D bias of a sharded
        # weight) replicates BY the table's dim gate — covered, not a gap
        return "expert" if len(shape) >= 3 else "replicate"
    if base in _COLUMN:
        return "column"
    if base in _ROW:
        return "row" if len(shape) >= 2 else "replicate"
    if base in _REPLICATE:
        return "replicate"
    return None


def _param_rule(path: str, shape: Tuple[int, ...], mesh,
                cfg: ModelConfig, fsdp: bool = False) -> P:
    """Partition spec for one parameter leaf (see module docstring table)."""
    name = path.split("/")[-1]
    base = name[:-3] if name.endswith("__b") else name
    ndim = len(shape)
    spec = [None] * ndim
    if base in _EXPERT and ndim >= 3:
        spec[-3] = _maybe(shape[-3], mesh, "model")
    elif base in _COLUMN and ndim >= 1:
        spec[-1] = _maybe(shape[-1], mesh, "model")
    elif base in _ROW and ndim >= 2:
        spec[-2] = _maybe(shape[-2], mesh, "model")
    if (fsdp and ndim >= 2 and base not in ("embed", "lm_head", "head")
            and int(np.prod(shape)) >= FSDP_MIN_ELEMS):
        free = [d for d in (ndim - 2, ndim - 1)
                if spec[d] is None and _maybe(shape[d], mesh, "data")]
        if free:
            spec[max(free, key=lambda d: shape[d])] = "data"
    return P(*spec)


def _walk_specs(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk_specs(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [_walk_specs(v, fn, path + (str(i),))
               for i, v in enumerate(tree)]
        return tuple(seq) if isinstance(tree, tuple) else seq
    return fn("/".join(path), tree)


def state_specs(tree, mesh, cfg: ModelConfig, fsdp: bool = False):
    """Specs for any state-like tree: params, (trainable, frozen), full train
    state incl. optimizer moments. Leaves are matched by name; unknown names
    (adapter leaves, counters, EMAs) replicate."""
    def rule(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape:
            return P()
        return _param_rule(path, shape, mesh, cfg, fsdp=fsdp)
    return _walk_specs(tree, rule)


# Batch leaves with an explicitly decided placement (batch_rule_kind).
# Everything here rides the batch axes on dim 0 unless batch_leaf_spec
# special-cases it; a batch leaf NOT named here falls through and the
# sharding-coverage audit flags it.
_BATCH_LEAVES = {
    "tokens", "labels", "embeds", "positions", "block_table",
    "adapter_slots", "true_len", "prefix_len", "slot",
    "scratch_page", "scratch_pages",
}


def batch_leaf_spec(path: str, shp: Tuple[int, ...], b) -> P:
    """Spec for one input-batch leaf given the chosen batch axes `b`
    (an axis tuple, or None to replicate the batch dim)."""
    nd = len(shp)
    if not nd:
        return P()
    name = path.split("/")[-1]
    if name == "positions" and nd == 3:
        return P(None, b, *([None] * (nd - 2)))
    if name == "block_table":
        # (B, pages_per_seq) slot->page map rides the batch axes; the
        # (pages_per_seq,) prefill-time row replicates
        return P(b, None) if nd == 2 else P(*([None] * nd))
    return P(b, *([None] * (nd - 1)))


def batch_rule_kind(path: str, shape: Tuple[int, ...]) -> Optional[str]:
    """Coverage classifier for input-batch leaves (mirrors `rule_kind` for
    params): "batch" | "replicate" | "scalar" for decided names, None for a
    leaf nobody placed."""
    name = path.split("/")[-1]
    if not shape:
        return "scalar"
    if name == "block_table" and len(shape) != 2:
        return "replicate"
    if name in _BATCH_LEAVES:
        return "batch"
    return None


def batch_specs(batch: Dict, mesh, shape: ShapeConfig):
    """Input batches shard their batch dim over (pod, data). The vlm
    `positions` leaf is (3, B, S) — batch lives on dim 1."""
    bax = batch_axes(mesh, shape.global_batch)
    b = bax if bax else None

    def rule(path, leaf):
        return batch_leaf_spec(path, tuple(getattr(leaf, "shape", ())), b)
    return _walk_specs(batch, rule)


def cache_leaf_spec(path: str, shp: Tuple[int, ...], mesh, b) -> P:
    """Spec for one decode-cache leaf given the chosen batch axes `b`."""
    nd = len(shp)
    name = path.split("/")[-1]
    if nd == 5 and name in ("pk", "pv"):
        # paged page pool (L, n_pages, page_size, K, hd): pages are a
        # GLOBAL pool shared by every slot (block tables map slots onto
        # them), so the page dim replicates — only the KV-head dim
        # follows the projection sharding like the dense cache
        return P(None, None, None, _maybe(shp[3], mesh, "model"), None)
    if nd >= 4 and name in ("k", "v", "attn_k", "attn_v"):
        return P(None, b, None, _maybe(shp[3], mesh, "model"),
                 *([None] * (nd - 4)))
    if name == "conv" and nd == 4:
        return P(None, b, None, _maybe(shp[3], mesh, "model"))
    if name == "ssm" and nd == 5:
        return P(None, b, _maybe(shp[2], mesh, "model"), None, None)
    if name == "pos" and nd == 1:
        # per-slot position vector of the persistent continuous-batching
        # cache: (B,) — rides the batch axes like the rows it indexes
        return P(b)
    if nd >= 2:
        return P(None, b, *([None] * (nd - 2)))
    return P()


# Cache leaves with a decided placement: attention KV (dense + paged +
# hybrid), SSM conv window / state, and the per-slot position vector.
_CACHE_LEAVES = {"k", "v", "attn_k", "attn_v", "pk", "pv", "conv", "ssm",
                 "pos"}


def cache_rule_kind(path: str, shape: Tuple[int, ...]) -> Optional[str]:
    """Coverage classifier for decode-cache leaves: which named cache rule
    places this leaf, or None when it would ride the generic batch-dim-1
    fall-through nobody decided."""
    name = path.split("/")[-1]
    if not shape:
        return "scalar"
    if name in ("pk", "pv"):
        return "paged-pool" if len(shape) == 5 else None
    if name in ("k", "v", "attn_k", "attn_v"):
        return "kv" if len(shape) >= 4 else None
    if name == "conv":
        return "conv" if len(shape) == 4 else None
    if name == "ssm":
        return "ssm" if len(shape) == 5 else None
    if name == "pos":
        return "slot-pos" if len(shape) <= 1 else None
    return None


def cache_specs(cache: Dict, mesh, cfg: ModelConfig,
                shape: ShapeConfig):
    """Decode caches: batch over (pod, data); the head-like dim over `model`
    to match the projection sharding (KV heads for attention caches, SSM
    heads for state caches, conv channels for the conv window)."""
    bax = batch_axes(mesh, shape.global_batch)
    b = bax if bax else None

    def rule(path, leaf):
        return cache_leaf_spec(path, tuple(getattr(leaf, "shape", ())),
                               mesh, b)
    return _walk_specs(cache, rule)


def placements(spec, mesh) -> Tuple:
    """DTensor placements of one spec on a DeviceMesh: `Shard(d)` on each
    mesh dimension the spec names at tensor dim d, `Replicate()` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {}
    for d, entry in enumerate(tuple(spec)):
        axes = (() if entry is None
                else (entry,) if isinstance(entry, str) else tuple(entry))
        for a in axes:
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh_axes(mesh))


def is_device_mesh(mesh) -> bool:
    """True for a DeviceMesh (placement distributes); False for the
    abstract mesh and None (placement is the identity)."""
    return mesh is not None and hasattr(mesh, "mesh_dim_names")


def named(tree, specs, mesh):
    """Map a spec tree onto DTensor placements (one tuple per leaf).
    `tree` is accepted (and ignored) so call sites read
    `named(state, state_specs(state, …), mesh)` — the specs tree already
    mirrors the state tree's structure."""
    del tree
    if isinstance(specs, P):                    # P is a tuple subclass
        return placements(specs, mesh)
    if isinstance(specs, dict):
        return {k: named(None, v, mesh) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        seq = [named(None, v, mesh) for v in specs]
        return tuple(seq) if isinstance(specs, tuple) else seq
    return placements(specs, mesh)


def place_leaf(t, pl, mesh):
    """One tensor (or DTensor) onto `mesh` with placements `pl`. A plain
    tensor is sliced to this rank's shard locally (every rank holds the
    same full value); a DTensor on the same mesh is redistributed, one on
    another mesh gathered first (elastic re-placement). Non-tensors (an
    int cache position) pass through."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if not torch.is_tensor(t):
        return t
    if isinstance(t, DTensor):
        if t.device_mesh == mesh:
            return t.redistribute(mesh, pl)
        t = t.full_tensor()
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    out = distribute_tensor(t.detach().to(dev), mesh, pl, src_data_rank=None)
    return out.requires_grad_(t.requires_grad)


def distribute(tree, pls, mesh):
    """Distribute a tree of tensors onto `mesh` per a placements tree
    (`named`); the identity on an abstract mesh (or None)."""
    if not is_device_mesh(mesh):
        return tree
    return tree_map(lambda t, pl: place_leaf(t, pl, mesh), tree, pls)


def place(tree, specs, mesh):
    """Distribute a tree of tensors onto `mesh` per its spec tree; the
    identity on an abstract mesh (or None)."""
    if not is_device_mesh(mesh):
        return tree
    return distribute(tree, named(tree, specs, mesh), mesh)
