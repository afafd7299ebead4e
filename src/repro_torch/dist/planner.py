"""Placement planner: search per-leaf layouts against the cluster cost model
(the JAX package's `dist/planner.py`; for the same cell and the same
`ClusterEnv` both packages emit the same plan JSON).

For one (model, mesh, workload) cell the planner

  1. walks the same trees the sharding-coverage audit walks — param/state
     leaves, decode-cache leaves, input-batch leaves (all abstract; nothing
     materializes);
  2. enumerates per-leaf candidate placements: replicate, column/row/expert
     model-sharding (name-gated like the rule table, so a norm is never
     column-sharded), and fsdp data-scatter variants — ALWAYS including the
     spec the rule table itself would pick;
  3. scores each candidate with `dist/cost_model.ClusterEnv`: matmul compute
     split over (batch × model) shards, weight-stream HBM traffic, gradient
     all-reduce for trainable leaves, fsdp gather/scatter, and the
     Megatron-style activation collective charge for tensor-parallel weights
     (column pairs with the row that follows it, so it carries half an
     all-reduce; rows carry a full one; experts carry the dispatch/combine
     all-to-all);
  4. takes the per-leaf argmin — exact, because the objective decomposes
     leafwise once the batch-shard prefix is fixed — inside an outer loop
     over every valid (pod, data) batch prefix, then repairs HBM-capacity
     overflows by flipping the largest-resident leaves to their cheapest
     smaller-resident candidate;
  5. emits a ranked, serializable `ShardingPlan` whose winner is
     min(search, rules) — the search can never score worse than the rule
     table under its own cost model, by construction.

The interesting regime split this captures: at production scale
tensor-parallel wins (compute/HBM dominate, activation all-reduces are
bandwidth-cheap relative to the savings), while at smoke scale the same
all-reduces are pure per-launch latency and replicate-everywhere wins —
which is why a searched smoke-cell plan beats the rule table on the
collective bytes `dist/opstats.py` records for a step.

The trees are walked on `torch.device("meta")` tensors (`Model.init_shapes`,
`cache_specs`, `input_specs`): nothing materializes, so a production
16x16 cell plans on any machine.

CLI (the gate):

    python -m repro_torch.dist.planner --arch yi-6b --reduced --mesh 4x2 \
        --shape train_4k --out plan.json --check-search-beats-rules
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.dist import sharding as shd
from repro_torch.dist.cost_model import (ClusterEnv, MeshSpec, PlanCost,
                                         shard_factor, spec_axes)
from repro_torch.dist.plan import (PlanSource, PlanTableSource, RulesSource,
                                   ShardingPlan, leaf_key)
from repro_torch.dist.sharding import P

# Optimizer-state multiplier for trainable leaves: bf16/fp32 param + two
# fp32 Adam moments ≈ 3x the param bytes resident.
TRAIN_STATE_MULT = 3.0
# Soft capacity penalty: each byte over HBM is priced as this many extra
# HBM round-trips (it really means host offload / OOM — make it dominate).
CAPACITY_PENALTY = 32.0


@dataclasses.dataclass
class _Leaf:
    section: str
    path: str
    shape: Tuple[int, ...]
    nbytes: float
    elems: float
    trainable: bool = False

    @property
    def name(self) -> str:
        n = self.path.split("/")[-1]
        return n[:-3] if n.endswith("__b") else n


def _iter_leaves(tree, path=()):
    # P subclasses tuple — it's a leaf here, never a container
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _iter_leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        for i, v in enumerate(tree):
            yield from _iter_leaves(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _leaves(tree, section: str) -> List[_Leaf]:
    out = []
    for path, leaf in _iter_leaves(tree):
        shape = tuple(int(s) for s in getattr(leaf, "shape", ()))
        elems = float(np.prod(shape)) if shape else 1.0
        itemsize = getattr(getattr(leaf, "dtype", None), "itemsize", 2)
        out.append(_Leaf(section, path, shape, elems * itemsize, elems,
                         trainable=path.startswith("peft")))
    return out


# ---------------------------------------------------------------------------
# Candidates
# ---------------------------------------------------------------------------

def _with_fsdp(spec_entries: List, shape, mesh) -> Optional[P]:
    """Add the fsdp `data` scatter on the largest free matrix dim, the same
    way `_param_rule` does."""
    nd = len(shape)
    free = [d for d in (nd - 2, nd - 1)
            if spec_entries[d] is None and shd._maybe(shape[d], mesh, "data")]
    if not free:
        return None
    entries = list(spec_entries)
    entries[max(free, key=lambda d: shape[d])] = "data"
    return P(*entries)


def state_candidates(leaf: _Leaf, mesh, cfg,
                     rules_spec: P) -> Dict[str, P]:
    """Per-leaf candidate placements, keyed by a human-readable strategy
    label. Always contains the rule table's own choice."""
    shape, nd, base = leaf.shape, len(leaf.shape), leaf.name
    cands: Dict[str, P] = {"rules": rules_spec}
    if not nd:
        return cands
    cands["replicate"] = P(*([None] * nd))
    sharded: Dict[str, List] = {}
    if base in shd._EXPERT and nd >= 3 and shd._maybe(shape[-3], mesh, "model"):
        e = [None] * nd
        e[-3] = "model"
        sharded["expert"] = e
    if base in shd._COLUMN and shd._maybe(shape[-1], mesh, "model"):
        e = [None] * nd
        e[-1] = "model"
        sharded["column"] = e
    if base in shd._ROW and nd >= 2 and shd._maybe(shape[-2], mesh, "model"):
        e = [None] * nd
        e[-2] = "model"
        sharded["row"] = e
    for label, entries in sharded.items():
        cands[label] = P(*entries)
    # fsdp variants (not for the token tables — same gate as _param_rule)
    if (nd >= 2 and base not in ("embed", "lm_head", "head")
            and leaf.elems >= shd.FSDP_MIN_ELEMS):
        for label, entries in [("replicate", [None] * nd)] + \
                list(sharded.items()):
            f = _with_fsdp(entries, shape, mesh)
            if f is not None:
                cands[f"{label}+fsdp"] = f
    # dedupe identical specs (keep first label)
    seen, out = set(), {}
    for label, spec in cands.items():
        key = tuple(spec)
        if key not in seen:
            seen.add(key)
            out[label] = spec
    return out


# ---------------------------------------------------------------------------
# Leaf cost
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Ctx:
    env: ClusterEnv
    cfg: object
    workload: str              # train | prefill | decode
    tokens: float              # per step, global
    batch_div: int             # chosen batch-shard product
    act_bytes_local: float     # per-device activation slab (B_loc·S·d·2)

    @property
    def train(self) -> bool:
        return self.workload == "train"


def _matmul_class(name: str) -> Optional[str]:
    if name in shd._EXPERT:
        return "expert"
    if name in shd._COLUMN:
        return "column"
    if name in shd._ROW:
        return "row"
    return None


def leaf_cost(leaf: _Leaf, spec: P, ctx: _Ctx) -> PlanCost:
    """Price one leaf under one placement (see module docstring, step 3)."""
    env, cost = ctx.env, PlanCost()
    axes = spec_axes(spec)
    model_div = env.group_size(a for a in axes if a == "model")
    storage_div = shard_factor(spec, env.mesh)
    fsdp = "data" in axes

    if leaf.section == "state":
        mm = _matmul_class(leaf.name)
        is_matmul = mm is not None and len(leaf.shape) >= 2
        elems_eff = leaf.elems
        if mm == "expert" and getattr(ctx.cfg, "moe", None) is not None:
            elems_eff *= ctx.cfg.moe.top_k / ctx.cfg.moe.num_experts
        if is_matmul:
            flops_mult = 6.0 if ctx.train else 2.0
            cost.compute_s = env.compute_s(
                flops_mult * elems_eff * ctx.tokens
                / (ctx.batch_div * model_div))
        # weight stream: the (gathered, model-sharded) copy is read once per
        # step; fsdp changes residency, not the bytes the matmul reads
        cost.memory_s = env.memory_s(leaf.nbytes / model_div)
        mult = TRAIN_STATE_MULT if (ctx.train and leaf.trainable) else 1.0
        cost.resident_bytes = leaf.nbytes / storage_div * mult
        if fsdp:
            n = leaf.nbytes / model_div
            passes = 2 if ctx.train else 1      # fwd + bwd re-gather
            cost.add_collective(
                "all-gather", passes * env.all_gather_cost(n, ("data",)),
                passes * n)
            if ctx.train and leaf.trainable:
                cost.add_collective(
                    "reduce-scatter",
                    env.reduce_scatter_cost(n, ("data",)), n)
        if ctx.train and leaf.trainable:
            dp_axes = [a for a in shd.BATCH_AXES
                       if a not in axes and env.mesh.axis_size(a) > 1]
            if dp_axes:
                n = leaf.nbytes / storage_div
                cost.add_collective(
                    "all-reduce", env.all_reduce_cost(n, dp_axes), n)
        if is_matmul and model_div > 1:
            stack = leaf.shape[0] if len(leaf.shape) >= 3 else 1
            passes = 2 if ctx.train else 1
            n = ctx.act_bytes_local
            if mm == "expert":
                # dispatch + combine all-to-all per pass
                sec = 2 * env.all_to_all_cost(n, ("model",))
                cost.add_collective("all-to-all", stack * passes * sec,
                                    stack * passes * 2 * n)
            else:
                # Megatron pairing: the column half of a column->row pair
                # carries half the pair's all-reduce, the row carries a
                # full one (rows also appear unpaired: embed, wo_ssm)
                discount = 0.5 if mm == "column" else 1.0
                sec = discount * env.all_reduce_cost(n, ("model",))
                cost.add_collective("all-reduce", stack * passes * sec,
                                    stack * passes * discount * n)
        return cost

    # cache / batch leaves: storage + (decode) per-step stream
    cost.resident_bytes = leaf.nbytes / storage_div
    if leaf.section == "cache" and ctx.workload == "decode":
        cost.memory_s = env.memory_s(leaf.nbytes / storage_div)
    return cost


def _merge(total: PlanCost, leaf: PlanCost) -> None:
    total.compute_s += leaf.compute_s
    total.memory_s += leaf.memory_s
    total.collective_s += leaf.collective_s
    total.resident_bytes += leaf.resident_bytes
    total.collective_bytes += leaf.collective_bytes
    for k, v in leaf.by_kind.items():
        total.by_kind[k] = total.by_kind.get(k, 0.0) + v


def _objective(total: PlanCost, env: ClusterEnv) -> float:
    over = max(0.0, total.resident_bytes - env.hbm_bytes)
    return total.total_s + CAPACITY_PENALTY * env.memory_s(over)


# ---------------------------------------------------------------------------
# Whole-cell planning
# ---------------------------------------------------------------------------

def _batch_choices(mesh: MeshSpec, global_batch: int) -> List[Tuple[str, ...]]:
    """Every valid (pod, data) batch prefix, shortest first."""
    out: List[Tuple[str, ...]] = [()]
    prod = 1
    for a in shd.BATCH_AXES:
        s = mesh.axis_size(a)
        if s <= 1:
            continue
        if global_batch % (prod * s):
            break
        prod *= s
        out.append(out[-1] + (a,))
    return out


def _ctx_for(env: ClusterEnv, cfg, shape, workload: str,
             bchoice: Tuple[str, ...]) -> _Ctx:
    bdiv = env.group_size(bchoice) or 1
    if workload == "decode":
        tokens = float(shape.global_batch)
        act = shape.global_batch * cfg.d_model * 2.0 / bdiv
    else:
        tokens = float(shape.global_batch) * shape.seq_len
        act = shape.global_batch * shape.seq_len * cfg.d_model * 2.0 / bdiv
    return _Ctx(env=env, cfg=cfg, workload=workload, tokens=tokens,
                batch_div=bdiv, act_bytes_local=act)


def _model_trees(model, shape, workload: str):
    state = model.init_shapes()
    cache = None
    if workload == "decode":
        try:
            cache = model.cache_specs(shape)
        except Exception:
            cache = None
    try:
        batch = model.input_specs(shape)
    except Exception:
        batch = None
    return state, cache, batch


def _aux_specs(leaf: _Leaf, mesh, b) -> P:
    if leaf.section == "cache":
        return shd.cache_leaf_spec(leaf.path, leaf.shape, mesh, b)
    return shd.batch_leaf_spec(leaf.path, leaf.shape, b)


def _score_assignment(state_specs: Dict[str, P], leaves: List[_Leaf],
                      aux: List[_Leaf], ctx: _Ctx,
                      b) -> PlanCost:
    total = PlanCost()
    for leaf in leaves:
        _merge(total, leaf_cost(leaf, state_specs[leaf.path], ctx))
    for leaf in aux:
        _merge(total, leaf_cost(leaf, _aux_specs(leaf, ctx.env.mesh, b), ctx))
    return total


def plan_model(model, mesh, shape=None, workload: Optional[str] = None,
               env: Optional[ClusterEnv] = None) -> ShardingPlan:
    """Search placements for one (model, mesh, workload) cell and return the
    winning plan (ranked alternatives in `meta["ranked"]`)."""
    if shape is None:
        raise ValueError("plan_model needs a ShapeConfig (batch/seq sizes "
                         "drive every cost term)")
    mesh_spec = MeshSpec.from_mesh(mesh)
    env = env or ClusterEnv(mesh_spec)
    cfg = model.cfg
    workload = workload or ("train" if shape.kind == "train" else shape.kind)
    fsdp_rules = shd.fsdp_default(cfg, mesh_spec, hbm_bytes=env.hbm_bytes)

    state_tree, cache_tree, batch_tree = _model_trees(model, shape, workload)
    state_leaves = _leaves(state_tree, "state")
    aux_leaves = ([] if cache_tree is None
                  else _leaves(cache_tree, "cache"))
    batch_leaves = [] if batch_tree is None else _leaves(batch_tree, "batch")
    aux_leaves += batch_leaves

    rules_specs = {
        leaf.path: shd._param_rule(leaf.path, leaf.shape, mesh_spec, cfg,
                                   fsdp=fsdp_rules)
        for leaf in state_leaves}
    b_rules = shd.batch_axes(mesh_spec, shape.global_batch)

    ranked = []        # (label, bchoice, specs, PlanCost)

    # -- rules, scored under the same model ---------------------------------
    ctx_rules = _ctx_for(env, cfg, shape, workload, b_rules)
    cost_rules = _score_assignment(rules_specs, state_leaves, aux_leaves,
                                   ctx_rules, b_rules or None)
    ranked.append(("rules", b_rules, rules_specs, cost_rules))

    # -- search: per-leaf argmin per batch choice, then capacity repair -----
    for bchoice in _batch_choices(mesh_spec, shape.global_batch):
        ctx = _ctx_for(env, cfg, shape, workload, bchoice)
        chosen: Dict[str, P] = {}
        options: Dict[str, Dict[str, Tuple[P, PlanCost]]] = {}
        for leaf in state_leaves:
            cands = state_candidates(leaf, mesh_spec, cfg,
                                     rules_specs[leaf.path])
            priced = {lab: (spec, leaf_cost(leaf, spec, ctx))
                      for lab, spec in cands.items()}
            options[leaf.path] = priced
            best = min(priced.values(),
                       key=lambda sc: (sc[1].total_s, sc[1].resident_bytes))
            chosen[leaf.path] = best[0]
        total = _score_assignment(chosen, state_leaves, aux_leaves, ctx,
                                  bchoice or None)
        # capacity repair: flip the largest-resident leaves to their
        # cheapest smaller-resident candidate until the cell fits
        guard = 0
        while total.resident_bytes > env.hbm_bytes and guard < 64:
            guard += 1
            cur = {leaf.path: leaf_cost(leaf, chosen[leaf.path], ctx)
                   for leaf in state_leaves}
            flips = []
            for leaf in state_leaves:
                have = cur[leaf.path]
                better = [(spec, c) for spec, c in options[leaf.path].values()
                          if c.resident_bytes < have.resident_bytes]
                if better:
                    spec, c = min(better, key=lambda sc: sc[1].total_s)
                    flips.append((have.resident_bytes - c.resident_bytes,
                                  leaf.path, spec))
            if not flips:
                break
            _, path, spec = max(flips)
            chosen[path] = spec
            total = _score_assignment(chosen, state_leaves, aux_leaves, ctx,
                                      bchoice or None)
        label = "search[b=" + (",".join(bchoice) or "-") + "]"
        ranked.append((label, bchoice, chosen, total))

    ranked.sort(key=lambda r: _objective(r[3], env))
    win_label, win_b, win_specs, win_cost = ranked[0]

    plan = ShardingPlan(meta={}, tables={})
    for leaf in state_leaves:
        key = leaf_key(leaf.path, leaf.shape)
        if key not in plan.tables.get("state", {}):
            plan.put("state", leaf.path, leaf.shape, win_specs[leaf.path])
    b = tuple(win_b) or None
    for leaf in aux_leaves:
        section = leaf.section
        if leaf_key(leaf.path, leaf.shape) not in plan.tables.get(section, {}):
            plan.put(section, leaf.path, leaf.shape,
                     _aux_specs(leaf, mesh_spec, b))
    plan.meta = {
        "arch": getattr(cfg, "name", "?"),
        "method": getattr(getattr(model, "peft", None), "method", None),
        "mesh": dict(mesh_spec.axes),
        "workload": workload,
        "shape": getattr(shape, "name", "?"),
        "strategy": win_label,
        "batch_axes": list(win_b),
        "fsdp_rules": bool(fsdp_rules),
        "cost": win_cost.to_json(),
        "ranked": [{"strategy": lab,
                    "batch_axes": list(bc),
                    "objective_s": _objective(c, env),
                    **c.to_json()}
                   for lab, bc, _, c in ranked],
    }
    return plan


# ---------------------------------------------------------------------------
# Scoring an existing source (rules, file, ...) under the same cost model
# ---------------------------------------------------------------------------

def score_source(model, mesh, shape, source: PlanSource,
                 workload: Optional[str] = None,
                 env: Optional[ClusterEnv] = None) -> PlanCost:
    """Predicted cost of whatever placements `source` resolves for this
    cell, to set beside what `dist/opstats.py` records for a step."""
    mesh_spec = MeshSpec.from_mesh(mesh)
    env = env or ClusterEnv(mesh_spec)
    cfg = model.cfg
    workload = workload or ("train" if shape.kind == "train" else shape.kind)
    fsdp = shd.fsdp_default(cfg, mesh_spec, hbm_bytes=env.hbm_bytes)
    state_tree, cache_tree, batch_tree = _model_trees(model, shape, workload)

    spec_by_path: Dict[Tuple[str, str], P] = {}
    for section, tree, specs in (
            ("state", state_tree,
             source.state_specs(state_tree, mesh_spec, cfg, fsdp=fsdp)),
            ("cache", cache_tree,
             None if cache_tree is None
             else source.cache_specs(cache_tree, mesh_spec, cfg, shape)),
            ("batch", batch_tree,
             None if batch_tree is None
             else source.batch_specs(batch_tree, mesh_spec, shape))):
        if specs is None:
            continue
        for path, spec in _iter_leaves(specs):
            spec_by_path[(section, path)] = spec

    # infer the batch-shard choice from the token leaf's dim-0 axes
    b_axes: Tuple[str, ...] = shd.batch_axes(mesh_spec, shape.global_batch)
    for (section, path), spec in spec_by_path.items():
        if section == "batch" and path.split("/")[-1] == "tokens":
            entries = tuple(spec)
            if entries:
                e = entries[0]
                b_axes = (() if e is None else
                          (e,) if isinstance(e, str) else tuple(e))
            break
    ctx = _ctx_for(env, cfg, shape, workload, b_axes)

    total = PlanCost()
    for section, tree in (("state", state_tree), ("cache", cache_tree),
                          ("batch", batch_tree)):
        if tree is None:
            continue
        for leaf in _leaves(tree, section):
            spec = spec_by_path.get((section, leaf.path))
            if spec is None:
                continue
            _merge(total, leaf_cost(leaf, spec, ctx))
    return total


def spec_diff(source_a: PlanSource, source_b: PlanSource, model, mesh, cfg,
              shape, workload: str) -> List[Dict]:
    """Leaf-level placement differences between two sources (the CLI's
    `--diff-rules`)."""
    mesh_spec = MeshSpec.from_mesh(mesh)
    fsdp = shd.fsdp_default(cfg, mesh_spec)
    state_tree, cache_tree, batch_tree = _model_trees(model, shape, workload)
    out: List[Dict] = []
    for section, tree, get in (
            ("state", state_tree,
             lambda s: s.state_specs(state_tree, mesh_spec, cfg, fsdp=fsdp)),
            ("cache", cache_tree,
             lambda s: s.cache_specs(cache_tree, mesh_spec, cfg, shape)),
            ("batch", batch_tree,
             lambda s: s.batch_specs(batch_tree, mesh_spec, shape))):
        if tree is None:
            continue
        a = dict(_iter_leaves(get(source_a)))
        bb = dict(_iter_leaves(get(source_b)))

        def norm(spec):
            # a dim entry ('data',) and 'data' are the same placement
            if spec is None:
                return None
            return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                         for e in tuple(spec))

        for path in sorted(set(a) | set(bb)):
            na, nb = norm(a.get(path)), norm(bb.get(path))
            if na != nb:
                out.append({"section": section, "path": path,
                            "a": None if na is None else list(na),
                            "b": None if nb is None else list(nb)})
    return out


# ---------------------------------------------------------------------------
# CLI — the gate
# ---------------------------------------------------------------------------

def _build_model(arch: str, reduced: bool, method: str, remat: str):
    from repro_torch import configs
    from repro_torch.configs.base import PEFTConfig
    from repro_torch.models.registry import build
    cfg = configs.get(arch)
    if reduced:
        cfg = configs.reduced(cfg)
    n = 16 if reduced else 1000
    peft = (PEFTConfig(method="none") if method == "none"
            else PEFTConfig(method=method, n=n, alpha=300.0,
                            strategy="merged"))
    return cfg, build(cfg, peft, remat=remat)


def main(argv: Optional[Sequence[str]] = None) -> int:
    from repro_torch import configs
    ap = argparse.ArgumentParser(
        description="search sharding placements for one cell")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="4x2",
                    help="DxM or PxDxM abstract mesh (no devices needed)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--method", default="fourierft")
    ap.add_argument("--out", default=None, help="write the winning plan JSON")
    ap.add_argument("--check-search-beats-rules", action="store_true",
                    help="exit 1 unless the winner scores <= rules "
                         "under the cost model (the gate)")
    ap.add_argument("--diff-rules", action="store_true",
                    help="print the leafwise spec differences between the "
                         "searched plan and the rule table")
    ap.add_argument("--audit", action="store_true",
                    help="run the sharding-coverage audit against the "
                         "searched plan (exit 1 on findings)")
    args = ap.parse_args(argv)

    shape = configs.shape_for(args.shape)
    workload = "train" if shape.kind == "train" else shape.kind
    remat = "full" if workload == "train" else "none"
    cfg, model = _build_model(args.arch, args.reduced, args.method, remat)
    mesh = MeshSpec.from_string(args.mesh)
    plan = plan_model(model, mesh, shape=shape, workload=workload)

    ranked = plan.meta["ranked"]
    for row in ranked:
        print(f"{row['strategy']:>24}  objective={row['objective_s']:.3e}s  "
              f"coll={row['collective_bytes']:.3e}B  "
              f"resident={row['resident_bytes']:.3e}B")
    if args.out:
        plan.save(args.out)
        print(f"wrote {args.out} (strategy={plan.meta['strategy']})")
    if args.diff_rules:
        diffs = spec_diff(RulesSource(), PlanTableSource(plan),
                          model, mesh, cfg, shape, workload)
        for d in diffs:
            print(f"diff {d['section']}:{d['path']}  "
                  f"rules={d['a']}  plan={d['b']}")
        print(f"{len(diffs)} spec diffs vs rules")
    if args.audit:
        from repro_torch.analysis import sharding_audit
        src = PlanTableSource(plan)
        state_tree, cache_tree, batch_tree = _model_trees(model, shape,
                                                          workload)
        findings = sharding_audit.audit_tree(
            state_tree, f"{args.arch}[plan]", source=src)
        if cache_tree is not None:
            findings += sharding_audit.audit_tree(
                cache_tree, f"{args.arch}[plan-cache]", section="cache",
                source=src)
        if batch_tree is not None:
            findings += sharding_audit.audit_tree(
                batch_tree, f"{args.arch}[plan-batch]", section="batch",
                source=src)
        for f in findings:
            print(f"AUDIT {f.where}: {f.message}", file=sys.stderr)
        if findings:
            return 1
        print("audit: every leaf of the searched plan has a decision")
    if args.check_search_beats_rules:
        rules = next(r for r in ranked if r["strategy"] == "rules")
        best = ranked[0]
        if best["objective_s"] > rules["objective_s"] * (1 + 1e-9):
            print("FAIL: searched plan scores worse than the rule table",
                  file=sys.stderr)
            return 1
        print("ok: search <= rules under the cost model")
    return 0


if __name__ == "__main__":
    sys.exit(main())
