"""Sharding plans and plan sources (the JAX package's `dist/plan.py`; the
same plan JSON, so a plan file written by either package loads in the
other).

`dist/sharding.py`'s rule table is one source of placements among several
behind a small interface:

    PlanSource.state_specs / cache_specs / batch_specs
        — drop-in for the legacy `sharding.state_specs` etc., returning the
          same PartitionSpec trees those functions return;
    PlanSource.decision(section, path, shape)
        — which named decision covered a leaf (None = silent fall-through),
          what `analysis/sharding_audit` now audits instead of re-deriving
          from the rule table;
    PlanSource.describe()
        — provenance metadata: which strategy, for which cell.

Sources:

    RulesSource      — the hand-written table (it IS `dist/sharding.py`'s
                       functions); the default everywhere.
    PlanTableSource  — a serialized `ShardingPlan` (searched by
                       `dist/planner.py` or loaded from a checked-in file),
                       falling back to the rules for any leaf the table
                       doesn't name.

`resolve(arg, ...)` maps the CLI surface (`--sharding-plan
rules|search|<path>`) onto a source; "search" runs the planner once at model
build and serving/training just use the winner.

Plan tables are keyed `(section, "<leaf-name>|<ndim>")` — the same
name-keyed matching philosophy as the rule engine, which is what lets one
table cover params, optimizer moments (`mu/…/wq` ends in `wq`), and frozen
trees alike. Stored specs are sanitized against the actual leaf shape and
mesh at apply time (axes that don't exist or don't divide are dropped to
replicate), so a plan searched on one mesh degrades safely instead of
erroring on another.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import P

SECTIONS = ("state", "cache", "batch")
PLAN_VERSION = 1


# ---------------------------------------------------------------------------
# Spec (de)serialization
# ---------------------------------------------------------------------------

def encode_spec(spec) -> List:
    """PartitionSpec -> JSON-able nested list (dim entries: None | axis |
    [axes...])."""
    out = []
    for entry in tuple(spec):
        if entry is None or isinstance(entry, str):
            out.append(entry)
        else:
            out.append(list(entry))
    return out


def decode_spec(enc) -> P:
    entries = []
    for e in enc:
        if e is None or isinstance(e, str):
            entries.append(e)
        else:
            entries.append(tuple(e))
    return P(*entries)


def sanitize_spec(spec, shape: Tuple[int, ...], mesh) -> P:
    """Clamp a stored spec to a leaf/mesh: pad/trim rank, drop axes that are
    absent from the mesh or whose product doesn't divide the dim (replicate
    instead of producing an invalid uneven sharding)."""
    entries = list(tuple(spec))[:len(shape)]
    entries += [None] * (len(shape) - len(entries))
    out = []
    for dim, entry in zip(shape, entries):
        axes = (() if entry is None
                else (entry,) if isinstance(entry, str) else tuple(entry))
        axes = [a for a in axes if shd.axis_size(mesh, a) > 1]
        prod = 1
        for a in axes:
            prod *= shd.axis_size(mesh, a)
        if not axes or dim % prod:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(tuple(axes))
    return P(*out)


def leaf_key(path: str, shape: Tuple[int, ...]) -> str:
    """Table key for a leaf: name|ndim, with the fsdp-stage suffix stripped
    the same way the rule engine strips it."""
    name = path.split("/")[-1]
    if name.endswith("__b"):
        name = name[:-3]
    return f"{name}|{len(shape)}"


# ---------------------------------------------------------------------------
# ShardingPlan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardingPlan:
    """A serializable placement: per-section spec tables plus provenance
    (which strategy produced it, on what mesh/model/workload, at what
    predicted cost, and how the alternatives ranked)."""
    meta: Dict
    tables: Dict[str, Dict[str, List]]
    version: int = PLAN_VERSION

    def spec_for(self, section: str, path: str,
                 shape: Tuple[int, ...]) -> Optional[P]:
        enc = self.tables.get(section, {}).get(leaf_key(path, shape))
        return None if enc is None else decode_spec(enc)

    def put(self, section: str, path: str, shape: Tuple[int, ...],
            spec) -> None:
        self.tables.setdefault(section, {})[leaf_key(path, shape)] = \
            encode_spec(spec)

    def to_json(self) -> Dict:
        return {"version": self.version, "meta": self.meta,
                "tables": {s: dict(sorted(t.items()))
                           for s, t in sorted(self.tables.items())}}

    @classmethod
    def from_json(cls, obj: Dict) -> "ShardingPlan":
        if obj.get("version", 1) != PLAN_VERSION:
            raise ValueError(f"unsupported plan version {obj.get('version')}")
        return cls(meta=dict(obj.get("meta", {})),
                   tables={s: dict(t)
                           for s, t in obj.get("tables", {}).items()})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "ShardingPlan":
        with open(path) as f:
            return cls.from_json(json.load(f))


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------

class PlanSource:
    """Where placements come from. Implementations must return spec trees
    with EXACTLY the same structure/semantics as the legacy
    `sharding.state_specs`/`cache_specs`/`batch_specs`."""

    kind = "abstract"

    def state_specs(self, tree, mesh, cfg, fsdp: bool = False):
        raise NotImplementedError

    def cache_specs(self, cache, mesh, cfg, shape):
        raise NotImplementedError

    def batch_specs(self, batch, mesh, shape):
        raise NotImplementedError

    def decision(self, section: str, path: str,
                 shape: Tuple[int, ...]) -> Optional[str]:
        """Which named decision covers this leaf (None = nobody placed it;
        the audit flags those)."""
        raise NotImplementedError

    def param_spec(self, path: str, shape: Tuple[int, ...], mesh, cfg,
                   fsdp: bool = False):
        """Per-leaf state spec: the placement the plan chose for one
        weight's storage."""
        raise NotImplementedError

    def describe(self) -> Dict:
        return {"source": self.kind}


class RulesSource(PlanSource):
    """The hand-written rule table: it delegates to `dist/sharding.py`'s
    functions."""

    kind = "rules"

    def state_specs(self, tree, mesh, cfg, fsdp: bool = False):
        return shd.state_specs(tree, mesh, cfg, fsdp=fsdp)

    def cache_specs(self, cache, mesh, cfg, shape):
        return shd.cache_specs(cache, mesh, cfg, shape)

    def batch_specs(self, batch, mesh, shape):
        return shd.batch_specs(batch, mesh, shape)

    def decision(self, section, path, shape):
        if section == "state":
            return shd.rule_kind(path, shape)
        if section == "cache":
            return shd.cache_rule_kind(path, shape)
        if section == "batch":
            return shd.batch_rule_kind(path, shape)
        raise ValueError(f"unknown section {section!r}")

    def param_spec(self, path, shape, mesh, cfg, fsdp: bool = False):
        return shd._param_rule(path, shape, mesh, cfg, fsdp=fsdp)


class PlanTableSource(PlanSource):
    """Specs from a `ShardingPlan` table; any leaf the table doesn't name
    falls back to the rules (so a partial plan is always safe to apply)."""

    kind = "plan"

    def __init__(self, plan: ShardingPlan,
                 fallback: Optional[PlanSource] = None):
        self.plan = plan
        self.fallback = fallback or RulesSource()

    def _resolved(self, section, path, shape, mesh, fallback_spec):
        spec = self.plan.spec_for(section, path, shape)
        if spec is None:
            return fallback_spec()
        return sanitize_spec(spec, shape, mesh)

    def state_specs(self, tree, mesh, cfg, fsdp: bool = False):
        def rule(path, leaf):
            shape = tuple(getattr(leaf, "shape", ()))
            if not shape:
                return P()
            return self._resolved(
                "state", path, shape, mesh,
                lambda: shd._param_rule(path, shape, mesh, cfg, fsdp=fsdp))
        return shd._walk_specs(tree, rule)

    def cache_specs(self, cache, mesh, cfg, shape):
        b = shd.batch_axes(mesh, shape.global_batch) or None

        def rule(path, leaf):
            shp = tuple(getattr(leaf, "shape", ()))
            return self._resolved(
                "cache", path, shp, mesh,
                lambda: shd.cache_leaf_spec(path, shp, mesh, b))
        return shd._walk_specs(cache, rule)

    def batch_specs(self, batch, mesh, shape):
        b = shd.batch_axes(mesh, shape.global_batch) or None

        def rule(path, leaf):
            shp = tuple(getattr(leaf, "shape", ()))
            return self._resolved(
                "batch", path, shp, mesh,
                lambda: shd.batch_leaf_spec(path, shp, b))
        return shd._walk_specs(batch, rule)

    def decision(self, section, path, shape):
        if self.plan.spec_for(section, path, shape) is not None:
            return "plan"
        return self.fallback.decision(section, path, shape)

    def param_spec(self, path, shape, mesh, cfg, fsdp: bool = False):
        spec = self.plan.spec_for("state", path, shape)
        if spec is None:
            return self.fallback.param_spec(path, shape, mesh, cfg,
                                            fsdp=fsdp)
        return sanitize_spec(spec, shape, mesh)

    def describe(self) -> Dict:
        meta = self.plan.meta
        return {"source": self.kind,
                "strategy": meta.get("strategy"),
                "plan_meta": {k: meta[k]
                              for k in ("arch", "mesh", "workload", "shape")
                              if k in meta}}


# ---------------------------------------------------------------------------
# CLI surface
# ---------------------------------------------------------------------------

def resolve(arg: Optional[str], *, model=None, mesh=None, shape=None,
            workload: Optional[str] = None) -> PlanSource:
    """Map `--sharding-plan rules|search|<path>` onto a source.

    "search" runs the planner once against `model` on `mesh` (on shapes
    only: nothing runs) and applies the winning plan; a path loads a plan
    file. Resolution happens once at model build; everything downstream
    just consumes the source. Every rank resolves the same plan: the
    planner is deterministic and reads nothing rank-specific.
    """
    if arg in (None, "", "rules"):
        return RulesSource()
    if arg == "search":
        if model is None or mesh is None:
            raise ValueError("--sharding-plan search needs a built model "
                             "and a mesh to plan against")
        from repro_torch.dist import planner
        plan = planner.plan_model(model, mesh, shape=shape,
                                  workload=workload)
        return PlanTableSource(plan)
    return PlanTableSource(ShardingPlan.load(arg))
