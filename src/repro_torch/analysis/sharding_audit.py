"""Sharding-coverage audit (the JAX package's `analysis/sharding_audit.py`).

Placement is name-keyed, and any leaf matching no named decision silently
replicates (params) or rides the generic batch fall-through (caches/
batches). That fall-through is how the mamba2/hybrid families initially
shipped with undecided placements in the JAX package: the engine never
errored, it just replicated whatever it didn't recognize. This pass makes
the decision explicit, and audits the RESOLVED PLAN, i.e. whatever
`dist/plan.PlanSource` actually produced for the cell (the rule table by
default, a searched or loaded plan otherwise), via
`PlanSource.decision(section, path, shape)`. A plan-table hit counts as a
decision; a miss falls back to the source's fallback rules, and only a leaf
NO layer decided is flagged.

Coverage spans every tree serving and training place:

- param/state trees for every registered arch × a representative set of
  adapter methods ("state" section);
- decode caches — dense per-slot AND the paged page-pool — plus the serve
  batch leaves (block tables, adapter slot rows, scratch pages) and
  adapter-bank row stacks ("cache"/"batch"/"state" sections), so a searched
  plan can't silently leave a serving leaf unplaced.

The fix for a finding is to add the leaf name to the matching table in
dist/sharding.py (or ship a plan entry for it), making the placement a
decision instead of an accident.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.analysis.report import Finding

# one method per distinct adapter-param leaf set: fourier/dct share "c"
# (+ spectral aux), lora has lora_a/lora_b, circulant has kernel+b1/b2,
# bitfit has delta_b — together they exercise every adapter leaf name.
DEFAULT_METHODS = ("fourierft", "dct", "lora", "circulant", "bitfit")

# serve-coverage geometry (shapes only — nothing materializes)
_SERVE_SLOTS = 4
_SERVE_LEN = 64
_PAGE_SIZE = 8
_N_PAGES = 16
_BANK_K = 2


def _iter_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _iter_leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _iter_leaves(v, path + (str(i),))
    else:
        yield "/".join(path), tuple(getattr(tree, "shape", ()))


def _default_source():
    from repro_torch.dist import plan as plan_mod
    return plan_mod.RulesSource()


def audit_tree(tree, label: str, section: str = "state",
               source=None) -> List[Finding]:
    """Flag every leaf of a (shape) tree that the resolved plan source left
    undecided — the silent fall-through instead of a named decision."""
    if source is None:
        source = _default_source()
    out: List[Finding] = []
    seen = set()
    for path, shape in _iter_leaves(tree):
        name = path.split("/")[-1]
        if source.decision(section, path, shape) is not None or name in seen:
            continue
        seen.add(name)                 # one finding per leaf NAME per tree
        out.append(Finding(
            "sharding", "uncovered", f"{label}/{name}",
            f"{section} leaf {path!r} (shape {shape}) has no placement "
            f"decision from the resolved plan source "
            f"({source.describe().get('source')}) — it falls through "
            "undecided; add the name to a dist/sharding.py table or ship a "
            "plan entry for it"))
    return out


def _serve_trees(model):
    """(tree, label-suffix, section) triples for the serving surfaces:
    dense + paged decode caches, the decode batch (incl. block table and
    scratch pages), and adapter-bank row stacks — meta tensors, nothing
    allocated."""
    out = []
    slot_cache = bool(model.supports_slot_cache)
    meta = "meta"
    try:
        dense = model.init_cache(_SERVE_SLOTS, _SERVE_LEN, torch.bfloat16,
                                 meta, per_slot=slot_cache)
        out.append((dense, "cache", "cache"))
    except Exception:
        pass
    if slot_cache:
        try:
            paged = model.init_cache(_SERVE_SLOTS, _SERVE_LEN,
                                     torch.bfloat16, meta, paged=True,
                                     page_size=_PAGE_SIZE, n_pages=_N_PAGES)
            out.append((paged, "paged-cache", "cache"))
        except Exception:
            pass

    def i32(shape):
        return torch.empty(shape, dtype=torch.int32, device=meta)
    pages_per_seq = _SERVE_LEN // _PAGE_SIZE
    batch = {
        "tokens": i32((_SERVE_SLOTS, 1)),
        "block_table": i32((_SERVE_SLOTS, pages_per_seq)),
        "adapter_slots": i32((_SERVE_SLOTS,)),
        "true_len": i32((_SERVE_SLOTS,)),
        "prefix_len": i32(()),
        "slot": i32(()),
        "scratch_pages": i32((_SERVE_SLOTS,)),
    }
    out.append((batch, "serve-batch", "batch"))
    # adapter-bank rows: the peft site leaves with the (K+1,) bank-row dim
    # prepended — name-keyed placement must still cover them
    peft_tree = model.init_shapes().get("peft")
    if peft_tree:
        bank = {
            path: torch.empty((_BANK_K + 1,) + shape, dtype=torch.float32,
                              device=meta)
            for path, shape in _iter_leaves(peft_tree)}
        out.append((bank, "bank-rows", "state"))
    return out


def run(methods: Tuple[str, ...] = DEFAULT_METHODS,
        archs: Optional[Tuple[str, ...]] = None,
        source=None) -> List[Finding]:
    """Audit every registered arch's param tree, plus the serving surfaces
    (caches/batch/bank) on the first arch. The adapter-method sweep runs on
    the first arch only — adapter leaf names don't vary per family.
    `source` defaults to the rules; pass a `PlanTableSource` to audit a
    searched/loaded plan instead."""
    from repro_torch.models import registry
    if source is None:
        source = _default_source()
    out: List[Finding] = []
    first = serve_pick = None
    for arch, method, model in registry.analysis_models(
            methods=(methods[0],), archs=archs):
        first = first or (arch, model)
        # the serve surfaces (paged cache, block tables) need the slot-cache
        # families — audit them on the first arch that has one
        if serve_pick is None and bool(model.supports_slot_cache):
            serve_pick = (arch, model)
        out += audit_tree(model.init_shapes(), f"{arch}[{method}]",
                          source=source)
    if first is not None and len(methods) > 1:
        for arch, method, model in registry.analysis_models(
                methods=methods[1:], archs=(first[0],)):
            out += audit_tree(model.init_shapes(), f"{arch}[{method}]",
                              source=source)
    if first is not None:
        arch, model = serve_pick or first
        for tree, suffix, section in _serve_trees(model):
            out += audit_tree(tree, f"{arch}[{suffix}]", section=section,
                              source=source)
    return out
