"""The numbers that decide `correct`, computed against the plain reference
of the cell's family (perfbench/reference/<reference>.py, the module the
configuration's `reference` key names) after the window has closed and the
program's state is freed. Trees are keyed by site path, as the program's
are.

Training (`train_reference`, `train_gaps`), over the checked first steps:
  loss_gap    the largest |loss - reference loss| / |reference loss| of a
              step;
  grad_gap    the first step's gradient as the optimizer got it (its first
              moment after one step over 1 - b1), by the worst slice (one
              site's coefficients of one layer): | |g| - |g_ref| | over the
              larger of |g_ref| and the median slice's |g_ref|;
  grad_gap_median  the same gap of the median slice: steady from seed to
              seed where a few slices swing;
  change_gap  as grad_gap, for the coefficients' change over the checked
              steps.
Which of them a cell compares, and their limits, are in
perfbench/limits/<cell>.json; the others are logged.
Slices whose reference gradient is under a thousandth of the median
slice's are left out of both gaps (none are, at the benchmark's sizes).

Serving (`serve_numbers`): max_logit_gap, the widest gap over the sampled
requests' served tokens by which a served token's reference logit lies
below the reference's best at its position.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from reference import steps

EXCLUDE_BELOW = 1e-3


def leaf_shapes(tree: Dict, prefix: str = "") -> Dict[str, tuple]:
    """{leaf path: shape} of a nested tree of any depth."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaf_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def layout_matches(model, want: Dict) -> None:
    """The program's base weight tree has the shapes of the benchmark's
    layout `want` ({leaf path: (shape, kind)})."""
    got = leaf_shapes(model.init_shapes()["base"])
    if got != {k: tuple(s) for k, (s, _) in want.items()}:
        raise ValueError(f"the program's weight layout {got} is not the "
                         f"benchmark's {want}")


def reference_setup(model, cfg: Dict, device):
    """(Dims, entries on `device`) of the family's plain model `model`."""
    model.precise()
    dims = model.Dims(cfg)
    return dims, model.entries_for(dims, device)


def optimizer(tcfg) -> Dict:
    return {"b1": tcfg.b1, "b2": tcfg.b2, "eps": tcfg.eps,
            "lr": tcfg.learning_rate, "clip": tcfg.grad_clip,
            "weight_decay": tcfg.weight_decay}


def train_reference(model, cfg: Dict, base: Dict, c0: Dict,
                    batches: Sequence, tcfg, linear: str = "float32") -> Dict:
    """The first steps of the family's plain model `model` from c0 on
    `batches` (its matrix products in `linear`'s arithmetic): {"losses",
    "grad1", "moved"}, keyed by site path as the program's trees are."""
    dims, entries = reference_setup(model, cfg, c0[next(iter(c0))].device)
    ref = steps.train_steps(model, base, c0, entries,
                            [(b["tokens"], b["labels"]) for b in batches],
                            dims, optimizer(tcfg), model.LINEARS[linear])
    return {"losses": ref["losses"], "grad1": ref["grad1"],
            "moved": {k: ref["params"][k] - c0[k].float()
                      for k in ref["params"]}}


def train_gaps(ref: Dict, losses: List[float], grad1: Dict,
               moved: Dict) -> Dict[str, float]:
    """The compared numbers of a run's readings against the reference's."""
    gnorm = {k: g.norm(dim=-1) for k, g in ref["grad1"].items()}
    med = torch.cat(list(gnorm.values())).median()
    exclude = {k: n < EXCLUDE_BELOW * med for k, n in gnorm.items()}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                         ref["losses"]))
    return {"loss_gap": loss_gap,
            "grad_gap": steps.slice_gap(grad1, ref["grad1"], exclude),
            "grad_gap_median": steps.slice_gap(grad1, ref["grad1"], exclude,
                                               median=True),
            "change_gap": steps.slice_gap(moved, ref["moved"], exclude)}


def train_diagnostics(ref: Dict, losses: List[float], grad1: Dict,
                      moved: Dict) -> Dict[str, float]:
    """Other views of the same readings (calibration only): the gaps by
    whole site instead of by layer slice, the median slice's change and
    the first step's loss gap."""
    def by_site(prog, refs):
        return max(abs(float(prog[k].norm() - refs[k].norm()))
                   / float(refs[k].norm()) for k in refs)
    return {"loss_gap_1": abs(losses[0] - ref["losses"][0])
            / abs(ref["losses"][0]),
            "grad_gap_site": by_site(grad1, ref["grad1"]),
            "change_gap_site": by_site(moved, ref["moved"]),
            "change_gap_median": steps.slice_gap(moved, ref["moved"],
                                                 median=True)}


def serve_numbers(model, cfg: Dict, base: Dict, sample: Sequence[Dict],
                  coeffs: Dict, linear: str = "float32") -> Dict[str, float]:
    """The family's plain model `model` against the served tokens. sample:
    [{"prompt": np int array, "served": [tokens], "tenant": int or None}];
    coeffs: {site: (tenants, L, n)}."""
    dev = next(iter(coeffs.values())).device
    dims, entries = reference_setup(model, cfg, dev)
    reqs = []
    for r in sample:
        c = None if r["tenant"] is None else {
            k: v[r["tenant"]] for k, v in coeffs.items()}
        reqs.append({"prompt": torch.as_tensor(r["prompt"], device=dev)
                     .to(torch.int64),
                     "served": torch.as_tensor(r["served"], device=dev)
                     .to(torch.int64), "c": c})
    if linear == "float32":
        gaps = steps.served_gaps(model, base, reqs, entries, dims)
    else:
        gaps = steps.control_gaps(model, base, reqs, entries, dims,
                                  model.LINEARS[linear])
    return {"max_logit_gap": max(gaps)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(k in numbers and numbers[k] <= limits[k] for k in limits) \
        and all(v == v for v in numbers.values())
