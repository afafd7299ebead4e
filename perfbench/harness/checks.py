"""The numbers that decide `correct`, computed against the plain reference
(perfbench/reference) after the window has closed and the program's state
is freed.

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

from harness import inputs
from reference import decoder, steps

EXCLUDE_BELOW = 1e-3


def layout_matches(model, cfg: Dict) -> None:
    """The program's base weight tree has the shapes the benchmark makes."""
    shapes = model.init_shapes()["base"]
    want = inputs.base_layout(cfg)
    got = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            got.update({f"{k}/{kk}": tuple(vv.shape) for kk, vv in v.items()})
        else:
            got[k] = tuple(v.shape)
    if got != {k: tuple(s) for k, (s, _) in want.items()}:
        raise ValueError(f"the program's weight layout {got} is not the "
                         f"benchmark's {want}")


def reference_setup(cfg: Dict, device):
    decoder.precise()
    dims = decoder.Dims(cfg)
    return dims, decoder.entries_for(dims, device)


def _by_target(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{"layers/wq": x} -> {"wq": x}."""
    return {k.split("/")[-1]: v for k, v in tree.items()}


def optimizer(tcfg) -> Dict:
    return {"b1": tcfg.b1, "b2": tcfg.b2, "eps": tcfg.eps,
            "lr": tcfg.learning_rate, "clip": tcfg.grad_clip,
            "weight_decay": tcfg.weight_decay}


def train_reference(cfg: Dict, base: Dict, c0: Dict, batches: Sequence,
                    tcfg, linear: str = "float32") -> Dict:
    """The reference's first steps from c0 on `batches` (its matrix
    products in `linear`'s arithmetic): {"losses", "grad1", "moved"},
    keyed by site name as the program's trees are."""
    dims, entries = reference_setup(cfg, c0[next(iter(c0))].device)
    ref = steps.train_steps(base, _by_target(c0), entries,
                            [(b["tokens"], b["labels"]) for b in batches],
                            dims, optimizer(tcfg), decoder.LINEARS[linear])
    full = {k.split("/")[-1]: k for k in c0}
    return {"losses": ref["losses"],
            "grad1": {full[k]: v for k, v in ref["grad1"].items()},
            "moved": {full[k]: ref["params"][k] - c0[full[k]].float()
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


def serve_numbers(cfg: Dict, base: Dict, sample: Sequence[Dict],
                  coeffs: Dict, linear: str = "float32") -> Dict[str, float]:
    """sample: [{"prompt": np int array, "served": [tokens], "tenant": int
    or None}]; coeffs: {site: (tenants, L, n)}."""
    dev = next(iter(coeffs.values())).device
    dims, entries = reference_setup(cfg, dev)
    reqs = []
    for r in sample:
        c = None if r["tenant"] is None else {
            k.split("/")[-1]: v[r["tenant"]] for k, v in coeffs.items()}
        reqs.append({"prompt": torch.as_tensor(r["prompt"], device=dev)
                     .to(torch.int64),
                     "served": torch.as_tensor(r["served"], device=dev)
                     .to(torch.int64), "c": c})
    if linear == "float32":
        gaps = steps.served_gaps(base, reqs, entries, dims)
    else:
        gaps = steps.control_gaps(base, reqs, entries, dims,
                                  decoder.LINEARS[linear])
    return {"max_logit_gap": max(gaps)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(k in numbers and numbers[k] <= limits[k] for k in limits) \
        and all(v == v for v in numbers.values())
