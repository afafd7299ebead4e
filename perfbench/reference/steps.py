"""The reference's training steps and served-token gaps.

Each function takes the plain model of the cell's family (`model`:
perfbench/reference/<reference>.py, the module the configuration's
`reference` key names).

Training: `train_steps` follows the first steps of a run from the same
coefficients and batches: loss and gradient (`model.loss_and_grads`),
the gradient clipped to a global norm, then AdamW (Loshchilov & Hutter,
with the bias corrections of Kingma & Ba; decoupled weight decay) at the
configuration's constant rate.

Serving: `served_gaps` scores each sampled request's served tokens under
the reference's logits: by how much a served token's logit lies below the
reference's best at its position. `control_gaps` reads, at the same
positions, the gap of the token a lower-precision run puts first.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch


def train_steps(model, base: Dict, c0: Dict[str, torch.Tensor],
                entries: Dict, batches: Sequence, dims, opt: Dict,
                lin: Optional[Callable] = None) -> Dict:
    """Run len(batches) steps from c0 (matrix products by `lin`, the
    model's plain ones by default). Returns {"losses": [...], "grad1":
    {site: the first step's gradient as the optimizer gets it (clipped)},
    "params": {site: the coefficients after the last step}}."""
    lin = model.plain_linear if lin is None else lin
    c = {k: v.detach().to(torch.float32).clone() for k, v in c0.items()}
    m = {k: torch.zeros_like(v) for k, v in c.items()}
    v2 = {k: torch.zeros_like(v) for k, v in c.items()}
    b1, b2, eps, lr = opt["b1"], opt["b2"], opt["eps"], opt["lr"]
    losses: List[float] = []
    grad1 = None
    for t, (tokens, labels) in enumerate(batches, start=1):
        loss, g = model.loss_and_grads(base, c, entries, tokens, labels,
                                       dims, lin)
        losses.append(loss)
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
        scale = torch.clamp(opt["clip"] / torch.clamp(norm, min=1e-9),
                            max=1.0)
        g = {k: x * scale for k, x in g.items()}
        if grad1 is None:
            grad1 = {k: x.clone() for k, x in g.items()}
        for k in c:
            m[k] = b1 * m[k] + (1 - b1) * g[k]
            v2[k] = b2 * v2[k] + (1 - b2) * g[k] * g[k]
            mh = m[k] / (1 - b1 ** t)
            vh = v2[k] / (1 - b2 ** t)
            c[k] = c[k] - lr * (mh / (torch.sqrt(vh) + eps)
                                + opt["weight_decay"] * c[k])
    return {"losses": losses, "grad1": grad1, "params": c}


def served_gaps(model, base: Dict, requests: Sequence[Dict],
                entries: Dict, dims) -> List[float]:
    """For each request {"prompt": (P,) int64, "served": (T,) int64, "c":
    {site: (L, n)} or None}: the largest gap, over its served tokens, by
    which the served token's reference logit lies below the reference's
    best at that position."""
    out = []
    for r in requests:
        seq = torch.cat([r["prompt"], r["served"][:-1]])
        lg = model.logits_at(base, r["c"], entries, seq,
                             r["prompt"].shape[0] - 1, dims)
        picked = lg.gather(1, r["served"][:, None])[:, 0]
        out.append(float((lg.max(dim=1).values - picked).max()))
    return out


def control_gaps(model, base: Dict, requests: Sequence[Dict],
                 entries: Dict, dims, lin: Callable) -> List[float]:
    """As `served_gaps`, for the tokens that the forward under `lin` puts
    first at each of the same positions (no decoding of its own)."""
    out = []
    for r in requests:
        seq = torch.cat([r["prompt"], r["served"][:-1]])
        first = r["prompt"].shape[0] - 1
        ref = model.logits_at(base, r["c"], entries, seq, first, dims)
        low = model.logits_at(base, r["c"], entries, seq, first, dims, lin)
        picked = ref.gather(1, low.argmax(dim=1)[:, None])[:, 0]
        out.append(float((ref.max(dim=1).values - picked).max()))
    return out


def slice_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              exclude: Optional[Dict[str, torch.Tensor]] = None,
              median: bool = False) -> float:
    """The worst gap of norms over every layer's slice (site, layer) of two
    {site: (L, n)} trees: | |prog| - |ref| | over the larger of the slice's
    reference norm and the median slice's. With `median`, the median over
    the slices of | |prog| - |ref| | / |ref|. `exclude` {site: (L,) bool}
    leaves slices out."""
    pn, rn, keep = [], [], []
    for k in sorted(ref):
        pn.append(prog[k].to(torch.float32).norm(dim=-1))
        rn.append(ref[k].to(torch.float32).norm(dim=-1))
        keep.append(~exclude[k] if exclude is not None
                    else torch.ones_like(rn[-1], dtype=torch.bool))
    pn, rn, keep = torch.cat(pn), torch.cat(rn), torch.cat(keep)
    med = rn[keep].median()
    if median:
        return float(((pn - rn).abs() / rn)[keep].median())
    return float(((pn - rn).abs() / torch.maximum(rn, med))[keep].max())
