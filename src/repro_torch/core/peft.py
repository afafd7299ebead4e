"""PEFT attachment layer: adapter initialization, the trainable subtree and
parameter accounting (paper Table 1). Adapter params live in a tree parallel to the base params:
params = {"base": ..., "peft": {site.name: {...}}}."""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from repro_torch.configs.base import PEFTConfig
from repro_torch.core import adapter as adapter_api
from repro_torch.core.adapter import AdapterSite, entry_seed_for  # noqa: F401 (re-export)


def init_adapters(gen: torch.Generator, sites: Sequence[AdapterSite],
                  peft: PEFTConfig, device) -> Dict:
    """Adapter state for every targeted site, drawn from `gen` in site
    order (the JAX package folds a key per site; the draws differ, so
    parity tests carry JAX-made params over with `repro_torch.convert`)."""
    method = adapter_api.resolve(peft.method)
    if not method.has_site_params:
        return {}
    return {site.name: method.init_site(gen, site, peft, device)
            for site in sites
            if site.name.split("/")[-1] in peft.target_modules}


def trainable_adapter_tree(adapters: Dict, peft: PEFTConfig) -> Dict:
    """{site: {leaf: tensor}} restricted to the method's trainable leaves
    (FourierFT: `c`; the entries stay frozen)."""
    trainable = set(adapter_api.resolve(peft.method).trainable_leaves(peft))
    return {site: {k: v for k, v in d.items() if k in trainable}
            for site, d in adapters.items()}


def _targeted(sites: Sequence[AdapterSite],
              peft: PEFTConfig) -> List[AdapterSite]:
    return [s for s in sites
            if s.name.split("/")[-1] in peft.target_modules]


def count_trainable(sites: Sequence[AdapterSite], peft: PEFTConfig) -> int:
    """|Θ| per paper §3.2 — coefficient parameters only (entries are
    stored, not trained; the paper counts n·L_t for FourierFT)."""
    method = adapter_api.resolve(peft.method)
    return sum(method.count_trainable(s, peft) for s in _targeted(sites, peft))

