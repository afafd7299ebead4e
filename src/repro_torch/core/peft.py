"""PEFT attachment layer: adapter initialization, the trainable subtree,
parameter accounting (paper Table 1) and the frozen tables of the factored
form, for every registered method (fourierft, dct, circulant, lora,
bitfit; `none` and `full` own no adapter state). Adapter params live in a
tree parallel to the base params: params = {"base": ..., "peft":
{site.name: {...}}}."""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from repro_torch.configs.base import ModelConfig, PEFTConfig
from repro_torch.core import adapter as adapter_api
from repro_torch.core.adapter import AdapterSite, entry_seed_for  # noqa: F401 (re-export)


def init_site(gen: torch.Generator, site: AdapterSite, peft: PEFTConfig,
              device) -> Dict:
    return adapter_api.resolve(peft.method).init_site(gen, site, peft, device)


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


def site_delta(adapter: Dict, site: AdapterSite, peft: PEFTConfig,
               out_dtype=None) -> torch.Tensor:
    """Materialize the stacked ΔW (stack, d_in, d_out) for one site."""
    return adapter_api.resolve(peft.method).site_delta(adapter, site, peft,
                                                       out_dtype)


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
    stored, not trained; the paper counts n·L_t for FourierFT, 2·d·L_t·r
    for LoRA)."""
    method = adapter_api.resolve(peft.method)
    return sum(method.count_trainable(s, peft) for s in _targeted(sites, peft))


def storage_bytes(sites: Sequence[AdapterSite], peft: PEFTConfig,
                  bytes_per_param: int = 4) -> int:
    """Checkpoint bytes: trainables plus whatever frozen numbers the method
    must carry (FourierFT: the 2n integer entries once per shape group —
    paper: n·(2+L) numbers total)."""
    method = adapter_api.resolve(peft.method)
    extra = method.shared_storage_numbers(_targeted(sites, peft), peft)
    return (count_trainable(sites, peft) + extra) * bytes_per_param


def qv_sites_for(cfg: ModelConfig) -> List[AdapterSite]:
    """The paper's default adaptation set: per-block query and value
    projections (L_t = 2·num_layers square-ish matrices)."""
    return [
        AdapterSite("layers/wq", cfg.d_model, cfg.attn_dim, cfg.num_layers),
        AdapterSite("layers/wv", cfg.d_model, cfg.kv_dim, cfg.num_layers),
    ]


def with_frozen_tables(adapters: Dict, sites: Sequence[AdapterSite],
                       peft: PEFTConfig) -> Dict:
    """`adapters` with each site's frozen tables (the method's
    `frozen_tables`: FourierFT's cos/sin bases, dct's cosine bases) built
    once and kept beside its aux leaves, where the factored apply finds
    them instead of rebuilding them every call."""
    method = adapter_api.resolve(peft.method)
    by_name = {s.name: s for s in sites}
    return {name: {**ad, **method.frozen_tables(
                ad, by_name[name].d_in, by_name[name].d_out)}
            for name, ad in adapters.items()}
