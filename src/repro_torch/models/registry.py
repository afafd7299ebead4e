"""Model registry: `build(cfg, peft)` returns a `Model` facade over the
dense transformer (the JAX package's `models/registry.py`, dense family).

    model.init(seed, device)                -> {"base": ..., "peft": ...}
    model.forward(params, batch)            -> logits
    model.loss(params, batch)               -> scalar (mean token CE, f32)
    model.join(trainable, frozen)           -> params (the train step's split undone)
    model.loss_from_parts(trainable, frozen_base, frozen_adapters, batch)
    model.prefill(params, cache, batch)     -> (next_tokens, cache)
    model.decode_step(params, cache, batch) -> (next_tokens, cache)
    model.init_cache(batch, max_len, ...)   -> cache tree
    model.sites                             -> adapter sites (PEFT targets)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, PEFTConfig
from repro_torch.core import adapter as adapter_api
from repro_torch.core import peft as peft_mod
from repro_torch.core.adapter import AdapterSite
from repro_torch.kernels import api as kernel_api
from repro_torch.models import transformer


def add_time_dim(t: torch.Tensor) -> torch.Tensor:
    """Re-add the time dim to per-step tokens: (B,) -> (B, 1)."""
    return t[:, None]


def adapter_sites(cfg: ModelConfig) -> Tuple[AdapterSite, ...]:
    return (
        AdapterSite("layers/wq", cfg.d_model, cfg.attn_dim, cfg.num_layers),
        AdapterSite("layers/wk", cfg.d_model, cfg.kv_dim, cfg.num_layers),
        AdapterSite("layers/wv", cfg.d_model, cfg.kv_dim, cfg.num_layers),
        AdapterSite("layers/wo", cfg.attn_dim, cfg.d_model, cfg.num_layers),
        AdapterSite("layers/wi", cfg.d_model, cfg.d_ff or cfg.d_model,
                    cfg.num_layers),
    )


@dataclass
class Model:
    cfg: ModelConfig
    peft: PEFTConfig
    remat: str = "none"           # none | dots | full (training forward)

    def __post_init__(self):
        if self.remat not in transformer.REMAT_MODES:
            raise ValueError(f"unknown remat {self.remat!r}; one of "
                             f"{transformer.REMAT_MODES}")
        if self.cfg.family != "dense":
            raise NotImplementedError(
                f"family {self.cfg.family!r} ({self.cfg.name}) is not ported "
                "yet (ROADMAP queue 1: the other architecture families)")
        # unknown methods and kernel backends fail here, at build
        self.method = adapter_api.resolve(self.peft.method)
        kernel_api.requested_backend(self.peft)
        self.sites = adapter_sites(self.cfg)

    def _call(self, fn, params: Dict, *args):
        return fn(params["base"], params["peft"], *args, self.cfg, self.peft,
                  self.sites)

    # ---- params -----------------------------------------------------------
    def init(self, seed: int, device) -> Dict:
        """Random base weights and adapters from one `torch.Generator`
        seeded with `seed`, made directly on `device`."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        base = transformer.init_params(gen, self.cfg, device)
        adapters = peft_mod.init_adapters(gen, self.sites, self.peft, device)
        return {"base": base, "peft": adapters}

    # ---- forward / decode ---------------------------------------------------
    def forward(self, params: Dict, batch: Dict) -> torch.Tensor:
        return transformer.forward(params["base"], params["peft"], batch,
                                   self.cfg, self.peft, self.sites,
                                   remat=self.remat)

    def loss(self, params: Dict, batch: Dict) -> torch.Tensor:
        return transformer.loss_fn(params["base"], params["peft"], batch,
                                   self.cfg, self.peft, self.sites,
                                   remat=self.remat)

    def join(self, trainable: Dict, frozen: Dict) -> Dict:
        """The params tree from the train step's (trainable, frozen) split:
        trainable adapter leaves join the frozen ones per site, and a
        trained head replaces `lm_head`."""
        base = frozen["base"]
        if "head" in trainable:
            base = dict(base)
            base["lm_head"] = trainable["head"]
        peft = trainable.get("peft", {})
        adapters = {site: {**frozen["peft"].get(site, {}),
                           **peft.get(site, {})}
                    for site in {**frozen["peft"], **peft}}
        return {"base": base, "peft": adapters}

    def loss_from_parts(self, trainable: Dict, frozen_base: Dict,
                        frozen_adapters: Dict, batch: Dict) -> torch.Tensor:
        """The split-tree loss the train step differentiates (gradients
        w.r.t. `trainable` only)."""
        return self.loss(self.join(trainable, {"base": frozen_base,
                                               "peft": frozen_adapters}),
                         batch)

    def prefill(self, params: Dict, cache: Dict, batch: Dict):
        return self._call(transformer.prefill, params, cache, batch)

    def prefill_paged(self, params: Dict, cache: Dict, batch: Dict):
        return self._call(transformer.prefill_paged, params, cache, batch)

    def decode_step(self, params: Dict, cache: Dict, batch: Dict):
        return self._call(transformer.decode_step, params, cache, batch)

    def decode_logits(self, params: Dict, cache: Dict, batch: Dict):
        return self._call(transformer.decode_logits, params, cache, batch)

    def init_cache(self, batch: int, max_len: int, dtype, device,
                   per_slot: bool = False, paged: bool = False,
                   page_size: int = 16, n_pages: Optional[int] = None) -> Dict:
        if paged:
            if n_pages is None:
                raise ValueError("paged cache needs n_pages (the runtime "
                                 "takes it from serve.paging.PagedKVCache)")
            return transformer.init_paged_cache(self.cfg, batch, n_pages,
                                                page_size, dtype, device)
        return transformer.init_cache(self.cfg, batch, max_len, dtype,
                                      device, per_slot=per_slot)

    def reset_slots(self, cache: Dict, mask) -> Dict:
        return transformer.reset_slots(cache, mask)

    def copy_page(self, cache: Dict, src: int, dst: int) -> Dict:
        return transformer.copy_page(cache, src, dst)

    # ---- kernels / accounting ---------------------------------------------
    def kernel_policy(self, device) -> kernel_api.KernelPolicy:
        """Which backend each targeted (site, op) resolves to on `device`."""
        return kernel_api.KernelPolicy.build(self.method, self.sites,
                                             self.peft, device)

    def trainable_params(self) -> int:
        return peft_mod.count_trainable(self.sites, self.peft)


def build(cfg: ModelConfig, peft: Optional[PEFTConfig] = None,
          remat: str = "none") -> Model:
    return Model(cfg, peft or PEFTConfig(), remat=remat)
