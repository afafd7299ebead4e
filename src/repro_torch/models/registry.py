"""Model registry: `build(cfg, peft)` returns a `Model` facade over the
transformer's families — dense, moe, audio (codebooks) and vlm (embedding
inputs, M-RoPE) — as the JAX package's `models/registry.py` does. The
pure-SSM and hybrid families are not ported yet: building one raises
NotImplementedError.

    model.init(seed, device)                -> {"base": ..., "peft": ...}
    model.forward(params, batch)            -> logits
    model.loss(params, batch)               -> scalar (mean token CE, f32)
    model.join(trainable, frozen)           -> params (the train step's split undone)
    model.loss_from_parts(trainable, frozen_base, frozen_adapters, batch)
    model.prefill(params, cache, batch)     -> (next_tokens, cache)
    model.decode_step(params, cache, batch) -> (next_tokens, cache)
    model.verify_step(params, cache, batch) -> (window tokens, cache)
    model.init_cache(batch, max_len, ...)   -> cache tree
    model.write_slot / reset_slots / advance_pos -> per-slot cache updates

With `bank_profiles` set (the serving Engine sets it on its own copy),
forward / prefill / prefill_paged / decode read the adapter bank's rows
from params["bank"] and the per-request rows from batch["adapter_slots"].
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
from repro_torch.tree import tree_leaves


def add_time_dim(t: torch.Tensor) -> torch.Tensor:
    """Re-add the time dim to per-step tokens: (B,) -> (B, 1); codebook
    tokens (B, CB) -> (B, 1, CB)."""
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
    # serving adapter bank: {method name: PEFTConfig profile}; the resident
    # rows travel as params["bank"] (serve/engine.py AdapterBank) and the
    # per-request gather rows as batch["adapter_slots"]
    bank_profiles: Optional[Dict[str, PEFTConfig]] = None

    def __post_init__(self):
        if self.remat not in transformer.REMAT_MODES:
            raise ValueError(f"unknown remat {self.remat!r}; one of "
                             f"{transformer.REMAT_MODES}")
        if self.cfg.family not in transformer.FAMILIES:
            raise NotImplementedError(
                f"family {self.cfg.family!r} ({self.cfg.name}) is not ported "
                "yet (ROADMAP queue 1: the SSM/hybrid slice)")
        # unknown methods and kernel backends fail here, at build
        self.method = adapter_api.resolve(self.peft.method)
        kernel_api.requested_backend(self.peft)
        self.sites = adapter_sites(self.cfg)
        self._paged_fns = {}      # (device type, dtype) -> attention fn

    def _bank_kwargs(self, params: Dict) -> Dict:
        if self.bank_profiles is None:
            return {}
        return {"bank": params.get("bank"),
                "bank_profiles": self.bank_profiles}

    def _call(self, fn, params: Dict, *args):
        return fn(params["base"], params["peft"], *args, self.cfg, self.peft,
                  self.sites, **self._bank_kwargs(params))

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
        """The logits (`transformer.forward` also returns the MoE aux
        loss, which only the training loss reads)."""
        return transformer.forward(params["base"], params["peft"], batch,
                                   self.cfg, self.peft, self.sites,
                                   remat=self.remat,
                                   **self._bank_kwargs(params))[0]

    def loss(self, params: Dict, batch: Dict) -> torch.Tensor:
        return transformer.loss_fn(params["base"], params["peft"], batch,
                                   self.cfg, self.peft, self.sites,
                                   remat=self.remat)

    def join(self, trainable: Dict, frozen: Dict) -> Dict:
        """The params tree from the train step's (trainable, frozen) split:
        trainable adapter leaves join the frozen ones per site, and a
        trained head replaces `lm_head` (`full`: the trainables are the
        whole base)."""
        if self.method.trains_base:
            return {"base": trainable["base"], "peft": {}}
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
        return self._call_attending(transformer.decode_step, params,
                                    cache, batch)

    def decode_logits(self, params: Dict, cache: Dict, batch: Dict):
        return self._call_attending(transformer.decode_logits, params,
                                    cache, batch)

    def verify_step(self, params: Dict, cache: Dict, batch: Dict):
        """Draft verification: one forward over batch["tokens"] (B, W), the
        last accepted token and W-1 drafts per slot, writing all W K/V
        rows; returns the greedy continuation after each (B, W). `pos` does
        not advance (`advance_pos` commits the accepted counts). A paged
        cache reads through the same resolved attention as decode."""
        return self._call_attending(transformer.verify_step, params,
                                    cache, batch)

    def verify_logits(self, params: Dict, cache: Dict, batch: Dict):
        return self._call_attending(transformer.verify_logits, params,
                                    cache, batch)

    def _call_attending(self, fn, params: Dict, cache: Dict, batch: Dict):
        """`fn` (a decode or verify function of `transformer`) with the
        attention resolved for `cache` (None for a dense cache)."""
        return fn(params["base"], params["peft"], cache, batch, self.cfg,
                  self.peft, self.sites, paged_attention=self._paged_fn(cache),
                  **self._bank_kwargs(params))

    def paged_attention(self, device, dtype):
        """The decode attention over a paged cache of `dtype` on `device`:
        the registry's op for this model's kv heads and head_dim, resolved
        once per (device type, dtype). A kernel that cannot take them
        raises KernelUnavailableError here."""
        key = (torch.device(device).type, dtype)
        fn = self._paged_fns.get(key)
        if fn is None:
            fn = self._paged_fns[key] = transformer.paged_attention_op(
                self.cfg, self.peft, device, dtype).fn
        return fn

    def _paged_fn(self, cache: Dict):
        if "pk" not in cache:
            return None
        return self.paged_attention(cache["pk"].device, cache["pk"].dtype)

    @property
    def supports_slot_cache(self) -> bool:
        """True when the family has the per-slot cache (ragged per-slot
        kv_len over one cache, dense or paged, with the write_slot /
        reset_slots / advance_pos lifecycle): the token-input families
        without codebooks, as in the JAX package. Codebook streams decode
        lockstep only; vlm feeds embeddings, which no slot path carries."""
        return self.cfg.embed_inputs and not self.cfg.n_codebooks

    def init_cache(self, batch: int, max_len: int, dtype, device,
                   per_slot: bool = False, paged: bool = False,
                   page_size: int = 16, n_pages: Optional[int] = None) -> Dict:
        """Dense lockstep, dense per-slot or paged; a family without the
        per-slot path (`supports_slot_cache`) has only the lockstep cache,
        so every per-slot and paged call starts from a refusal here."""
        if (paged or per_slot) and not self.supports_slot_cache:
            raise NotImplementedError(
                f"family {self.cfg.family!r} ({self.cfg.name}) has no "
                "per-slot cache path: continuous batching covers the "
                "token-input transformer families without codebooks")
        if paged:
            if n_pages is None:
                raise ValueError("paged cache needs n_pages (the runtime "
                                 "takes it from serve.paging.PagedKVCache)")
            return transformer.init_paged_cache(self.cfg, batch, n_pages,
                                                page_size, dtype, device)
        return transformer.init_cache(self.cfg, batch, max_len, dtype,
                                      device, per_slot=per_slot)

    def write_slot(self, cache: Dict, slot_cache: Dict, slot: int,
                   length) -> Dict:
        """In-flight prefill on the dense per-slot cache: splice a primed
        batch-1 cache into slot row `slot` (position <- `length`)."""
        return transformer.write_slot_cache(cache, slot_cache, slot, length)

    def reset_slots(self, cache: Dict, mask) -> Dict:
        return transformer.reset_slots(cache, mask)

    def advance_pos(self, cache: Dict, delta) -> Dict:
        """Per-slot position commit after verification ((B,) accepted
        counts, or a scalar for the self-drafter's rollback)."""
        return transformer.advance_pos(cache, delta)

    def copy_page(self, cache: Dict, src: int, dst: int) -> Dict:
        return transformer.copy_page(cache, src, dst)

    # ---- kernels / accounting ---------------------------------------------
    def kernel_policy(self, device) -> kernel_api.KernelPolicy:
        """Which backend each targeted (site, op), and each bank group's
        `bank_apply`, resolves to on `device`."""
        return kernel_api.KernelPolicy.build(self.method, self.sites,
                                             self.peft, device,
                                             self.bank_profiles)

    def trainable_params(self) -> int:
        """|Θ|: the adapters' count, or for `full` the base's, from its
        leaves' shapes (made on the meta device: no memory, no draw)."""
        if self.method.trains_base:
            base = transformer.init_params(torch.Generator(), self.cfg,
                                           "meta")
            return sum(leaf.numel() for leaf in tree_leaves(base))
        return peft_mod.count_trainable(self.sites, self.peft)


def build(cfg: ModelConfig, peft: Optional[PEFTConfig] = None,
          remat: str = "none") -> Model:
    return Model(cfg, peft or PEFTConfig(), remat=remat)
