"""Serving engine: merged-adapter deployment (the paper's zero-inference-
latency property) and lockstep greedy decoding over slotted requests — the
JAX package's `serve/engine.py` without the adapter bank, mesh and sharding
plan (later slices).

`merge_for_serving` folds every mergeable ΔW into the base weights once,
through the kernel registry: on the card the hand-written ΔW kernel does
the folding. After that the served model has method `none` and its graph is
the unadapted model's.

`Engine.generate` is the serial reference the continuous scheduler
(serve/scheduler/runtime.py) is held against.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.adapter import torch_dtype
from repro_torch.devices import resolve_device, tree_to
from repro_torch.models.registry import Model, add_time_dim, build


@torch.no_grad()
def merge_for_serving(model: Model, params: Dict) -> Tuple[Model, Dict]:
    """Fold every mergeable layer-stack ΔW into the base. Leftover adapters
    (non-`layers/` sites, or methods with `mergeable=False`) stay under
    their true method — the rebuilt model keeps the original PEFTConfig
    whenever anything is left over. Runs without autograd: merged weights
    built from trained coefficients (which require grad) hold no graph."""
    peft = model.peft
    method = model.method
    if not method.has_site_params or not params.get("peft"):
        return model, params
    base = dict(params["base"])
    layers = dict(base["layers"])
    leftover = {}
    site_by_name = {s.name: s for s in model.sites}
    for name, ad in params["peft"].items():
        if not name.startswith("layers/") or not method.mergeable:
            leftover[name] = ad
            continue
        method.merge_site(layers, name.split("/")[-1], ad, site_by_name[name],
                          peft)
    base["layers"] = layers
    merged_model = build(model.cfg,
                         peft if leftover else peft.replace(method="none"))
    return merged_model, {"base": base, "peft": leftover}


@dataclass
class Request:
    prompt: torch.Tensor               # (S,) int
    max_new: int = 16
    adapter_id: Optional[str] = None   # adapter-bank tenant (later slice)
    out: Optional[List[int]] = None
    priority: str = "batch"            # interactive | batch | best_effort


class Engine:
    """Slot-based batched greedy decoding over one model and its params.

    device: where the engine runs — `cuda` unless the caller passes one
    (`device="cpu"` runs the plain PyTorch versions); with no argument and
    no CUDA device the constructor raises. Params are moved there."""

    def __init__(self, model: Model, params: Dict, batch_slots: int,
                 max_len: int, merge: bool = True, bank=None, device=None):
        if bank is not None:
            raise NotImplementedError(
                "the adapter bank comes with a later slice (ROADMAP queue 1)")
        self.device = resolve_device(device)
        params = tree_to(params, self.device)
        # the kernel each targeted (site, op) resolves to on this device —
        # a site the CUDA kernel cannot take raises here, before any work
        self.kernel_policy = model.kernel_policy(self.device).validate()
        if merge:
            model, params = merge_for_serving(model, params)
        self.model, self.params = model, params
        self.bank = None
        self.batch = batch_slots
        self.max_len = max_len

    def commit_tokens(self, arr) -> torch.Tensor:
        """A host-built token array as an int32 tensor on the engine's
        device."""
        return torch.as_tensor(arr, dtype=torch.int32, device=self.device)

    def _fresh_cache(self, per_slot: bool = False, paged: bool = False,
                     page_size: int = 16, n_pages: Optional[int] = None):
        return self.model.init_cache(
            self.batch, self.max_len, torch_dtype(self.model.cfg.dtype),
            self.device, per_slot=per_slot, paged=paged,
            page_size=page_size, n_pages=n_pages)

    @torch.no_grad()
    def generate(self, prompts: Sequence, max_new: int = 16,
                 adapter_ids: Optional[Sequence[Optional[str]]] = None
                 ) -> List[torch.Tensor]:
        """Greedy-decode a batch of prompts (padded to the longest; the
        padded prefill keeps every slot's KV cache consistent). Returns one
        (max_new,) int32 tensor per prompt."""
        if not prompts:
            raise ValueError("generate() needs at least one prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if any(int(p.shape[0]) < 1 for p in prompts):
            raise ValueError("generate() got an empty (length-0) prompt")
        if len(prompts) > self.batch:
            raise ValueError(f"{len(prompts)} prompts for {self.batch} slots")
        if adapter_ids is not None and any(a is not None for a in adapter_ids):
            raise ValueError("adapter_ids given but the engine has no bank")
        plen = max(int(p.shape[0]) for p in prompts)
        # the last generated token is never written: the deepest cache read
        # is plen + max_new - 1 (the scheduler's slots.py invariant)
        if plen + max_new - 1 > self.max_len:
            raise ValueError(
                f"prompt ({plen}) + max_new ({max_new}) needs "
                f"{plen + max_new - 1} cache positions, exceeding "
                f"max_len ({self.max_len})")
        toks = torch.zeros((self.batch, plen), dtype=torch.int32,
                           device=self.device)
        for i, p in enumerate(prompts):
            toks[i, :p.shape[0]] = torch.as_tensor(p, device=self.device)
        cache = self._fresh_cache()
        last, cache = self.model.prefill(self.params, cache, {"tokens": toks})
        outs = [last]
        cur = add_time_dim(last)
        for _ in range(max_new - 1):
            nxt, cache = self.model.decode_step(self.params, cache,
                                                {"tokens": cur})
            outs.append(nxt)
            cur = add_time_dim(nxt)
        gen = torch.stack(outs, dim=1)                    # (B, max_new)
        return [gen[i] for i in range(len(prompts))]
