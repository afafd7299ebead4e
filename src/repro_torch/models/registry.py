"""Model registry: `build(cfg, peft)` returns a `Model` facade with one
interface across the families, as the JAX package's `models/registry.py`
does: the transformer's dense, moe, audio (codebooks) and vlm (embedding
inputs, M-RoPE) families, the pure-SSM mamba2 (`ssm_lm`) and the hybrid
zamba2 (`zamba2`). The recurrent families have no per-slot cache: they
serve lockstep, and their prefill is a loop of decode steps.

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
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, PEFTConfig, ShapeConfig
from repro_torch.core import adapter as adapter_api
from repro_torch.core import peft as peft_mod
from repro_torch.core.adapter import AdapterSite
from repro_torch.dist.dtensor import (any_dtensor, is_dtensor,
                                     local_paged_attention, ops_context,
                                     to_plain)
from repro_torch.kernels import api as kernel_api
from repro_torch.models import ssm_lm, transformer, zamba2
from repro_torch.tree import tree_leaves, tree_map


def add_time_dim(t: torch.Tensor) -> torch.Tensor:
    """Re-add the time dim to per-step tokens: (B,) -> (B, 1); codebook
    tokens (B, CB) -> (B, 1, CB)."""
    return t[:, None]


def default_targets(cfg: ModelConfig) -> Tuple[str, ...]:
    """The paper's default is attention q/v; the attention-free family
    adapts its in/out projections."""
    if cfg.family == "ssm":
        return ("wx", "wo_ssm")
    return ("wq", "wv")


def resolve_default_targets(peft: PEFTConfig, cfg: ModelConfig) -> PEFTConfig:
    """Swap the generic ("wq", "wv") default for the family's real targets:
    the one place this special case lives (Model build and the serving
    AdapterBank both normalize through it)."""
    if peft.target_modules == ("wq", "wv") and cfg.family == "ssm":
        return peft.replace(target_modules=default_targets(cfg))
    return peft


def adapter_sites(cfg: ModelConfig) -> Tuple[AdapterSite, ...]:
    """Every adaptable 2-D weight site of the family; the hybrid's shared
    q/v are stacked over its shared-block applications (their d_in 2·d in
    published Zamba2, whose block reads the embeddings too)."""
    if cfg.family in ("ssm", "hybrid"):
        d_inner = cfg.ssm.expand * cfg.d_model
        mamba = (
            AdapterSite("layers/wx", cfg.d_model, d_inner, cfg.num_layers),
            AdapterSite("layers/wo_ssm", d_inner, cfg.d_model,
                        cfg.num_layers),
        )
        if cfg.family == "ssm":
            return mamba
        apps, width = zamba2.n_apps(cfg), zamba2.shared_width(cfg)
        return (AdapterSite("shared/wq", width, cfg.attn_dim, apps),
                AdapterSite("shared/wv", width, cfg.kv_dim, apps)) + mamba
    return (
        AdapterSite("layers/wq", cfg.d_model, cfg.attn_dim, cfg.num_layers),
        AdapterSite("layers/wk", cfg.d_model, cfg.kv_dim, cfg.num_layers),
        AdapterSite("layers/wv", cfg.d_model, cfg.kv_dim, cfg.num_layers),
        AdapterSite("layers/wo", cfg.attn_dim, cfg.d_model, cfg.num_layers),
        AdapterSite("layers/wi", cfg.d_model, cfg.d_ff or cfg.d_model,
                    cfg.num_layers),
    )


# the module that builds each family (JAX's _FAMILY_MODULES)
_FAMILY_MODULES = {family: transformer for family in transformer.FAMILIES}
_FAMILY_MODULES.update(ssm=ssm_lm, hybrid=zamba2)


@dataclass
class Model:
    cfg: ModelConfig
    peft: PEFTConfig
    remat: str = "none"           # none | dots | full (training forward)
    # serving adapter bank: {method name: PEFTConfig profile}; the resident
    # rows travel as params["bank"] (serve/engine.py AdapterBank) and the
    # per-request gather rows as batch["adapter_slots"]
    bank_profiles: Optional[Dict[str, PEFTConfig]] = None
    # optional sharding-constraint hook `f(path, x) -> x` (the JAX
    # package's `Model.constrain`), installed by the launch layer (the dry
    # run's `dryrun_lib.make_constrain`): it sees `fsdp_gather/<name>`
    # weight slices, `act/hidden` at layer boundaries and `moe/dispatch` /
    # `moe/tokens`, and redistributes a DTensor to the spec it picks; a
    # plain tensor passes through
    constrain: Optional[Callable] = None

    def __post_init__(self):
        if self.remat not in transformer.REMAT_MODES:
            raise ValueError(f"unknown remat {self.remat!r}; one of "
                             f"{transformer.REMAT_MODES}")
        if self.cfg.family not in _FAMILY_MODULES:
            raise ValueError(f"unknown family {self.cfg.family!r} "
                             f"({self.cfg.name}); one of "
                             f"{sorted(_FAMILY_MODULES)}")
        self._mod = _FAMILY_MODULES[self.cfg.family]
        # unknown methods and kernel backends fail here, at build
        self.method = adapter_api.resolve(self.peft.method)
        kernel_api.requested_backend(self.peft)
        if self.method.has_site_params:
            self.peft = resolve_default_targets(self.peft, self.cfg)
        self.sites = adapter_sites(self.cfg)
        self._paged_fns = {}      # (device type, dtype) -> attention fn

    def _bank_kwargs(self, params: Dict) -> Dict:
        """The bank's rows and profiles, and the constraint hook, for a
        family call."""
        out = {} if self.constrain is None else {"constrain": self.constrain}
        if self.bank_profiles is None:
            return out
        return {**out, "bank": params.get("bank"),
                "bank_profiles": self.bank_profiles}

    def _call(self, fn, params: Dict, *args, **kwargs):
        """fn over the model's trees. With params placed on a mesh
        (DTensors) the call runs under `dist.dtensor.ops_context` and its
        first output (next tokens or logits) comes back as a plain tensor
        holding the whole value on every rank, so the host side (the
        engine, the scheduler) reads it as on one device; caches stay
        placed."""
        if not any_dtensor(params):
            return fn(params["base"], params["peft"], *args, self.cfg,
                      self.peft, self.sites, **kwargs,
                      **self._bank_kwargs(params))
        with ops_context():
            out = fn(params["base"], params["peft"], *args, self.cfg,
                     self.peft, self.sites, **kwargs,
                     **self._bank_kwargs(params))
        return (to_plain(out[0]),) + tuple(out[1:])

    def _on_cache(self, fn, cache: Dict, *args):
        """A cache update (slot write, reset, position commit, page copy)
        under `ops_context` when the cache is placed on a mesh."""
        with ops_context(cache):
            return fn(cache, *args)

    # ---- params -----------------------------------------------------------
    def init(self, seed: int, device) -> Dict:
        """Random base weights and adapters from one `torch.Generator`
        seeded with `seed`, made directly on `device`."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        base = self._mod.init_params(gen, self.cfg, device)
        adapters = peft_mod.init_adapters(gen, self.sites, self.peft, device)
        return {"base": base, "peft": adapters}

    def init_shapes(self) -> Dict:
        """The params tree on `torch.device("meta")`: every leaf's shape
        and dtype, nothing allocated and no numbers drawn. Dict keys are
        sorted at every level, the order of the JAX package's
        `init_shapes` (its pytrees sort dict keys), so a walk over either
        tree visits the leaves alike."""
        gen = torch.Generator()
        base = self._mod.init_params(gen, self.cfg, "meta")
        adapters = peft_mod.init_adapters(gen, self.sites, self.peft, "meta")
        return _sorted_tree({"base": base, "peft": adapters})

    def input_specs(self, shape: ShapeConfig) -> Dict:
        """The input batch of `shape` as meta tensors (train and prefill:
        the whole sequence; decode: one new token per row), the JAX
        package's `input_specs`."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32

        def spec(shp, dtype=i32):
            return torch.empty(shp, dtype=dtype, device="meta")

        T = S if shape.kind in ("train", "prefill") else 1
        if cfg.family == "vlm":
            batch = {"embeds": spec((B, T, cfg.d_model), torch.bfloat16),
                     "positions": spec((3, B, T))}
        elif cfg.n_codebooks:
            batch = {"tokens": spec((B, T, cfg.n_codebooks))}
        else:
            batch = {"tokens": spec((B, T))}
        if shape.kind == "train":
            lbl = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
            batch["labels"] = spec(lbl)
        return batch

    def cache_specs(self, shape: ShapeConfig) -> Dict:
        """The bf16 lockstep decode cache of `shape` as meta tensors (keys
        sorted; an int position becomes an int32 scalar, as in the JAX
        package's cache)."""
        cache = self.init_cache(shape.global_batch, shape.seq_len,
                                torch.bfloat16, "meta")
        return _sorted_tree(tree_map(
            lambda x: x if torch.is_tensor(x)
            else torch.empty((), dtype=torch.int32, device="meta"), cache))

    # ---- forward / decode ---------------------------------------------------
    def forward(self, params: Dict, batch: Dict) -> torch.Tensor:
        """The logits (the family's `forward` also returns the MoE aux
        loss, which only the training loss reads)."""
        with ops_context(params):
            return self._mod.forward(params["base"], params["peft"], batch,
                                     self.cfg, self.peft, self.sites,
                                     remat=self.remat,
                                     **self._bank_kwargs(params))[0]

    def loss(self, params: Dict, batch: Dict) -> torch.Tensor:
        return self._mod.loss_fn(params["base"], params["peft"], batch,
                                 self.cfg, self.peft, self.sites,
                                 remat=self.remat, constrain=self.constrain)

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
        """Fill a fresh cache from a whole (B, S[, CB]) prompt. The
        transformer runs one causal forward; a recurrent family (ssm,
        hybrid) runs its decode step over the prompt, token by token, as
        the JAX package's scan does. Returns (next_tokens, cache)."""
        fn = getattr(self._mod, "prefill", None)
        if fn is not None:
            return self._call(fn, params, cache, batch)
        tokens = batch["tokens"]
        extra = {k: batch[k] for k in ("adapter_slots",) if k in batch}
        nt = None
        for t in range(tokens.shape[1]):
            nt, cache = self.decode_step(params, cache,
                                         {"tokens": tokens[:, t:t + 1],
                                          **extra})
        return nt, cache

    def prefill_paged(self, params: Dict, cache: Dict, batch: Dict):
        return self._call(self._slot_mod().prefill_paged, params, cache,
                          batch)

    def decode_step(self, params: Dict, cache: Dict, batch: Dict):
        return self._call_attending(self._mod.decode_step, params, cache,
                                    batch)

    def decode_logits(self, params: Dict, cache: Dict, batch: Dict):
        return self._call_attending(self._mod.decode_logits, params, cache,
                                    batch)

    def verify_step(self, params: Dict, cache: Dict, batch: Dict):
        """Draft verification: one forward over batch["tokens"] (B, W), the
        last accepted token and W-1 drafts per slot, writing all W K/V
        rows; returns the greedy continuation after each (B, W). `pos` does
        not advance (`advance_pos` commits the accepted counts). A paged
        cache reads through the same resolved attention as decode."""
        return self._call_attending(self._slot_mod().verify_step, params,
                                    cache, batch)

    def verify_logits(self, params: Dict, cache: Dict, batch: Dict):
        return self._call_attending(self._slot_mod().verify_logits, params,
                                    cache, batch)

    def _call_attending(self, fn, params: Dict, cache: Dict, batch: Dict):
        """`fn` (a decode or verify function of the family's module) with
        the attention resolved for a paged `cache`; a dense cache passes
        none."""
        if "pk" in cache:
            pk = cache["pk"]
            attend = self.paged_attention(pk.device, pk.dtype)
            if is_dtensor(pk):
                # K3 on each rank's local heads (dist/dtensor.py)
                attend = local_paged_attention(attend)
            return self._call(fn, params, cache, batch,
                              paged_attention=attend)
        return self._call(fn, params, cache, batch)

    def paged_attention(self, device, dtype):
        """The decode attention over a paged cache of `dtype` on `device`:
        the registry's op for this model's kv heads and head_dim, resolved
        once per (device type, dtype). A kernel that cannot take them
        raises KernelUnavailableError here."""
        key = (torch.device(device).type, dtype)
        fn = self._paged_fns.get(key)
        if fn is None:
            fn = self._paged_fns[key] = self._slot_mod().paged_attention_op(
                self.cfg, self.peft, device, dtype).fn
        return fn

    @property
    def supports_slot_cache(self) -> bool:
        """True when the family has the per-slot cache (ragged per-slot
        kv_len over one cache, dense or paged, with the write_slot /
        reset_slots / advance_pos lifecycle): the token-input transformer
        families without codebooks, as in the JAX package. The recurrent
        families (ssm, hybrid) carry state no slot can mask, codebook
        streams decode lockstep only, and vlm feeds embeddings, which no
        slot path carries."""
        return (hasattr(self._mod, "write_slot_cache")
                and self.cfg.embed_inputs and not self.cfg.n_codebooks)

    def _slot_mod(self):
        """The module of the slot paths (per-slot and paged caches,
        verification); a family without them (`supports_slot_cache`)
        raises, so every such call starts from this refusal."""
        if not self.supports_slot_cache:
            raise NotImplementedError(
                f"family {self.cfg.family!r} ({self.cfg.name}) has no "
                "per-slot cache path: continuous batching covers the "
                "token-input transformer families without codebooks; the "
                "others serve lockstep (Engine.generate)")
        return self._mod

    def init_cache(self, batch: int, max_len: int, dtype, device,
                   per_slot: bool = False, paged: bool = False,
                   page_size: int = 16, n_pages: Optional[int] = None) -> Dict:
        """Dense lockstep, dense per-slot or paged; a family without the
        per-slot path has only the lockstep cache."""
        if paged:
            mod = self._slot_mod()
            if n_pages is None:
                raise ValueError("paged cache needs n_pages (the runtime "
                                 "takes it from serve.paging.PagedKVCache)")
            return mod.init_paged_cache(self.cfg, batch, n_pages, page_size,
                                        dtype, device)
        if per_slot:
            return self._slot_mod().init_cache(self.cfg, batch, max_len,
                                               dtype, device, per_slot=True)
        return self._mod.init_cache(self.cfg, batch, max_len, dtype, device)

    def write_slot(self, cache: Dict, slot_cache: Dict, slot: int,
                   length) -> Dict:
        """In-flight prefill on the dense per-slot cache: splice a primed
        batch-1 cache into slot row `slot` (position <- `length`)."""
        return self._on_cache(self._slot_mod().write_slot_cache, cache,
                              slot_cache, slot, length)

    def reset_slots(self, cache: Dict, mask) -> Dict:
        return self._on_cache(self._slot_mod().reset_slots, cache, mask)

    def advance_pos(self, cache: Dict, delta) -> Dict:
        """Per-slot position commit after verification ((B,) accepted
        counts, or a scalar for the self-drafter's rollback)."""
        return self._on_cache(self._slot_mod().advance_pos, cache, delta)

    def copy_page(self, cache: Dict, src: int, dst: int) -> Dict:
        return self._on_cache(self._slot_mod().copy_page, cache, src, dst)

    # ---- kernels / accounting ---------------------------------------------
    def kernel_policy(self, device) -> kernel_api.KernelPolicy:
        """Which backend each targeted (site, op), and each bank group's
        `bank_apply`, resolves to on `device`."""
        return kernel_api.KernelPolicy.build(self.method, self.sites,
                                             self.peft, device,
                                             self.bank_profiles)

    def explain_kernels(self, device) -> str:
        """Which kernel backend each targeted (site, op) resolves to on
        `device`, rendered for humans (the JAX package's `explain_kernels`,
        which resolves for its one platform; here the device decides)."""
        return self.kernel_policy(device).explain()

    def trainable_params(self) -> int:
        """|Θ|: the adapters' count, or for `full` the base's, from its
        leaves' shapes (made on the meta device: no memory, no draw)."""
        if self.method.trains_base:
            base = self._mod.init_params(torch.Generator(), self.cfg,
                                         "meta")
            return sum(leaf.numel() for leaf in tree_leaves(base))
        return peft_mod.count_trainable(self.sites, self.peft)


def _sorted_tree(tree):
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def build(cfg: ModelConfig, peft: Optional[PEFTConfig] = None,
          remat: str = "none") -> Model:
    return Model(cfg, peft or PEFTConfig(), remat=remat)


def analysis_models(methods: Tuple[str, ...] = ("fourierft",),
                    archs: Optional[Tuple[str, ...]] = None):
    """Yield (arch_id, method, Model) for every registered config × method at
    reduced scale — the coverage surface the sharding audit walks
    (`init_shapes()` is meta tensors; nothing is materialized).
    Unbuildable combinations (a method whose applicability predicate rejects
    the family) are skipped: absent params can't need a sharding rule."""
    from repro_torch import configs
    for arch in (archs or tuple(configs.ARCHS)):
        cfg = configs.reduced(configs.get(arch))
        for m in methods:
            try:
                yield arch, m, build(cfg, PEFTConfig(method=m))
            except (ValueError, NotImplementedError):
                continue
