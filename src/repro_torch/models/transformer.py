"""Decoder-only LM for the dense, moe, audio and vlm families (the JAX
package's `models/transformer.py`).

- Params are nested dicts with the JAX key paths and layouts: stacked
  (L, d_in, d_out) weights applied as `x @ W`.
- Families: moe replaces the MLP by the top-k expert FFN (`models/moe.py`;
  an f32 router, experts `we_i/we_g/we_o`) and adds its load-balance loss
  to the training loss; audio (`n_codebooks`) sums one embedding per
  codebook and predicts every codebook with its own head, so tokens are
  (B, S, CB) and greedy decoding returns (B, CB); vlm
  (`embed_inputs=False`) takes batch["embeds"] (B, S, d) and M-RoPE
  positions (3, B, S) instead of tokens.
- Full-sequence attention (training forward, prefill) goes through
  `attention.attention`: direct up to 1024 rows, then the blocked flash or
  chunked path.
- `lax.scan` over layers becomes a Python loop over layers. The KV caches
  and page pools are written IN PLACE, layer by layer (the JAX version
  donates them to the same effect), so a decode step allocates no second
  cache.
- PEFT: the merged strategy (`apply_peft_to_layers` folds every targeted
  ΔW into W before the layer loop) and the factored one (the method's
  `factored_apply` inside each layer, `make_linear`). Merged training
  differentiates through the fold: on the card the ΔW kernel's autograd
  Function gives the coefficients their gradient through the dc kernel;
  factored training differentiates through the applies.
  After `merge_for_serving` the served model has method `none`, so decode
  does no adapter work.
- The serving adapter bank: per-request resident rows are gathered ONCE
  per call (outside the layer loop) and applied per slot through each
  method group's `bank_apply` (serve/engine.py `AdapterBank`).
- `remat` (training forward): "none"; "full" (`torch.utils.checkpoint` per
  layer, saving nothing inside it); "dots" (selective checkpointing that
  saves the projections' matmul outputs, the counterpart of JAX's
  `dots_with_no_batch_dims_saveable`).
- Paged decode dispatches the registry's `paged_attention` op: on the card
  that is the hand-written kernel (kernels/paged_attention.py). Draft
  verification (`verify_logits`) dispatches the same op with W = k+1 query
  rows per slot; its dense-cache form reads `windowed_decode_attention`.
"""
from __future__ import annotations

import functools
import numbers
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt_util

from repro_torch.configs.base import ModelConfig, PEFTConfig
from repro_torch.core import adapter as adapter_api
from repro_torch.core.spans import span
from repro_torch.devices import to_device
from repro_torch.dist.dtensor import (index_put_, local_attention,
                                     split_heads, unshard_dim, write_at)
from repro_torch.kernels import api as kernel_api
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (apply_rope, cross_entropy, dense_init,
                                       rms_norm)


# ---------------------------------------------------------------------------
# PEFT: merged, factored and the serving adapter bank
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SiteApp:
    """One factored adapter application at a weight key: its trainable
    per-layer slices ride the layer tree under `{key}{tag}{leaf}`, its
    frozen aux (entries and their cached tables) is captured here, and
    `banked` selects the row-batched `bank_apply`."""
    tag: str
    method: adapter_api.AdapterMethod
    aux: Dict = field(default_factory=dict)
    peft: PEFTConfig = PEFTConfig()
    banked: bool = False


def make_linear(apps: Dict[str, List[SiteApp]], constrain=None):
    """Returns linear(lp, name, x): y = x @ lp[name] + bias + the adapter
    applications at `name`, each under its own PEFTConfig (the model's
    config has no say there). `constrain` (the `Model.constrain` hook)
    sees each 2-D weight slice as `fsdp_gather/<name>`: under FSDP the
    slice stored `data`-sharded is gathered there, inside the layer
    loop. Under a profiler each application, forward and backward, lies
    in the range `adapter`."""

    def linear(lp: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
        w = lp[name]
        if constrain is not None and w.ndim >= 2:
            w = constrain("fsdp_gather/" + name, w)
        y = x @ w
        if name + "__b" in lp:
            y = y + lp[name + "__b"].to(y.dtype)
        d1, d2 = w.shape
        for app in apps.get(name, ()):
            tr = {leaf: lp[name + app.tag + leaf]
                  for leaf in app.method.trainable_leaves(app.peft)}
            fn = app.method.bank_apply if app.banked \
                else app.method.factored_apply
            with span("adapter") as sp:
                out = fn(x, tr, app.aux, d1, d2, app.peft).to(y.dtype)
                sp.backward(out)
            y = y + out
        return y

    return linear


def _app_tag(kind: str, method_name: str) -> str:
    return f"__{kind}.{method_name}__"


def apply_peft_to_layers(layers: Dict, adapters: Dict, sites,
                         peft: PEFTConfig, prefix: str = "layers/",
                         bank: Optional[Dict] = None,
                         bank_profiles: Optional[Dict[str, PEFTConfig]] = None,
                         bank_slots: Optional[Dict] = None
                         ) -> Tuple[Dict, Dict[str, List[SiteApp]]]:
    """Returns (eff_layers, apps). Merged strategy (and a mergeable
    method): the method folds the site into the stacked tree (W <- W + ΔW;
    BitFit into the bias). Factored: the trainable leaves join the tree
    under tagged keys, the frozen aux stays in the app, and `make_linear`
    applies the method inside each layer.

    `bank` / `bank_profiles` / `bank_slots`: the serving adapter bank. For
    each method group the per-request rows are gathered from the
    (K+1, L, ...) resident leaves with `bank_slots[method]` (B,) ONCE
    here, outside the layer loop, and enter the tree as (L, B, ...) leaves;
    row K is the reserved zero row, so a request that does not use a method
    contributes exactly zero."""
    eff = dict(layers)
    apps: Dict[str, List[SiteApp]] = {}
    method = adapter_api.resolve(peft.method)
    site_by_name = {s.name: s for s in sites}
    trainable = set(method.trainable_leaves(peft))
    for full_name, ad in adapters.items():
        if not full_name.startswith(prefix):
            continue
        key = full_name[len(prefix):]
        if peft.strategy == "merged" and method.mergeable:
            method.merge_site(eff, key, ad, site_by_name[full_name], peft)
            continue
        tag = _app_tag("ad", method.name)
        aux = {}
        for leaf, v in ad.items():
            if leaf in trainable:
                eff[key + tag + leaf] = v
            else:
                aux[leaf] = v
        apps.setdefault(key, []).append(SiteApp(tag, method, aux, peft))
    if bank and bank_slots is None:
        raise ValueError("adapter bank configured but the batch carries no "
                         "'adapter_slots' (Engine.generate builds them; "
                         "direct model calls must pass bank.slot_rows(...))")
    for mname in sorted(bank or ()):
        group = bank[mname]
        m = adapter_api.resolve(mname)
        slots = bank_slots[mname].to(torch.int64)       # (B,) incl. zero row
        tag = _app_tag("bank", mname)
        for full_name, leaves in group["sites"].items():
            if not full_name.startswith(prefix):
                continue
            key = full_name[len(prefix):]
            for leaf, arr in leaves.items():             # (K+1, L, ...)
                eff[key + tag + leaf] = arr.index_select(0, slots) \
                    .transpose(0, 1)                     # (L, B, ...)
            apps.setdefault(key, []).append(
                SiteApp(tag, m, group["aux"].get(full_name, {}),
                        bank_profiles[mname], banked=True))
    return eff, apps


def _layers(eff: Dict) -> List[Dict]:
    """Per-layer views of the stacked layer tree. Each stack is unbound
    once, so a backward pass stacks the layers' gradients into one tensor
    (indexing layer by layer would zero-fill a whole stack per layer)."""
    cols = {k: v.unbind(0) for k, v in eff.items()}
    depth = len(next(iter(cols.values())))
    return [{k: c[li] for k, c in cols.items()} for li in range(depth)]


def _effective(params: Dict, adapters: Dict, sites, peft: PEFTConfig,
               batch: Dict, bank, bank_profiles, constrain=None):
    """(per-layer views of the effective layer tree, its `linear`) for one
    call: the adapters merged or applied, the bank's rows gathered. Under
    a profiler the merge, forward and backward, lies in the range
    `adapter`."""
    with span("adapter") as sp:
        eff, apps = apply_peft_to_layers(
            params["layers"], adapters, sites, peft, bank=bank,
            bank_profiles=bank_profiles,
            bank_slots=batch.get("adapter_slots"))
        sp.backward(eff)
    return _layers(eff), make_linear(apps, constrain)


def activation_anchor(constrain):
    """x -> constrain("act/hidden", x): the residual stream pinned at layer
    boundaries (batch-sharded; the identity without a hook or on plain
    tensors)."""
    if constrain is None:
        return lambda t: t
    return lambda t: constrain("act/hidden", t)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

# the families this decoder builds (the JAX package builds ssm and hybrid
# models in modules of their own)
FAMILIES = ("dense", "moe", "audio", "vlm")


def init_params(gen: torch.Generator, cfg: ModelConfig, device) -> Dict:
    from repro_torch.core.adapter import torch_dtype
    dtype = torch_dtype(cfg.param_dtype)
    d, L = cfg.d_model, cfg.num_layers

    def init(shape):
        return dense_init(gen, shape, dtype, device)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers = {
        "attn_norm": ones((L, d)),
        "wq": init((L, d, cfg.attn_dim)),
        "wk": init((L, d, cfg.kv_dim)),
        "wv": init((L, d, cfg.kv_dim)),
        "wo": init((L, cfg.attn_dim, d)),
        "mlp_norm": ones((L, d)),
    }
    if cfg.qkv_bias:
        layers["wq__b"] = zeros((L, cfg.attn_dim))
        layers["wk__b"] = zeros((L, cfg.kv_dim))
        layers["wv__b"] = zeros((L, cfg.kv_dim))
    if cfg.qk_norm:
        layers["q_norm"] = ones((L, cfg.head_dim))
        layers["k_norm"] = ones((L, cfg.head_dim))
    if cfg.moe is not None:
        e, f = cfg.moe.num_experts, cfg.moe.d_ff_expert
        layers["router"] = dense_init(gen, (L, d, e), torch.float32, device)
        layers["we_i"] = init((L, e, d, f))
        layers["we_g"] = init((L, e, d, f))
        layers["we_o"] = init((L, e, f, d))
    else:
        layers["wi"] = init((L, d, cfg.d_ff))
        if cfg.gated_mlp:
            layers["wg"] = init((L, d, cfg.d_ff))
        layers["wo_mlp"] = init((L, cfg.d_ff, d))
    params = {"layers": layers, "final_norm": ones((d,))}
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    if cfg.embed_inputs:
        params["embed"] = init(cb + (cfg.vocab, d))
    params["lm_head"] = init(cb + (d, cfg.vocab))
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _lookup(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return emb.index_select(0, tokens.reshape(-1)).reshape(
        *tokens.shape, emb.shape[-1])


def _embed(params: Dict, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """(B, S, d): the token embeddings; for codebooks (tokens (B, S, CB))
    the sum of the per-codebook embeddings; for vlm batch["embeds"]."""
    if not cfg.embed_inputs:
        return batch["embeds"].to(adapter_api.torch_dtype(cfg.dtype))
    tokens = batch["tokens"]
    if cfg.n_codebooks:
        x = _lookup(params["embed"][0], tokens[..., 0])
        for cb in range(1, cfg.n_codebooks):
            x = x + _lookup(params["embed"][cb], tokens[..., cb])
        return x
    return _lookup(params["embed"], tokens)


def _qkv(lp: Dict, x: torch.Tensor, cfg: ModelConfig, linear, positions):
    B = x.shape[0]
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = split_heads(linear(lp, "wq", h), cfg.n_heads, cfg.head_dim)
    k = split_heads(linear(lp, "wk", h), cfg.n_kv, cfg.head_dim)
    v = split_heads(linear(lp, "wv", h), cfg.n_kv, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope)
    return q, k, v


def _attn_block(lp: Dict, x: torch.Tensor, cfg: ModelConfig, linear,
                positions, *, cache_kv=None, cache_pos: int = 0):
    """Pre-norm attention. Without `cache_kv` it is the causal prefill and
    returns the post-RoPE (k, v). With `cache_kv=(k, v)` of one layer of a
    lockstep cache (every row at the int position `cache_pos`) it is the
    lockstep decode, writing the new rows IN PLACE. Per-slot caches decode
    through `verify_logits`."""
    out, new_kv = _attn_out(lp, x, cfg, linear, positions, cache_kv=cache_kv,
                           cache_pos=cache_pos)
    return x + out, new_kv


def _attn_out(lp: Dict, x: torch.Tensor, cfg: ModelConfig, linear,
             positions, *, cache_kv=None, cache_pos: int = 0,
             scale: Optional[float] = None):
    """`_attn_block`'s attention output (after `wo`) without the residual,
    and the (k, v) it returns; `scale` multiplies the scores (None:
    head_dim ** -0.5)."""
    B = x.shape[0]
    q, k, v = _qkv(lp, x, cfg, linear, positions)
    if cache_kv is None:
        att = local_attention(attn_mod.attention, q, k, v, causal=True,
                              scale=scale)
        new_kv = (k, v)
    else:
        ck, cv = cache_kv
        S = k.shape[1]
        ck[:, cache_pos:cache_pos + S] = k.to(ck.dtype)
        cv[:, cache_pos:cache_pos + S] = v.to(cv.dtype)
        att = local_attention(attn_mod.direct_attention, q, ck, cv,
                              causal=False, kv_len=cache_pos + 1,
                              scale=scale)
        new_kv = (ck, cv)
    return linear(lp, "wo", att.reshape(B, -1, cfg.attn_dim)), new_kv


def _mlp_block(lp: Dict, x: torch.Tensor, cfg: ModelConfig, linear,
               constrain=None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """-> (x + the MLP's output, the layer's MoE aux loss; None without
    experts, so the dense path launches nothing for it)."""
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if cfg.moe is not None:
        y, aux = moe_mod.moe_ffn(h, lp, cfg.moe, gated=cfg.gated_mlp,
                                 constrain=constrain)
        return x + y, aux
    hi = linear(lp, "wi", h)
    if cfg.gated_mlp:
        hg = linear(lp, "wg", h)
        hi = torch.nn.functional.silu(hg.to(torch.float32)).to(hi.dtype) * hi
    else:
        hi = torch.nn.functional.gelu(hi.to(torch.float32),
                                      approximate="tanh").to(hi.dtype)
    return x + linear(lp, "wo_mlp", hi), None


def _logits(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, S, V), or (B, S, CB, V) with one head per codebook; with tied
    embeddings the head is the embedding's transpose."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.n_codebooks:
        return torch.einsum("bsd,cdv->bscv", x, params["lm_head"])
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """Next tokens after the last position: (B,), or (B, CB)."""
    # vocab-sharded logits (a DTensor) are gathered along the vocab first:
    # DTensor's sharded argmax does not take every batch shape
    return torch.argmax(unshard_dim(logits[:, -1], -1),
                        dim=-1).to(torch.int32)


def _positions(B: int, S: int, device, offset=0) -> torch.Tensor:
    return (torch.arange(S, dtype=torch.int32, device=device)
            + offset).expand(B, S)


# ---------------------------------------------------------------------------
# Forward and prefill
# ---------------------------------------------------------------------------

REMAT_MODES = ("none", "dots", "full")

# the ops "dots" saves: the projections' matmuls (no batch dims), as JAX's
# dots_with_no_batch_dims_saveable; attention's batched products recompute
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt_util.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else ckpt_util.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, mode: str):
    if mode == "none":
        return fn
    if mode == "dots":
        context_fn = functools.partial(
            ckpt_util.create_selective_checkpoint_contexts, _save_dots)
        return lambda *a: ckpt_util.checkpoint(
            fn, *a, use_reentrant=False, context_fn=context_fn)
    if mode == "full":
        return lambda *a: ckpt_util.checkpoint(fn, *a, use_reentrant=False)
    raise ValueError(f"unknown remat {mode!r}; one of {REMAT_MODES}")


def forward(params: Dict, adapters: Dict, batch: Dict, cfg: ModelConfig,
            peft: PEFTConfig, sites, *, remat: str = "none", bank=None,
            bank_profiles=None,
            constrain=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal forward over the batch (`_embed`; batch["positions"], when
    given, are the RoPE positions: (B, S), or (3, B, S) for M-RoPE).
    Returns (logits (B, S, V) or (B, S, CB, V), the MoE aux loss averaged
    over layers). The merge (and the bank's gather, with
    batch["adapter_slots"]) runs once, outside the per-layer checkpoints
    (as in JAX, where it precedes the scanned body)."""
    x = _embed(params, cfg, batch)
    B, S = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(B, S, x.device)
    layers, linear = _effective(params, adapters, sites, peft, batch, bank,
                                bank_profiles, constrain)
    act = activation_anchor(constrain)

    def body(lp, x):
        # remat re-enters the range when it recomputes the layer
        with span("layer"):
            x, _ = _attn_block(lp, act(x), cfg, linear, positions)
            x, aux_l = _mlp_block(lp, act(x), cfg, linear, constrain)
            return act(x), aux_l

    body = _remat(body, remat)
    x = act(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layers:
        x, aux_l = body(lp, x)
        if aux_l is not None:
            aux = aux + aux_l
    return _logits(params, x, cfg), aux / cfg.num_layers


def loss_fn(params: Dict, adapters: Dict, batch: Dict, cfg: ModelConfig,
            peft: PEFTConfig, sites, *, remat: str = "none",
            constrain=None) -> torch.Tensor:
    """Mean token cross-entropy of the causal forward against
    batch["labels"] (B, S) or (B, S, CB), f32, plus the MoE aux loss
    weighted by `aux_loss_weight`."""
    logits, moe_aux = forward(params, adapters, batch, cfg, peft, sites,
                              remat=remat, constrain=constrain)
    ce = cross_entropy(logits, batch["labels"])
    if cfg.moe is not None:
        ce = ce + cfg.moe.aux_loss_weight * moe_aux
    return ce


def prefill(params: Dict, adapters: Dict, cache: Dict, batch: Dict,
            cfg: ModelConfig, peft: PEFTConfig, sites, bank=None,
            bank_profiles=None, constrain=None) -> Tuple[torch.Tensor, Dict]:
    """Process a (B, S[, CB]) prompt against a fresh dense cache (pos 0),
    writing its KV in place. Returns (next tokens after the last prompt
    token, (B,) or (B, CB); cache at pos S). batch["true_len"] (B,),
    optional: per-row real prompt length of right-padded prompts — next
    tokens are read at true_len - 1."""
    x = _embed(params, cfg, batch)
    B, S = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(B, S, x.device)
    layers, linear = _effective(params, adapters, sites, peft, batch, bank,
                                bank_profiles, constrain)
    ck_all, cv_all = cache["k"], cache["v"]
    for li, lp in enumerate(layers):
        x, (k, v) = _attn_block(lp, x, cfg, linear, positions)
        ck_all[li, :, :S] = k.to(ck_all.dtype)
        cv_all[li, :, :S] = v.to(cv_all.dtype)
        x, _ = _mlp_block(lp, x, cfg, linear, constrain)
    true_len = batch.get("true_len")
    if true_len is None:
        x = x[:, -1:]
    else:
        rows = torch.arange(B, device=x.device)
        x = x[rows, true_len.to(torch.int64) - 1][:, None]
    next_tokens = _greedy(_logits(params, x, cfg))
    return next_tokens, {"k": ck_all, "v": cv_all, "pos": cache["pos"] + S}


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device,
               per_slot: bool = False) -> Dict:
    """Dense KV cache (L, B, max_len, K, hd). pos is an int for the lockstep
    batch, or a (B,) int32 tensor for the per-slot cache where every slot
    advances on its own."""
    L = cfg.num_layers
    shape = (L, batch, max_len, cfg.n_kv, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": (torch.zeros((batch,), dtype=torch.int32, device=device)
                if per_slot else 0),
    }


def write_slot_cache(cache: Dict, slot_cache: Dict, slot: int,
                     length) -> Dict:
    """In-flight prefill splice: write one primed request's KV (a batch-1
    cache of P <= max_len rows) into slot row `slot` of a per-slot dense
    cache, in place, and set that slot's position to `length`. Every other
    slot's rows and position are untouched."""
    pos = cache["pos"]
    if not torch.is_tensor(pos):
        raise ValueError("write_slot_cache needs a per-slot cache")
    P = slot_cache["k"].shape[2]
    for key in ("k", "v"):
        write_at(cache[key][:, :, :P], 1, slot,
                 slot_cache[key][:, 0].to(cache[key].dtype))
    write_at(pos, 0, slot, int(length))
    return cache


def reset_slots(cache: Dict, mask) -> Dict:
    """Retire slots: masked slots' positions return to 0 (their KV rows are
    left as they are — dead until overwritten, and unreadable meanwhile
    because kv_len masking never reaches them)."""
    pos = cache["pos"]
    if not torch.is_tensor(pos):
        raise ValueError("reset_slots needs a per-slot cache")
    mask = to_device(mask, pos.device, torch.bool)
    return {**cache, "pos": torch.where(mask, torch.zeros_like(pos), pos)}


def advance_pos(cache: Dict, delta) -> Dict:
    """Per-slot position commit for speculative decoding: `pos + delta`,
    clamped at 0. `delta` is a (B,) array of accepted counts (0 for free
    slots) or a scalar (the self-drafter rolls its k probe steps back with
    -k); the clamp keeps free slots, which sit at 0, from going negative."""
    pos = cache["pos"]
    if not torch.is_tensor(pos):
        raise ValueError("advance_pos needs a per-slot cache")
    if isinstance(delta, numbers.Integral):
        moved = pos + int(delta)
    else:
        moved = pos + to_device(delta, pos.device, pos.dtype)
    return {**cache, "pos": torch.clamp(moved, min=0)}


def init_paged_cache(cfg: ModelConfig, batch: int, n_pages: int,
                     page_size: int, dtype, device) -> Dict:
    """Page-pool cache: K/V in (L, n_pages, page_size, K, hd) pools shared
    by every slot; `pos` is the per-slot (B,) position vector. Slots map
    positions onto pages through the block table each call passes."""
    L = cfg.num_layers
    shape = (L, n_pages, page_size, cfg.n_kv, cfg.head_dim)
    return {
        "pk": torch.zeros(shape, dtype=dtype, device=device),
        "pv": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def copy_page(cache: Dict, src: int, dst: int) -> Dict:
    """Copy-on-write clone of physical page `src` into `dst` across every
    layer of both pools, in place (pos untouched)."""
    for key in ("pk", "pv"):
        cache[key][:, dst] = cache[key][:, src]
    return cache


def prefill_paged(params: Dict, adapters: Dict, cache: Dict, batch: Dict,
                  cfg: ModelConfig, peft: PEFTConfig, sites, bank=None,
                  bank_profiles=None,
                  constrain=None) -> Tuple[torch.Tensor, Dict]:
    """Shared-prefix tail prefill into the page pool: run only the unshared
    tail of a prompt whose first `prefix_len` tokens are already resident
    in pages, writing the tail's KV through the block table in place.

    batch:
      tokens       (1, T)   right-padded tail tokens
      true_len     (1,)     optional real tail length (absent => T)
      block_table  (1, PPS) the slot's page map
      window_table (1, WP)  leading slice of block_table covering the
                            resident prefix; ABSENT on a cold prime (plain
                            causal attention, no page window)
      prefix_len   int      reused prefix tokens (present iff window_table)
      slot         int      slot whose pos becomes prefix_len + true_len
      scratch_page int      pad/overflow KV rows are routed to this page
      adapter_slots         the bank's gather rows (with a bank)

    Returns (next_tokens (1,), cache) like `prefill`."""
    x = _embed(params, cfg, batch)
    B, T = x.shape[0], x.shape[1]
    dev = x.device
    wt = batch.get("window_table")
    prefix_len = int(batch["prefix_len"]) if wt is not None else 0
    positions = _positions(B, T, dev, prefix_len)
    layers, linear = _effective(params, adapters, sites, peft, batch, bank,
                                bank_profiles, constrain)
    bt = batch["block_table"]
    ps = cache["pk"].shape[2]
    cap = bt.shape[1] * ps
    true_len = batch.get("true_len")
    tlen = (true_len[0].to(torch.int64) if true_len is not None
            else torch.full((), T, dtype=torch.int64, device=dev))
    # scatter targets: tail row j holds logical position prefix_len + j;
    # pad rows (j >= tlen) and overflow land in the slot's scratch page
    j = torch.arange(T, device=dev)
    logical = prefix_len + j
    valid = (j < tlen) & (logical < cap)
    safe = torch.where(valid, logical, torch.zeros_like(logical))
    w_page = torch.where(valid, bt[0].to(torch.int64)[safe // ps],
                         torch.full_like(j, int(batch["scratch_page"])))
    w_off = torch.where(valid, safe % ps, j % ps)
    for li, lp in enumerate(layers):
        q, k, v = _qkv(lp, x, cfg, linear, positions)
        pk, pv = cache["pk"][li], cache["pv"][li]
        if wt is not None:
            # the resident prefix, gathered BEFORE the tail writes (the
            # window only reads columns < prefix_len, which the tail never
            # touches)
            win = wt.shape[1] * ps
            rows = wt[0].to(torch.int64)
            kw = pk[rows].reshape(1, win, cfg.n_kv, cfg.head_dim)
            vw = pv[rows].reshape(1, win, cfg.n_kv, cfg.head_dim)
            att = attn_mod.prefix_attention(q, k, v, kw, vw, prefix_len)
        else:
            att = local_attention(attn_mod.attention, q, k, v, causal=True)
        x = x + linear(lp, "wo", att.reshape(B, -1, cfg.attn_dim))
        # pad rows may collide inside the scratch page — dirt either way
        index_put_(pk, (w_page, w_off), k[0].to(pk.dtype))
        index_put_(pv, (w_page, w_off), v[0].to(pv.dtype))
        x, _ = _mlp_block(lp, x, cfg, linear, constrain)
    # a tensor index, not a 0-dim one (which the host would read)
    x = x.index_select(1, (tlen - 1).reshape(1))
    next_tokens = _greedy(_logits(params, x, cfg))
    pos = cache["pos"]
    write_at(pos, 0, int(batch["slot"]), prefix_len + tlen.to(pos.dtype))
    return next_tokens, cache


def paged_attention_op(cfg: ModelConfig, peft: PEFTConfig, device,
                       dtype) -> kernel_api.KernelOp:
    """The registry's `paged_attention` op for this model's kv heads,
    head_dim and cache dtype on `device`: a head_dim or dtype the CUDA
    kernel cannot take raises KernelUnavailableError here, before any
    decode step."""
    from repro_torch.kernels import paged_attention as paged_mod
    return kernel_api.resolve_op("paged_attention", paged_mod.OWNER, peft,
                                 d1=cfg.n_kv, d2=cfg.head_dim, device=device,
                                 dtype=dtype)


def decode_logits(params: Dict, adapters: Dict, cache: Dict, batch: Dict,
                  cfg: ModelConfig, peft: PEFTConfig, sites,
                  paged_attention=None, bank=None,
                  bank_profiles=None,
                  constrain=None) -> Tuple[torch.Tensor, Dict]:
    """One token for every sequence: batch["tokens"] (B, 1) ((B, 1, CB) for
    codebooks; vlm: batch["embeds"] (B, 1, d) and batch["positions"]
    (3, B, 1)). Returns (logits (B, 1, V) or (B, 1, CB, V), cache with
    pos + 1); the cache is written in place.

    A per-slot cache (a (B,) `pos`, dense or paged) decodes as a
    `verify_logits` window of one row and then advances `pos`; a paged
    cache takes what that window takes (batch["block_table"],
    batch["scratch_pages"] and `paged_attention`)."""
    pos = cache["pos"]
    if torch.is_tensor(pos):
        logits, cache = verify_logits(params, adapters, cache, batch, cfg,
                                      peft, sites, paged_attention, bank,
                                      bank_profiles, constrain)
        return logits, {**cache, "pos": pos + 1}
    x = _embed(params, cfg, batch)
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(x.shape[0], 1, x.device, pos)
    layers, linear = _effective(params, adapters, sites, peft, batch, bank,
                                bank_profiles, constrain)
    # the residual stream anchored at layer boundaries, as in `forward`:
    # without it DTensor may reduce-scatter a row-parallel output over
    # `model` and run the next layer on gathered weights
    act = activation_anchor(constrain)
    for li, lp in enumerate(layers):
        x, _ = _attn_block(lp, act(x), cfg, linear, positions,
                           cache_kv=(cache["k"][li], cache["v"][li]),
                           cache_pos=pos)
        x, _ = _mlp_block(lp, act(x), cfg, linear, constrain)
    x = act(x)
    return _logits(params, x, cfg), {"k": cache["k"], "v": cache["v"],
                                     "pos": pos + 1}


def decode_step(params: Dict, adapters: Dict, cache: Dict, batch: Dict,
                cfg: ModelConfig, peft: PEFTConfig, sites,
                paged_attention=None, bank=None,
                bank_profiles=None,
                constrain=None) -> Tuple[torch.Tensor, Dict]:
    """Greedy `decode_logits`: (next_tokens (B,) or (B, CB) int32,
    cache)."""
    logits, cache = decode_logits(params, adapters, cache, batch, cfg, peft,
                                  sites, paged_attention, bank, bank_profiles,
                                  constrain)
    return _greedy(logits), cache


def verify_logits(params: Dict, adapters: Dict, cache: Dict, batch: Dict,
                  cfg: ModelConfig, peft: PEFTConfig, sites,
                  paged_attention=None, bank=None,
                  bank_profiles=None,
                  constrain=None) -> Tuple[torch.Tensor, Dict]:
    """Draft verification: one forward over a window of W consecutive
    tokens per slot. batch["tokens"] (B, W) holds [last accepted token,
    draft_1 .. draft_{W-1}]; window row j sits at position pos + j of a
    per-slot cache. Returns (logits (B, W, V), cache); logits[:, j] score
    the continuation after window token j.

    Each layer writes all W K/V rows (in place) before its attention reads
    them, and query row j attends columns < pos + 1 + j: the rows W
    sequential decode steps would see. `pos` does not advance; the
    scheduler commits each slot's accepted count with `advance_pos`, and
    rejected rows stay past kv_len until a later window overwrites them.

    Paged cache: batch["block_table"] (B, PPS) routes the writes; a
    position at or past PPS·ps goes to batch["scratch_pages"][b] (slot b's
    scratch page, `PagedKVCache.scratch_pages_device`) at offset j % ps,
    never clamped onto a real row. Attention is `paged_attention` with
    kv_len = pos + 1 (on the card the paged-attention kernel at W rows).
    Dense cache: rows past max_len are dropped, attention is
    `windowed_decode_attention`. `decode_logits` on a per-slot cache is
    this function at W = 1."""
    x = _embed(params, cfg, batch)
    B, W = x.shape[0], x.shape[1]
    dev = x.device
    pos = cache["pos"]
    if not torch.is_tensor(pos):
        raise ValueError("verify needs a per-slot cache")
    j = torch.arange(W, dtype=torch.int64, device=dev)
    positions = pos.to(torch.int64)[:, None] + j[None, :]        # (B, W)
    kv_len = pos + 1                          # what query row 0 sees
    layers, linear = _effective(params, adapters, sites, peft, batch, bank,
                                bank_profiles, constrain)
    paged = "pk" in cache
    if paged:
        if paged_attention is None:
            raise ValueError("a paged cache needs the paged_attention "
                             "function (paged_attention_op)")
        bt = batch["block_table"]
        ps = cache["pk"].shape[2]
        valid = positions < bt.shape[1] * ps
        safe = torch.where(valid, positions, torch.zeros_like(positions))
        w_page = torch.where(valid, torch.gather(bt.to(torch.int64), 1,
                                                 safe // ps),
                             batch["scratch_pages"].to(torch.int64)[:, None])
        w_off = torch.where(valid, safe % ps, (j % ps)[None, :])
        kk, vk = "pk", "pv"
    else:
        # drop the rows past max_len without a host sync: they are written
        # clamped onto column T-1, then each slot's window row that owns
        # column T-1 (or, without overflow, its last row) is written again
        T = cache["k"].shape[2]
        rows = torch.arange(B, device=dev)
        col = torch.clamp(positions, max=T - 1)
        own = torch.clamp(T - 1 - pos.to(torch.int64), 0, W - 1)     # (B,)
        own_col = torch.clamp(pos.to(torch.int64) + own, max=T - 1)
        kk, vk = "k", "v"
    act = activation_anchor(constrain)      # as in decode_logits
    for li, lp in enumerate(layers):
        q, k, v = _qkv(lp, x, cfg, linear, positions)
        ck, cv = cache[kk][li], cache[vk][li]
        if paged:
            # write, then attend: rows of one slot past its pages share
            # its scratch page at distinct offsets while W <= ps
            index_put_(ck, (w_page, w_off), k.to(ck.dtype))
            index_put_(cv, (w_page, w_off), v.to(cv.dtype))
            att = paged_attention(q, ck, cv, bt, kv_len)
        else:
            for c, t in ((ck, k), (cv, v)):
                index_put_(c, (rows[:, None], col), t.to(c.dtype))
                if W > 1:               # one row needs no second write
                    index_put_(c, (rows, own_col),
                               t[rows, own].to(c.dtype))
            att = local_attention(attn_mod.windowed_decode_attention, q,
                                  ck, cv, kv_len)
        x = x + linear(lp, "wo", att.reshape(B, W, cfg.attn_dim))
        x, _ = _mlp_block(lp, act(x), cfg, linear, constrain)
        x = act(x)
    return _logits(params, x, cfg), {kk: cache[kk], vk: cache[vk],
                                     "pos": pos}


def verify_step(params: Dict, adapters: Dict, cache: Dict, batch: Dict,
                cfg: ModelConfig, peft: PEFTConfig, sites,
                paged_attention=None, bank=None,
                bank_profiles=None,
                constrain=None) -> Tuple[torch.Tensor, Dict]:
    """Greedy `verify_logits`: (tokens (B, W) int32, cache), tokens[:, j]
    the greedy continuation after window token j."""
    logits, cache = verify_logits(params, adapters, cache, batch, cfg, peft,
                                  sites, paged_attention, bank, bank_profiles,
                                  constrain)
    return torch.argmax(unshard_dim(logits, -1),
                        dim=-1).to(torch.int32), cache
