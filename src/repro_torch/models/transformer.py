"""Decoder-only LM for the dense family (the JAX package's
`models/transformer.py`, dense path).

- Params are nested dicts with the JAX key paths and layouts: stacked
  (L, d_in, d_out) weights applied as `x @ W`.
- `lax.scan` over layers becomes a Python loop over layers. The KV caches
  and page pools are written IN PLACE, layer by layer (the JAX version
  donates them to the same effect), so a decode step allocates no second
  cache.
- PEFT covers the merged strategy (`apply_peft_to_layers` folds every
  targeted ΔW into W before the layer loop). Training differentiates
  through that fold: on the card the ΔW kernel's autograd Function gives
  the coefficients their gradient through the dc kernel. After
  `merge_for_serving` the served model has method `none`, so decode does no
  adapter work. The factored strategy and the adapter bank come with later
  slices.
- `remat` (training forward): "none"; "full" (`torch.utils.checkpoint` per
  layer, saving nothing inside it); "dots" (selective checkpointing that
  saves the projections' matmul outputs, the counterpart of JAX's
  `dots_with_no_batch_dims_saveable`).
- Paged decode dispatches the registry's `paged_attention` op: on the card
  that is the hand-written kernel (kernels/paged_attention.py).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch
from torch.utils import checkpoint as ckpt_util

from repro_torch.configs.base import ModelConfig, PEFTConfig
from repro_torch.core import adapter as adapter_api
from repro_torch.kernels import api as kernel_api
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (apply_rope, cross_entropy, dense_init,
                                       rms_norm)


# ---------------------------------------------------------------------------
# PEFT (merged strategy)
# ---------------------------------------------------------------------------

def apply_peft_to_layers(layers: Dict, adapters: Dict, sites,
                         peft: PEFTConfig, prefix: str = "layers/") -> Dict:
    """Returns the effective layer tree: every targeted site folded in
    (W <- W + ΔW) through the method's `merge_site`."""
    if not adapters:
        return layers
    eff = dict(layers)
    method = adapter_api.resolve(peft.method)
    site_by_name = {s.name: s for s in sites}
    for full_name, ad in adapters.items():
        if not full_name.startswith(prefix):
            continue
        if peft.strategy != "merged" or not method.mergeable:
            raise NotImplementedError(
                "the factored strategy comes with a later slice (ROADMAP "
                "queue 1); serve merged adapters")
        method.merge_site(eff, full_name[len(prefix):], ad,
                          site_by_name[full_name], peft)
    return eff


def linear(lp: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    y = x @ lp[name]
    if name + "__b" in lp:
        y = y + lp[name + "__b"].to(y.dtype)
    return y


def _layers(eff: Dict) -> List[Dict]:
    """Per-layer views of the stacked layer tree. Each stack is unbound
    once, so a backward pass stacks the layers' gradients into one tensor
    (indexing layer by layer would zero-fill a whole stack per layer)."""
    cols = {k: v.unbind(0) for k, v in eff.items()}
    depth = len(next(iter(cols.values())))
    return [{k: c[li] for k, c in cols.items()} for li in range(depth)]


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig, device) -> Dict:
    from repro_torch.core.adapter import torch_dtype
    if cfg.family != "dense" or cfg.n_codebooks or not cfg.embed_inputs:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
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
    layers["wi"] = init((L, d, cfg.d_ff))
    if cfg.gated_mlp:
        layers["wg"] = init((L, d, cfg.d_ff))
    layers["wo_mlp"] = init((L, cfg.d_ff, d))
    return {"layers": layers, "final_norm": ones((d,)),
            "embed": init((cfg.vocab, d)), "lm_head": init((d, cfg.vocab))}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _embed(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    return emb.index_select(0, tokens.reshape(-1)).reshape(
        *tokens.shape, emb.shape[-1])


def _qkv(lp: Dict, x: torch.Tensor, cfg: ModelConfig, positions):
    B = x.shape[0]
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = linear(lp, "wq", h).reshape(B, -1, cfg.n_heads, cfg.head_dim)
    k = linear(lp, "wk", h).reshape(B, -1, cfg.n_kv, cfg.head_dim)
    v = linear(lp, "wv", h).reshape(B, -1, cfg.n_kv, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_block(lp: Dict, x: torch.Tensor, cfg: ModelConfig, positions, *,
                cache_kv=None, cache_pos=None, paged=None):
    """Pre-norm attention. Without `cache_kv` it is the causal prefill and
    returns the post-RoPE (k, v). With `cache_kv=(k, v)` of one layer it is
    the decode path, writing the new rows IN PLACE: an int `cache_pos` is
    the lockstep batch, a (B,) tensor the per-slot path (each row at its own
    position, ragged kv_len). `paged=(block_table, attn_fn)` makes cache_kv
    a page-pool pair ((P, ps, K, hd)): each row's token goes to the page its
    block-table row maps the position to, and `attn_fn` (the registry's
    paged_attention op) reads K/V through the block table."""
    B = x.shape[0]
    q, k, v = _qkv(lp, x, cfg, positions)
    if cache_kv is None:
        att = attn_mod.attention(q, k, v, causal=True)
        new_kv = (k, v)
    elif paged is not None:
        bt, attn_fn = paged
        pk, pv = cache_kv
        ps = pk.shape[1]
        # clamp keeps retired slots in bounds (their block-table rows point
        # at the slot's reserved scratch page — dirt, never readable)
        idx = torch.clamp(cache_pos, max=bt.shape[1] * ps - 1).to(torch.int64)
        page = torch.gather(bt, 1, (idx // ps)[:, None])[:, 0].to(torch.int64)
        off = idx % ps
        pk[page, off] = k[:, 0].to(pk.dtype)
        pv[page, off] = v[:, 0].to(pv.dtype)
        att = attn_fn(q, pk, pv, bt, cache_pos + 1)
        new_kv = (pk, pv)
    else:
        ck, cv = cache_kv
        if isinstance(cache_pos, int):
            S = k.shape[1]
            ck[:, cache_pos:cache_pos + S] = k.to(ck.dtype)
            cv[:, cache_pos:cache_pos + S] = v.to(cv.dtype)
        else:
            # per-slot: row i writes at its own position; the clamp keeps
            # retired slots in bounds (their rows are dead under kv_len)
            idx = torch.clamp(cache_pos, max=ck.shape[1] - 1).to(torch.int64)
            rows = torch.arange(B, device=x.device)
            ck[rows, idx] = k[:, 0].to(ck.dtype)
            cv[rows, idx] = v[:, 0].to(cv.dtype)
        att = attn_mod.direct_attention(q, ck, cv, causal=False,
                                        kv_len=cache_pos + 1)
        new_kv = (ck, cv)
    out = linear(lp, "wo", att.reshape(B, -1, cfg.attn_dim))
    return x + out, new_kv


def _mlp_block(lp: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    hi = linear(lp, "wi", h)
    if cfg.gated_mlp:
        hg = linear(lp, "wg", h)
        hi = torch.nn.functional.silu(hg.to(torch.float32)).to(hi.dtype) * hi
    else:
        hi = torch.nn.functional.gelu(hi.to(torch.float32),
                                      approximate="tanh").to(hi.dtype)
    return x + linear(lp, "wo_mlp", hi)


def _logits(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rms_norm(x, params["final_norm"], cfg.norm_eps) @ params["lm_head"]


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


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
            peft: PEFTConfig, sites, *, remat: str = "none") -> torch.Tensor:
    """Causal forward over batch["tokens"] (B, S). Returns logits (B, S, V).
    The merge runs once, outside the per-layer checkpoints (as in JAX, where
    it precedes the scanned body)."""
    x = _embed(params, batch["tokens"])
    B, S = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(B, S, x.device)
    eff = apply_peft_to_layers(params["layers"], adapters, sites, peft)

    def body(lp, x):
        x, _ = _attn_block(lp, x, cfg, positions)
        return _mlp_block(lp, x, cfg)

    body = _remat(body, remat)
    for lp in _layers(eff):
        x = body(lp, x)
    return _logits(params, x, cfg)


def loss_fn(params: Dict, adapters: Dict, batch: Dict, cfg: ModelConfig,
            peft: PEFTConfig, sites, *, remat: str = "none") -> torch.Tensor:
    """Mean token cross-entropy of the causal forward against
    batch["labels"] (B, S), f32."""
    logits = forward(params, adapters, batch, cfg, peft, sites, remat=remat)
    return cross_entropy(logits, batch["labels"])


def prefill(params: Dict, adapters: Dict, cache: Dict, batch: Dict,
            cfg: ModelConfig, peft: PEFTConfig, sites) -> Tuple[torch.Tensor, Dict]:
    """Process a (B, S) prompt against a fresh dense cache (pos 0), writing
    its KV in place. Returns (next tokens after the last prompt token, cache
    at pos S). batch["true_len"] (B,), optional: per-row real prompt length
    of right-padded prompts — next tokens are read at true_len - 1."""
    x = _embed(params, batch["tokens"])
    B, S = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(B, S, x.device)
    eff = apply_peft_to_layers(params["layers"], adapters, sites, peft)
    ck_all, cv_all = cache["k"], cache["v"]
    for li, lp in enumerate(_layers(eff)):
        x, (k, v) = _attn_block(lp, x, cfg, positions)
        ck_all[li, :, :S] = k.to(ck_all.dtype)
        cv_all[li, :, :S] = v.to(cv_all.dtype)
        x = _mlp_block(lp, x, cfg)
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


def reset_slots(cache: Dict, mask) -> Dict:
    """Retire slots: masked slots' positions return to 0 (their KV rows are
    left as they are — dead until overwritten, and unreadable meanwhile
    because kv_len masking never reaches them)."""
    pos = cache["pos"]
    if not torch.is_tensor(pos):
        raise ValueError("reset_slots needs a per-slot cache")
    mask = torch.as_tensor(mask, dtype=torch.bool, device=pos.device)
    return {**cache, "pos": torch.where(mask, torch.zeros_like(pos), pos)}


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
                  cfg: ModelConfig, peft: PEFTConfig, sites
                  ) -> Tuple[torch.Tensor, Dict]:
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

    Returns (next_tokens (1,), cache) like `prefill`."""
    x = _embed(params, batch["tokens"])
    B, T = x.shape[0], x.shape[1]
    dev = x.device
    wt = batch.get("window_table")
    prefix_len = int(batch["prefix_len"]) if wt is not None else 0
    positions = _positions(B, T, dev, prefix_len)
    eff = apply_peft_to_layers(params["layers"], adapters, sites, peft)
    bt = batch["block_table"]
    ps = cache["pk"].shape[2]
    cap = bt.shape[1] * ps
    true_len = batch.get("true_len")
    tlen = (true_len[0].to(torch.int64) if true_len is not None
            else torch.tensor(T, dtype=torch.int64, device=dev))
    # scatter targets: tail row j holds logical position prefix_len + j;
    # pad rows (j >= tlen) and overflow land in the slot's scratch page
    j = torch.arange(T, device=dev)
    logical = prefix_len + j
    valid = (j < tlen) & (logical < cap)
    safe = torch.where(valid, logical, torch.zeros_like(logical))
    w_page = torch.where(valid, bt[0].to(torch.int64)[safe // ps],
                         torch.full_like(j, int(batch["scratch_page"])))
    w_off = torch.where(valid, safe % ps, j % ps)
    for li, lp in enumerate(_layers(eff)):
        q, k, v = _qkv(lp, x, cfg, positions)
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
            att = attn_mod.attention(q, k, v, causal=True)
        x = x + linear(lp, "wo", att.reshape(B, -1, cfg.attn_dim))
        # pad rows may collide inside the scratch page — dirt either way
        pk[w_page, w_off] = k[0].to(pk.dtype)
        pv[w_page, w_off] = v[0].to(pv.dtype)
        x = _mlp_block(lp, x, cfg)
    x = x[:, tlen - 1][:, None]
    next_tokens = _greedy(_logits(params, x, cfg))
    pos = cache["pos"]
    pos[int(batch["slot"])] = prefix_len + tlen.to(pos.dtype)
    return next_tokens, cache


def decode_logits(params: Dict, adapters: Dict, cache: Dict, batch: Dict,
                  cfg: ModelConfig, peft: PEFTConfig, sites
                  ) -> Tuple[torch.Tensor, Dict]:
    """One token for every sequence: batch["tokens"] (B, 1). Returns
    (logits (B, 1, V), cache with pos + 1); the cache is written in place.

    A paged cache ("pk"/"pv" pools) takes batch["block_table"]
    (B, pages_per_seq); its attention is the registry-resolved
    `paged_attention` op for the cache's device."""
    x = _embed(params, batch["tokens"])
    B = x.shape[0]
    pos = cache["pos"]
    if torch.is_tensor(pos):            # per-slot cache: row i sits at pos[i]
        positions = pos.to(torch.int32)[:, None]
    else:
        positions = _positions(B, 1, x.device, pos)
    eff = apply_peft_to_layers(params["layers"], adapters, sites, peft)
    paged = None
    if "pk" in cache:
        from repro_torch.kernels import paged_attention as paged_mod
        op = kernel_api.resolve_op(
            "paged_attention", paged_mod.OWNER, peft,
            d1=cache["pk"].shape[2], d2=cfg.head_dim, device=x.device)
        paged = (batch["block_table"], op.fn)
    kk, vk = ("pk", "pv") if paged is not None else ("k", "v")
    for li, lp in enumerate(_layers(eff)):
        x, _ = _attn_block(lp, x, cfg, positions,
                           cache_kv=(cache[kk][li], cache[vk][li]),
                           cache_pos=pos, paged=paged)
        x = _mlp_block(lp, x, cfg)
    return _logits(params, x, cfg), {kk: cache[kk], vk: cache[vk],
                                     "pos": pos + 1}


def decode_step(params: Dict, adapters: Dict, cache: Dict, batch: Dict,
                cfg: ModelConfig, peft: PEFTConfig, sites
                ) -> Tuple[torch.Tensor, Dict]:
    """Greedy `decode_logits`: (next_tokens (B,) int32, cache)."""
    logits, cache = decode_logits(params, adapters, cache, batch, cfg, peft,
                                  sites)
    return _greedy(logits), cache
