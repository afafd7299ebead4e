"""Zamba2-style hybrid: mamba2 blocks with ONE shared transformer block
(attention + MLP) applied before every group of `shared_every` mamba
blocks, the JAX package's `models/zamba2.py` with its nested scans as
Python loops. A trailing partial group handles L % shared_every != 0
(zamba2-7b: 81 = 13·6 + 3, so 14 shared applications).

Adapters: the mamba layers' sites (`layers/wx`, `layers/wo_ssm`) merge or
apply factored like the transformer's; the shared block's sites
(`shared/wq`, `shared/wv`, stacked over the applications) are ALWAYS
factored, one coefficient row per application (materializing W + ΔW per
application would defeat the weight sharing). `merge_for_serving` leaves
them under their true method. The serving adapter bank rides the mamba
sites only.

The shared block is the transformer's attention and MLP blocks on the
shared weights: RoPE, then `attention.attention` over the full sequence
(flash above 1024 rows); decode attends its dense per-application cache
with `direct_attention(..., kv_len=pos + 1)`. `remat` checkpoints a whole
group (the shared block and its mamba blocks), as JAX's
`_remat(group_body)` does; the tail group runs unchecked, as in JAX.

Zamba2 as published (`ModelConfig.zamba` a `Zamba2Published`; HF
transformers' `Zamba2ForCausalLM` in `modeling_zamba2.py`): with h the
residual stream, e the embeddings and b = j mod `num_mem_blocks` the block
of application j (before hybrid layer i = `hybrid_layer_ids[j]`),

    u   = RMSNorm_b(concat[h, e])                      (width 2·d)
    a   = softmax(q kᵀ · (head_dim / 2) ** -0.5 + causal) v · Wo_b,
          q, k, v = u · Wq_b, u · Wk_b, u · Wv_b, RoPE over head_dim
    m   = RMSNorm'_b(a)
    g   = m · Wg_b + (m · A_j) · B_j[:, :f]
    up  = m · Wi_b + (m · A_j) · B_j[:, f:]
    s_j = ((GELU_erf(g) ⊙ up) · Wo_mlp_b) · Lin_j
    h  <- h + Mamba_i(RMSNorm_i(h + s_j))    (s_j only at layer i)

and the mamba layers' gated norm grouped by `ssm.n_groups`; the logits
take the embedding's transpose when the embeddings are tied. The block
has no residual of its own. The shared sites `shared/wq` / `shared/wv`
(d_in 2·d) are factored, one row per application, as above; the
per-application LoRA (`apps/mlp_lora_a`, `apps/mlp_lora_b`) and `linear`
(`apps/linear`) are base weights. Forward groups: the layers before the
first hybrid layer, then each hybrid layer with its application and the
layers up to the next; `remat` checkpoints every group. Decode keeps one
dense KV cache per application. Under a profiler each application lies in
the ranges `layer` and `shared`, each mamba layer in `layer`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, PEFTConfig, Zamba2Published
from repro_torch.core import adapter as adapter_api
from repro_torch.core.adapter import torch_dtype
from repro_torch.core.spans import span
from repro_torch.models import mamba2
from repro_torch.models.common import cross_entropy, dense_init, rms_norm
from repro_torch.models.transformer import (SiteApp, _app_tag, _attn_block,
                                            _attn_out, _effective, _greedy,
                                            _logits, _lookup, _mlp_block,
                                            _positions, _remat,
                                            activation_anchor, make_linear)


def _split(cfg: ModelConfig) -> Tuple[int, int]:
    every = cfg.zamba.shared_every
    return cfg.num_layers // every, cfg.num_layers % every


def published(cfg: ModelConfig) -> bool:
    """Whether `cfg` is Zamba2 as published (module docstring)."""
    return isinstance(cfg.zamba, Zamba2Published)


def n_apps(cfg: ModelConfig) -> int:
    if published(cfg):
        return len(cfg.zamba.hybrid_layer_ids)
    n_full, tail = _split(cfg)
    return n_full + (1 if tail else 0)


def shared_width(cfg: ModelConfig) -> int:
    """The shared block's input width: the residual stream, beside it the
    embeddings in the published block."""
    return 2 * cfg.d_model if published(cfg) else cfg.d_model


def init_params(gen: torch.Generator, cfg: ModelConfig, device) -> Dict:
    dtype = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    if published(cfg):
        return _init_published(gen, cfg, device, dtype)

    def init(shape):
        return dense_init(gen, shape, dtype, device)

    shared = {
        "attn_norm": torch.ones((d,), dtype=dtype, device=device),
        "wq": init((d, cfg.attn_dim)),
        "wk": init((d, cfg.kv_dim)),
        "wv": init((d, cfg.kv_dim)),
        "wo": init((cfg.attn_dim, d)),
        "mlp_norm": torch.ones((d,), dtype=dtype, device=device),
        "wi": init((d, cfg.d_ff)),
        "wg": init((d, cfg.d_ff)),
        "wo_mlp": init((cfg.d_ff, d)),
    }
    return {
        "embed": init((cfg.vocab, d)),
        "layers": mamba2.init_mamba_params(gen, cfg, cfg.num_layers, dtype,
                                           device),
        "shared": shared,
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
        "lm_head": init((d, cfg.vocab)),
    }


def _shared_adapter_rows(adapters: Dict, peft: PEFTConfig):
    """-> ({tagged key: stacked rows (napps, ...)}, `make_linear` apps).

    The shared sites stay factored whatever the method: the trainable
    leaves ride a per-application row under `{key}{tag}{leaf}`, the frozen
    aux (entries, and their tables when built) rides the SiteApp."""
    method = adapter_api.resolve(peft.method)
    tag = _app_tag("ad", method.name)
    trainable = set(method.trainable_leaves(peft))
    rows: Dict[str, torch.Tensor] = {}
    apps: Dict[str, List[SiteApp]] = {}
    for full_name, ad in adapters.items():
        if not full_name.startswith("shared/"):
            continue
        key = full_name.split("/")[-1]
        aux = {}
        for leaf, v in ad.items():
            if leaf in trainable:
                rows[key + tag + leaf] = v
            else:
                aux[leaf] = v
        apps.setdefault(key, []).append(SiteApp(tag, method, aux, peft))
    return rows, apps


def _shared_block(x, shared: Dict, ad_row: Dict, linear, cfg: ModelConfig,
                  positions, cache_kv=None, cache_pos: int = 0,
                  act=lambda t: t):
    """The shared attention + MLP on application `ad_row`'s adapter row.
    With `cache_kv` (that application's (k, v) cache) it is the lockstep
    decode, writing the new rows in place. `act` anchors the residual
    between the two (`transformer.activation_anchor`)."""
    lp = {**shared, **ad_row}
    x, _ = _attn_block(lp, x, cfg, linear, positions, cache_kv=cache_kv,
                       cache_pos=cache_pos)
    x, _ = _mlp_block(lp, act(x), cfg, linear)
    return x


def _group_views(cfg: ModelConfig, layers: List[Dict]):
    """Per-layer views split into the full groups (n_full lists of
    `shared_every` layers) and the tail (None without one)."""
    n_full, tail_len = _split(cfg)
    every = cfg.zamba.shared_every
    main = [layers[g * every:(g + 1) * every] for g in range(n_full)]
    tail = layers[n_full * every:] if tail_len else None
    return main, tail


def _row_views(cfg: ModelConfig, rows: Dict) -> Tuple[List[Dict],
                                                     Optional[Dict]]:
    """Per-application adapter rows: the full groups' and the tail's."""
    n_full, tail_len = _split(cfg)
    cols = {k: v.unbind(0) for k, v in rows.items()}
    main = [{k: c[g] for k, c in cols.items()} for g in range(n_full)]
    tail = {k: c[n_full] for k, c in cols.items()} if tail_len else None
    return main, tail


def _parts(params: Dict, adapters: Dict, batch: Dict, cfg: ModelConfig,
           peft: PEFTConfig, sites, bank, bank_profiles, constrain=None):
    """(mamba groups, mamba tail, their linear, application rows, tail row,
    the shared block's linear) for one call: the mamba sites merged or
    applied (and the bank's rows gathered), the shared rows split."""
    mamba_adapters = {k: v for k, v in adapters.items()
                      if k.startswith("layers/")}
    layers, linear = _effective(params, mamba_adapters, sites, peft, batch,
                                bank, bank_profiles, constrain)
    rows, shared_apps = _shared_adapter_rows(adapters, peft)
    main, tail = _group_views(cfg, layers)
    main_rows, tail_row = _row_views(cfg, rows)
    return main, tail, linear, main_rows, tail_row, make_linear(shared_apps)


def forward(params: Dict, adapters: Dict, batch: Dict, cfg: ModelConfig,
            peft: PEFTConfig, sites, *, remat: str = "none", bank=None,
            bank_profiles=None,
            constrain=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (logits (B, S, V), a zero aux loss)."""
    if published(cfg):
        return _published_forward(params, adapters, batch, cfg, peft, sites,
                                   remat, bank, bank_profiles, constrain)
    x = _lookup(params["embed"], batch["tokens"])
    B, S = x.shape[0], x.shape[1]
    positions = _positions(B, S, x.device)
    main, tail, linear, main_rows, tail_row, shared_linear = _parts(
        params, adapters, batch, cfg, peft, sites, bank, bank_profiles,
        constrain)
    shared = params["shared"]
    act = activation_anchor(constrain)

    def group_body(x, group, ad_row):
        x = _shared_block(act(x), shared, ad_row, shared_linear, cfg,
                          positions, act=act)
        for lp in group:
            x = act(mamba2.mamba_block(lp, act(x), cfg, linear_fn=linear))
        return act(x)

    body = _remat(group_body, remat)
    for group, ad_row in zip(main, main_rows):
        x = body(x, group, ad_row)
    if tail is not None:
        x = group_body(x, tail, tail_row)
    return (_logits(params, x, cfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


def loss_fn(params: Dict, adapters: Dict, batch: Dict, cfg: ModelConfig,
            peft: PEFTConfig, sites, *, remat: str = "none",
            constrain=None) -> torch.Tensor:
    logits, _ = forward(params, adapters, batch, cfg, peft, sites,
                        remat=remat, constrain=constrain)
    return cross_entropy(logits, batch["labels"])


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device) -> Dict:
    """The mamba layers' conv and SSM caches, one dense KV cache per
    shared application, attn_k / attn_v (A, B, max_len, K, dh), and the
    int position."""
    cache = mamba2.init_mamba_cache(cfg, cfg.num_layers, batch, dtype, device)
    shape = (n_apps(cfg), batch, max_len, cfg.n_kv, cfg.head_dim)
    cache["attn_k"] = torch.zeros(shape, dtype=dtype, device=device)
    cache["attn_v"] = torch.zeros(shape, dtype=dtype, device=device)
    cache["pos"] = 0
    return cache


def decode_logits(params: Dict, adapters: Dict, cache: Dict, batch: Dict,
                  cfg: ModelConfig, peft: PEFTConfig, sites, bank=None,
                  bank_profiles=None,
                  constrain=None) -> Tuple[torch.Tensor, Dict]:
    """One token per sequence, batch["tokens"] (B, 1) -> (logits (B, 1, V),
    cache at pos + 1); every cache is written in place."""
    if published(cfg):
        return _published_decode(params, adapters, cache, batch, cfg, peft,
                                 sites, bank, bank_profiles, constrain)
    x = _lookup(params["embed"], batch["tokens"])             # (B, 1, d)
    pos = cache["pos"]
    positions = _positions(x.shape[0], 1, x.device, pos)
    main, tail, linear, main_rows, tail_row, shared_linear = _parts(
        params, adapters, batch, cfg, peft, sites, bank, bank_profiles,
        constrain)
    conv_all, ssm_all = cache["conv"], cache["ssm"]
    ck_all, cv_all = cache["attn_k"], cache["attn_v"]
    act = activation_anchor(constrain)
    groups = list(zip(main, main_rows))
    if tail is not None:
        groups.append((tail, tail_row))
    li = 0
    for gi, (group, ad_row) in enumerate(groups):
        x = _shared_block(act(x), params["shared"], ad_row, shared_linear,
                          cfg, positions, cache_kv=(ck_all[gi], cv_all[gi]),
                          cache_pos=pos, act=act)
        for lp in group:
            x, new = mamba2.mamba_decode_step(
                lp, {"conv": conv_all[li], "ssm": ssm_all[li]}, act(x), cfg,
                linear_fn=linear)
            conv_all[li] = new["conv"]
            ssm_all[li] = new["ssm"]
            li += 1
    return _logits(params, x, cfg), {"conv": conv_all, "ssm": ssm_all,
                                     "attn_k": ck_all, "attn_v": cv_all,
                                     "pos": pos + 1}


def decode_step(params: Dict, adapters: Dict, cache: Dict, batch: Dict,
                cfg: ModelConfig, peft: PEFTConfig, sites, bank=None,
                bank_profiles=None,
                constrain=None) -> Tuple[torch.Tensor, Dict]:
    """Greedy `decode_logits`: (next tokens (B,) int32, cache)."""
    logits, cache = decode_logits(params, adapters, cache, batch, cfg, peft,
                                  sites, bank, bank_profiles, constrain)
    return _greedy(logits), cache


# ---------------------------------------------------------------------------
# Zamba2 as published (module docstring)
# ---------------------------------------------------------------------------

def _init_published(gen: torch.Generator, cfg: ModelConfig, device,
                    dtype) -> Dict:
    """The blocks' weights stacked over `num_mem_blocks` under `shared`,
    each application's LoRA and linear stacked over the applications under
    `apps`; no `lm_head` with tied embeddings."""
    z = cfg.zamba
    d, w, f, M, A = (cfg.d_model, shared_width(cfg), cfg.d_ff,
                     z.num_mem_blocks, n_apps(cfg))

    def init(shape):
        return dense_init(gen, shape, dtype, device)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    shared = {
        "attn_norm": ones((M, w)),
        "wq": init((M, w, cfg.attn_dim)),
        "wk": init((M, w, cfg.kv_dim)),
        "wv": init((M, w, cfg.kv_dim)),
        "wo": init((M, cfg.attn_dim, d)),
        "mlp_norm": ones((M, d)),
        "wi": init((M, d, f)),
        "wg": init((M, d, f)),
        "wo_mlp": init((M, f, d)),
    }
    apps = {"mlp_lora_a": init((A, d, z.adapter_rank)),
            "mlp_lora_b": init((A, z.adapter_rank, 2 * f)),
            "linear": init((A, d, d))}
    params = {
        "embed": init((cfg.vocab, d)),
        "layers": mamba2.init_mamba_params(gen, cfg, cfg.num_layers, dtype,
                                           device),
        "shared": shared,
        "apps": apps,
        "final_norm": ones((d,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init((d, cfg.vocab))
    return params


def _published_groups(cfg: ModelConfig) -> List[Tuple[Optional[int],
                                                        List[int]]]:
    """[(application or None, its group's layers)]: the layers before the
    first hybrid layer (no application), then each hybrid layer with its
    application and the layers up to the next one."""
    ids = list(cfg.zamba.hybrid_layer_ids)
    bounds = sorted({0, *ids, cfg.num_layers})
    return [(ids.index(a) if a in ids else None, list(range(a, b)))
            for a, b in zip(bounds, bounds[1:])]


def _unstack(tree: Dict, n: int) -> List[Dict]:
    cols = {k: v.unbind(0) for k, v in tree.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def _published_parts(params: Dict, adapters: Dict, batch: Dict,
                     cfg: ModelConfig, peft: PEFTConfig, sites, bank,
                     bank_profiles, constrain):
    """(mamba layer views, their linear, block views, per-application
    views (adapter rows, LoRA, linear), the shared block's linear)."""
    mamba_adapters = {k: v for k, v in adapters.items()
                      if k.startswith("layers/")}
    layers, linear = _effective(params, mamba_adapters, sites, peft, batch,
                                bank, bank_profiles, constrain)
    rows, shared_apps = _shared_adapter_rows(adapters, peft)
    A = n_apps(cfg)
    apps = [{**r, **a} for r, a in zip(_unstack(rows, A),
                                        _unstack(params["apps"], A))]
    blocks = _unstack(params["shared"], cfg.zamba.num_mem_blocks)
    return layers, linear, blocks, apps, make_linear(shared_apps)


def _application(x, e, block: Dict, app: Dict, linear, cfg: ModelConfig,
                 positions, cache_kv=None, cache_pos: int = 0):
    """s_j of one application (module docstring) on `block`'s weights and
    the application's own rows; with `cache_kv` (its (k, v) cache) the
    lockstep decode, writing the new rows in place."""
    with span("shared") as sp:
        lp = {**block, **app}
        u = torch.cat([x, e], dim=-1)
        a, _ = _attn_out(lp, u, cfg, linear, positions, cache_kv=cache_kv,
                        cache_pos=cache_pos,
                        scale=(cfg.head_dim / 2) ** -0.5)
        m = rms_norm(a, lp["mlp_norm"], cfg.norm_eps)
        lo = (m @ lp["mlp_lora_a"]) @ lp["mlp_lora_b"]
        g = linear(lp, "wg", m) + lo[..., :cfg.d_ff]
        up = linear(lp, "wi", m) + lo[..., cfg.d_ff:]
        hid = torch.nn.functional.gelu(g.to(torch.float32)).to(up.dtype) * up
        s = linear(lp, "wo_mlp", hid) @ lp["linear"]
        sp.backward(s)
    return s


def _published_forward(params: Dict, adapters: Dict, batch: Dict,
                       cfg: ModelConfig, peft: PEFTConfig, sites, remat: str,
                       bank, bank_profiles, constrain):
    e = _lookup(params["embed"], batch["tokens"])
    B, S = e.shape[0], e.shape[1]
    positions = _positions(B, S, e.device)
    layers, linear, blocks, apps, shared_linear = _published_parts(
        params, adapters, batch, cfg, peft, sites, bank, bank_profiles,
        constrain)
    act = activation_anchor(constrain)
    M, G = cfg.zamba.num_mem_blocks, cfg.ssm.n_groups

    def group_body(x, e, j, group):
        s = None
        if j is not None:
            # remat re-enters both ranges when it recomputes the group
            with span("layer"):
                s = _application(act(x), e, blocks[j % M], apps[j],
                                 shared_linear, cfg, positions)
        for lp in group:
            with span("layer"):
                x = act(mamba2.mamba_block(lp, act(x), cfg, linear_fn=linear,
                                           add=s, norm_groups=G))
            s = None
        return x

    body = _remat(group_body, remat)
    x = act(e)
    for j, ids in _published_groups(cfg):
        x = body(x, e, j, [layers[i] for i in ids])
    return (_logits(params, x, cfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _published_decode(params: Dict, adapters: Dict, cache: Dict,
                      batch: Dict, cfg: ModelConfig, peft: PEFTConfig, sites,
                      bank, bank_profiles, constrain):
    e = _lookup(params["embed"], batch["tokens"])             # (B, 1, d)
    pos = cache["pos"]
    positions = _positions(e.shape[0], 1, e.device, pos)
    layers, linear, blocks, apps, shared_linear = _published_parts(
        params, adapters, batch, cfg, peft, sites, bank, bank_profiles,
        constrain)
    conv_all, ssm_all = cache["conv"], cache["ssm"]
    ck_all, cv_all = cache["attn_k"], cache["attn_v"]
    act = activation_anchor(constrain)
    M, G = cfg.zamba.num_mem_blocks, cfg.ssm.n_groups
    x = e
    for j, ids in _published_groups(cfg):
        s = None
        if j is not None:
            s = _application(act(x), e, blocks[j % M], apps[j],
                             shared_linear, cfg, positions,
                             cache_kv=(ck_all[j], cv_all[j]), cache_pos=pos)
        for li in ids:
            x, new = mamba2.mamba_decode_step(
                layers[li], {"conv": conv_all[li], "ssm": ssm_all[li]},
                act(x), cfg, linear_fn=linear, add=s, norm_groups=G)
            conv_all[li] = new["conv"]
            ssm_all[li] = new["ssm"]
            s = None
    return _logits(params, act(x), cfg), {
        "conv": conv_all, "ssm": ssm_all, "attn_k": ck_all,
        "attn_v": cv_all, "pos": pos + 1}
