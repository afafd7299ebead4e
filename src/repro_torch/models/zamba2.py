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
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, PEFTConfig
from repro_torch.core import adapter as adapter_api
from repro_torch.core.adapter import torch_dtype
from repro_torch.models import mamba2
from repro_torch.models.common import cross_entropy, dense_init
from repro_torch.models.transformer import (SiteApp, _app_tag, _attn_block,
                                            _effective, _greedy, _logits,
                                            _lookup, _mlp_block, _positions,
                                            _remat, activation_anchor,
                                            make_linear)


def _split(cfg: ModelConfig) -> Tuple[int, int]:
    every = cfg.zamba.shared_every
    return cfg.num_layers // every, cfg.num_layers % every


def n_apps(cfg: ModelConfig) -> int:
    n_full, tail = _split(cfg)
    return n_full + (1 if tail else 0)


def init_params(gen: torch.Generator, cfg: ModelConfig, device) -> Dict:
    dtype = torch_dtype(cfg.param_dtype)
    d = cfg.d_model

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
