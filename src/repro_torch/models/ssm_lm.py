"""Pure-SSM LM (mamba2-2.7b): embedding -> mamba2 blocks -> head, the JAX
package's `models/ssm_lm.py` with its layer scan as a Python loop.

FourierFT targets the in/out projections (wx / wo_ssm): the architecture
has no attention, so the paper's q/v set does not apply
(`registry.resolve_default_targets`). The merged strategy folds their ΔW
before the layer loop (K1 on the card), the factored one applies them
inside each block, and the serving adapter bank gathers its rows once per
call, as in the transformer. The decode cache (conv history and SSM state
per layer) is written in place, layer by layer. There is no per-slot
cache: the recurrent state cannot be masked per slot, so serving is
lockstep (`Engine`), and prefill is a loop of decode steps
(`registry.Model.prefill`).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, PEFTConfig
from repro_torch.core.adapter import torch_dtype
from repro_torch.models import mamba2
from repro_torch.models.common import cross_entropy, dense_init
from repro_torch.models.transformer import (_effective, _greedy, _logits,
                                            _lookup, _remat,
                                            activation_anchor)


def init_params(gen: torch.Generator, cfg: ModelConfig, device) -> Dict:
    dtype = torch_dtype(cfg.param_dtype)
    return {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), dtype, device),
        "layers": mamba2.init_mamba_params(gen, cfg, cfg.num_layers, dtype,
                                           device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "lm_head": dense_init(gen, (cfg.d_model, cfg.vocab), dtype, device),
    }


def forward(params: Dict, adapters: Dict, batch: Dict, cfg: ModelConfig,
            peft: PEFTConfig, sites, *, remat: str = "none", bank=None,
            bank_profiles=None,
            constrain=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (logits (B, S, V), a zero aux loss). `remat` checkpoints each
    block."""
    x = _lookup(params["embed"], batch["tokens"])
    layers, linear = _effective(params, adapters, sites, peft, batch, bank,
                                bank_profiles, constrain)

    act = activation_anchor(constrain)

    def body(lp, x):
        return act(mamba2.mamba_block(lp, act(x), cfg, linear_fn=linear))

    body = _remat(body, remat)
    x = act(x)
    for lp in layers:
        x = body(lp, x)
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
    """The lockstep cache: conv history and SSM state per layer (no KV,
    so `max_len` sizes nothing) and the int position."""
    cache = mamba2.init_mamba_cache(cfg, cfg.num_layers, batch, dtype, device)
    cache["pos"] = 0
    return cache


def decode_logits(params: Dict, adapters: Dict, cache: Dict, batch: Dict,
                  cfg: ModelConfig, peft: PEFTConfig, sites, bank=None,
                  bank_profiles=None,
                  constrain=None) -> Tuple[torch.Tensor, Dict]:
    """One token per sequence, batch["tokens"] (B, 1) -> (logits (B, 1, V),
    cache at pos + 1), the cache written in place."""
    x = _lookup(params["embed"], batch["tokens"])             # (B, 1, d)
    layers, linear = _effective(params, adapters, sites, peft, batch, bank,
                                bank_profiles, constrain)
    conv_all, ssm_all = cache["conv"], cache["ssm"]
    act = activation_anchor(constrain)
    for li, lp in enumerate(layers):
        x, new = mamba2.mamba_decode_step(
            lp, {"conv": conv_all[li], "ssm": ssm_all[li]}, act(x), cfg,
            linear_fn=linear)
        conv_all[li] = new["conv"]
        ssm_all[li] = new["ssm"]
    return _logits(params, x, cfg), {"conv": conv_all, "ssm": ssm_all,
                                     "pos": cache["pos"] + 1}


def decode_step(params: Dict, adapters: Dict, cache: Dict, batch: Dict,
                cfg: ModelConfig, peft: PEFTConfig, sites, bank=None,
                bank_profiles=None,
                constrain=None) -> Tuple[torch.Tensor, Dict]:
    """Greedy `decode_logits`: (next tokens (B,) int32, cache)."""
    logits, cache = decode_logits(params, adapters, cache, batch, cfg, peft,
                                  sites, bank, bank_profiles, constrain)
    return _greedy(logits), cache
