"""A dense decoder with per-head RMSNorm on q and k before RoPE (Qwen3's
attention; the program runs it as `ModelConfig(qk_norm=True)`), on the
harness's side. Its sizes, adapted sites and required operations are the
decoder family's; its layout adds each layer's two norm weights; its
configuration has to state `qk_norm`. Its plain model is
perfbench/reference/decoder-qknorm.py.

A family written as new files alone: it takes the decoder family's module
by path from the same root, as the harness does.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

from harness import spec

DECODER = spec.family({"reference": "decoder"},
                      Path(__file__).resolve().parents[2])

adapted_sites = DECODER.adapted_sites
attention_shape = DECODER.attention_shape
train_step_ops = DECODER.train_step_ops
prefill_ops = DECODER.prefill_ops
decode_ops = DECODER.decode_ops


def head_dim(cfg: Dict) -> int:
    H = cfg["num_attention_heads"]
    return cfg.get("model", {}).get("head_dim", cfg["hidden_size"] // H)


def model_config(cfg: Dict):
    from repro_torch.configs.base import ModelConfig
    if cfg.get("hidden_act", "silu") != "silu" or cfg.get("num_experts"):
        raise ValueError(f"{cfg['name']}: the benchmark makes and checks a "
                         "dense SiLU decoder")
    if not cfg.get("model", {}).get("qk_norm"):
        raise ValueError(f"{cfg['name']}: this family's configuration "
                         "states qk_norm")
    kw = {field: cfg[key] for key, field in DECODER.FIELDS.items()
          if key in cfg}
    kw.update(cfg["model"])
    kw.setdefault("head_dim", head_dim(cfg))
    return ModelConfig(name=cfg["name"], **kw)


def base_layout(cfg: Dict) -> Dict[str, tuple]:
    layout = dict(DECODER.base_layout(cfg))
    shape = (cfg["num_hidden_layers"], head_dim(cfg))
    layout["layers/q_norm"] = (shape, "ones")
    layout["layers/k_norm"] = (shape, "ones")
    return layout
