"""A configuration file of the benchmark as the measured program's
`ModelConfig` and `PEFTConfig`.

The file holds the published keys (HF `config.json` names) at its top
level and, under `model`, how the program runs them: fields of its
`ModelConfig` by name (`family`, `head_dim`, `qk_norm`, ...). Every
published key the program has a field for is carried over, so the model
runs at the published sizes; a key the program cannot honour, or that
the benchmark's weights and reference do not cover (experts, qk-norm), is
refused here.
"""
from __future__ import annotations

from typing import Dict

# published key -> the program's ModelConfig field
FIELDS = {
    "num_hidden_layers": "num_layers",
    "hidden_size": "d_model",
    "vocab_size": "vocab",
    "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv",
    "intermediate_size": "d_ff",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings",
    "attention_bias": "qkv_bias",
}


def model_config(cfg: Dict):
    from repro_torch.configs.base import ModelConfig
    if cfg.get("hidden_act", "silu") != "silu":
        raise ValueError(f"{cfg['name']}: the program's gated MLP is SiLU, "
                         f"not {cfg['hidden_act']}")
    if cfg.get("num_experts") or cfg.get("model", {}).get("qk_norm"):
        raise ValueError(f"{cfg['name']}: the benchmark makes and checks a "
                         "dense decoder without qk-norm")
    kw = {field: cfg[key] for key, field in FIELDS.items() if key in cfg}
    kw.update(cfg.get("model", {}))
    kw.setdefault("head_dim", cfg["hidden_size"] // cfg["num_attention_heads"])
    return ModelConfig(name=cfg["name"], **kw)


def peft_config(cfg: Dict, **kw):
    from repro_torch.configs.base import PEFTConfig
    ad = cfg["adapter"]
    return PEFTConfig(method=ad["method"], n=ad["n"], alpha=ad["alpha"],
                      entry_seed=ad["entry_seed"],
                      target_modules=tuple(ad["target_modules"]), **kw)


def adapted_sites(cfg: Dict):
    """[(site name, d_in, d_out, layers)] of the adapter's targets, from the
    file's sizes."""
    H = cfg["num_attention_heads"]
    hd = cfg.get("model", {}).get("head_dim", cfg["hidden_size"] // H)
    K = cfg.get("num_key_value_heads", H)
    out_dim = {"wq": H * hd, "wk": K * hd, "wv": K * hd}
    return [(f"layers/{t}", cfg["hidden_size"], out_dim[t],
             cfg["num_hidden_layers"])
            for t in cfg["adapter"]["target_modules"]]
