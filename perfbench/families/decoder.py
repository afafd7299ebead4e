"""The dense decoder family on the harness's side: how a configuration file
of it becomes the measured program's `ModelConfig`, which weights it
adapts, the layout of the base weights the benchmark makes for it, and the
operations its steps require. Its plain model is
`perfbench/reference/decoder.py`.

The file holds the published keys (HF `config.json` names) at its top
level and, under `model`, how the program runs them: fields of its
`ModelConfig` by name (`family`, `head_dim`, `qk_norm`, ...). Every
published key the program has a field for is carried over, so the model
runs at the published sizes; a key the program cannot honour, or that
the benchmark's weights and reference do not cover (experts, qk-norm), is
refused here.

Required operations of a decoder (per the benchmark's definition): the
matrix products of the forward (2 operations per multiply-add), the
backward's products for the activation gradients (as many again), and
attention counted causal: 2·H·hd·S² operations a layer and sequence
forward (QKᵀ and PV over the lower triangle), twice that backward.
Recomputation, the frozen base's weight gradients (the adapted weights'
too) and the adapter's own ΔW transforms are not counted.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

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


def base_layout(cfg: Dict) -> Dict[str, tuple]:
    """{leaf path: (shape, kind)} of the base weights, kind normal (the
    served type) or ones."""
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    K = cfg.get("num_key_value_heads", H)
    hd = cfg.get("model", {}).get("head_dim", d // H)
    V, f = cfg["vocab_size"], cfg["intermediate_size"]
    return {
        "layers/attn_norm": ((L, d), "ones"),
        "layers/wq": ((L, d, H * hd), "normal"),
        "layers/wk": ((L, d, K * hd), "normal"),
        "layers/wv": ((L, d, K * hd), "normal"),
        "layers/wo": ((L, H * hd, d), "normal"),
        "layers/mlp_norm": ((L, d), "ones"),
        "layers/wi": ((L, d, f), "normal"),
        "layers/wg": ((L, d, f), "normal"),
        "layers/wo_mlp": ((L, f, d), "normal"),
        "final_norm": ((d,), "ones"),
        "embed": ((V, d), "normal"),
        "lm_head": ((d, V), "normal"),
    }


def attention_shape(cfg: Dict, batch: int, seq: int
                    ) -> Optional[Tuple[int, int, int, int, int]]:
    """(B, S, H, K, hd) of one causal attention call over batch x seq
    tokens: one a layer in the forward, its recompute and its backward."""
    H = cfg["num_attention_heads"]
    hd = cfg.get("model", {}).get("head_dim", cfg["hidden_size"] // H)
    return batch, seq, H, cfg.get("num_key_value_heads", H), hd


def matmul_params_per_token(cfg: Dict) -> Dict[str, int]:
    """Multiply-adds a token costs in each group of the model's matrices:
    attention projections, the gated MLP over all layers, and the output
    head."""
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    K = cfg.get("num_key_value_heads", H)
    hd = cfg.get("model", {}).get("head_dim", d // H)
    f = cfg["intermediate_size"]
    attn = d * H * hd * 2 + d * K * hd * 2
    return {"attention": L * attn, "mlp": L * 3 * d * f,
            "head": d * cfg["vocab_size"]}


def attention_core(cfg: Dict) -> int:
    """H·hd·L: causal attention's forward costs 2·this·S² a sequence."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = cfg.get("model", {}).get("head_dim", d // H)
    return H * hd * cfg["num_hidden_layers"]


def train_step_ops(cfg: Dict, batch: int, seq: int) -> float:
    """Required operations of one training step of batch x seq tokens."""
    p = sum(matmul_params_per_token(cfg).values())
    fwd = 2.0 * p * batch * seq + 2.0 * attention_core(cfg) * seq ** 2 \
        * batch
    mm_bwd = 2.0 * p * batch * seq
    attn_bwd = 2.0 * (2.0 * attention_core(cfg) * seq ** 2 * batch)
    return fwd + mm_bwd + attn_bwd


def prefill_ops(cfg: Dict, length: int) -> float:
    """A prompt of `length` tokens: every layer over every token, causal
    attention, the head for the one next token."""
    m = matmul_params_per_token(cfg)
    return (2.0 * (m["attention"] + m["mlp"]) * length + 2.0 * m["head"]
            + 2.0 * attention_core(cfg) * length ** 2)


def decode_ops(cfg: Dict, kv_lens: Iterable[int]) -> float:
    """One decode token for each of the given kv lengths (the token's own
    row included)."""
    p = sum(matmul_params_per_token(cfg).values())
    kv = list(kv_lens)
    return 2.0 * p * len(kv) + 4.0 * attention_core(cfg) * sum(kv)
