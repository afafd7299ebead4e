"""The Zamba2 hybrid family on the harness's side: how a configuration file
of Zamba2 as published (HF `Zamba2ForCausalLM`'s `config.json` keys)
becomes the measured program's `ModelConfig` (the hybrid family with
`Zamba2Published` wiring), which weights it adapts, the layout of the base
weights the benchmark makes for it, and the operations its steps require.
Its plain model is `perfbench/reference/zamba2.py`.

The file holds the published keys at its top level and, under `model`,
the program's numeric types. Every published key that shapes the model is
carried over; one the program or the reference does not follow (an
attention adapter, memory blocks without RoPE, a long-context RoPE, biased
linears, another activation, a clamped dt) is refused here.

Required operations of a step (the decoder family's convention): the
matrix products of the forward (2 operations per multiply-add: the mamba
layers' projections, each application's q/k/v/o, gate/up, LoRA, down and
linear, the tied head), as many again backward for the activation
gradients; causal attention 2·H·hd·S² an application and sequence
forward, twice that backward; the SSD scan's operations (`ssd_ops`) a
layer forward, twice that backward. Recomputation, the frozen base's
weight gradients and the adapter's own ΔW transforms and factored products
are not counted.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

# published key -> the value the program and the reference require
REQUIRED = {"hidden_act": "gelu", "use_shared_attention_adapter": False,
            "use_mem_rope": True, "use_long_context": False,
            "add_bias_linear": False, "use_conv_bias": True,
            "time_step_limit": None, "rms_norm_eps": 1e-05,
            "use_shared_mlp_adapter": True, "model_type": "zamba2"}


def _check(cfg: Dict) -> None:
    name = cfg["name"]
    for key, want in REQUIRED.items():
        if cfg.get(key, want) != want:
            raise ValueError(f"{name}: {key} {cfg[key]!r}; the benchmark's "
                             f"program and reference run {want!r}")
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    if cfg["attention_hidden_size"] != 2 * d \
            or cfg["attention_head_dim"] * H != 2 * d:
        raise ValueError(f"{name}: the shared block reads concat[h, e] "
                         "(2·hidden_size) and splits it into the heads")
    if cfg["n_mamba_heads"] * cfg["mamba_headdim"] != \
            cfg["mamba_expand"] * d:
        raise ValueError(f"{name}: mamba heads x head dim is not "
                         "mamba_expand x hidden_size")
    ids = [i for i, t in enumerate(cfg["layers_block_type"])
           if t == "hybrid"]
    if ids != list(cfg["hybrid_layer_ids"]) \
            or len(cfg["layers_block_type"]) != cfg["num_hidden_layers"]:
        raise ValueError(f"{name}: layers_block_type and hybrid_layer_ids "
                         "disagree")
    if cfg.get("ffn_hidden_size", cfg["intermediate_size"]) != \
            cfg["intermediate_size"]:
        raise ValueError(f"{name}: ffn_hidden_size is not intermediate_size")


def model_config(cfg: Dict):
    from repro_torch.configs.base import (ModelConfig, SSMConfig,
                                          Zamba2Published)
    _check(cfg)
    ssm = SSMConfig(state=cfg["mamba_d_state"], head_dim=cfg["mamba_headdim"],
                    expand=cfg["mamba_expand"], n_groups=cfg["mamba_ngroups"],
                    d_conv=cfg["mamba_d_conv"], chunk=cfg["chunk_size"],
                    dt_min=cfg["time_step_min"], dt_max=cfg["time_step_max"])
    zamba = Zamba2Published(
        hybrid_layer_ids=tuple(cfg["hybrid_layer_ids"]),
        num_mem_blocks=cfg["num_mem_blocks"],
        adapter_rank=cfg["adapter_rank"])
    H = cfg["num_attention_heads"]
    kw = dict(
        family="hybrid", num_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], vocab=cfg["vocab_size"], n_heads=H,
        n_kv=cfg.get("num_key_value_heads", H),
        head_dim=cfg["attention_head_dim"], d_ff=cfg["intermediate_size"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg.get("tie_word_embeddings", True), ssm=ssm,
        zamba=zamba, subquadratic=True)
    kw.update(cfg.get("model", {}))
    return ModelConfig(name=cfg["name"], **kw)


def _sizes(cfg: Dict):
    d = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    return (d, H, cfg.get("num_key_value_heads", H),
            cfg["attention_head_dim"], cfg["intermediate_size"],
            cfg["mamba_expand"] * d, len(cfg["hybrid_layer_ids"]))


def adapted_sites(cfg: Dict):
    """[(site name, d_in, d_out, rows)] of the adapter's targets: the
    shared q/v one row per application, the mamba sites one a layer."""
    d, H, K, hd, _, di, A = _sizes(cfg)
    L = cfg["num_hidden_layers"]
    shape = {"wq": ("shared/wq", 2 * d, H * hd, A),
             "wv": ("shared/wv", 2 * d, K * hd, A),
             "wx": ("layers/wx", d, di, L),
             "wo_ssm": ("layers/wo_ssm", di, d, L)}
    return [shape[t] for t in cfg["adapter"]["target_modules"]]


def base_layout(cfg: Dict) -> Dict[str, tuple]:
    """{leaf path: (shape, kind)} of the base weights, kind normal (the
    served type) or ones: the mamba layers' conv bias, dt_bias, A_log and
    D are ones, as the norms are."""
    d, H, K, hd, f, di, A = _sizes(cfg)
    L, M, r = (cfg["num_hidden_layers"], cfg["num_mem_blocks"],
               cfg["adapter_rank"])
    Hs, GN = cfg["n_mamba_heads"], cfg["mamba_ngroups"] * cfg["mamba_d_state"]
    C = di + 2 * GN
    layout = {
        "layers/norm": ((L, d), "ones"),
        "layers/wz": ((L, d, di), "normal"),
        "layers/wx": ((L, d, di), "normal"),
        "layers/wbc": ((L, d, 2 * GN), "normal"),
        "layers/wdt": ((L, d, Hs), "normal"),
        "layers/conv_w": ((L, C, cfg["mamba_d_conv"]), "normal"),
        "layers/conv_b": ((L, C), "ones"),
        "layers/dt_bias": ((L, Hs), "ones"),
        "layers/A_log": ((L, Hs), "ones"),
        "layers/Dp": ((L, Hs), "ones"),
        "layers/gnorm": ((L, di), "ones"),
        "layers/wo_ssm": ((L, di, d), "normal"),
        "shared/attn_norm": ((M, 2 * d), "ones"),
        "shared/wq": ((M, 2 * d, H * hd), "normal"),
        "shared/wk": ((M, 2 * d, K * hd), "normal"),
        "shared/wv": ((M, 2 * d, K * hd), "normal"),
        "shared/wo": ((M, H * hd, d), "normal"),
        "shared/mlp_norm": ((M, d), "ones"),
        "shared/wi": ((M, d, f), "normal"),
        "shared/wg": ((M, d, f), "normal"),
        "shared/wo_mlp": ((M, f, d), "normal"),
        "apps/linear": ((A, d, d), "normal"),
        "final_norm": ((d,), "ones"),
        "embed": ((cfg["vocab_size"], d), "normal"),
        "apps/mlp_lora_a": ((A, d, r), "normal"),
        "apps/mlp_lora_b": ((A, r, 2 * f), "normal"),
    }
    if not cfg.get("tie_word_embeddings", True):
        layout["lm_head"] = ((d, cfg["vocab_size"]), "normal")
    return layout


def attention_shape(cfg: Dict, batch: int, seq: int
                    ) -> Optional[Tuple[int, int, int, int, int]]:
    """(B, S, H, K, hd) of one causal attention call: one an application
    in the forward, its recompute and its backward."""
    d, H, K, hd, *_ = _sizes(cfg)
    return batch, seq, H, K, hd


def matmul_params_per_token(cfg: Dict) -> Dict[str, int]:
    """Multiply-adds a token costs in each group of the model's matrices:
    the mamba layers' projections, the shared blocks over all their
    applications, and the output head."""
    d, H, K, hd, f, di, A = _sizes(cfg)
    GN = cfg["mamba_ngroups"] * cfg["mamba_d_state"]
    mamba = d * (2 * di + 2 * GN + cfg["n_mamba_heads"]) + di * d
    r = cfg["adapter_rank"]
    app = (2 * d * (H * hd + 2 * K * hd) + H * hd * d + d * 2 * f + f * d
           + r * (d + 2 * f) + d * d)
    return {"mamba": cfg["num_hidden_layers"] * mamba, "shared": A * app,
            "head": d * cfg["vocab_size"]}


def ssd_ops(cfg: Dict, batch: int, seq: int) -> float:
    """Operations of one layer's SSD scan over batch x seq tokens (chunk
    Q): in each chunk the causal C·Bᵀ scores (a group's N a pair) and their
    product with the dt-weighted inputs (a head's P a pair), over the
    Q(Q+1)/2 visible pairs; a token's share of its chunk's state (H·P·N)
    and of the state's output (H·P·N). 2 operations a multiply-add."""
    Q = min(cfg["chunk_size"], seq)
    G, N = cfg["mamba_ngroups"], cfg["mamba_d_state"]
    Hs, P = cfg["n_mamba_heads"], cfg["mamba_headdim"]
    pairs = batch * (seq // Q) * Q * (Q + 1) / 2.0
    return 2.0 * pairs * (G * N + Hs * P) + 2.0 * batch * seq * 2 * Hs * P * N


def ssd_bytes(cfg: Dict, batch: int, seq: int) -> float:
    """Bytes one layer's SSD scan moves at least: x and y in bf16 and dt in
    f32 (a head's value a token), B and C in bf16, each once."""
    G, N = cfg["mamba_ngroups"], cfg["mamba_d_state"]
    Hs, P = cfg["n_mamba_heads"], cfg["mamba_headdim"]
    return batch * seq * (2 * 2 * Hs * P + 4 * Hs + 2 * 2 * G * N)


def train_step_ops(cfg: Dict, batch: int, seq: int) -> float:
    """Required operations of one training step of batch x seq tokens."""
    p = sum(matmul_params_per_token(cfg).values())
    d, H, K, hd, f, di, A = _sizes(cfg)
    attn = 2.0 * H * hd * seq ** 2 * batch * A
    scan = ssd_ops(cfg, batch, seq) * cfg["num_hidden_layers"]
    return 2.0 * (2.0 * p * batch * seq) + 3.0 * (attn + scan)


def prefill_ops(cfg: Dict, length: int) -> float:
    """A prompt of `length` tokens: every layer over every token, causal
    attention, the scans, the head for the one next token."""
    m = matmul_params_per_token(cfg)
    d, H, K, hd, f, di, A = _sizes(cfg)
    return (2.0 * (m["mamba"] + m["shared"]) * length + 2.0 * m["head"]
            + 2.0 * H * hd * length ** 2 * A
            + ssd_ops(cfg, 1, length) * cfg["num_hidden_layers"])


def decode_ops(cfg: Dict, kv_lens: Iterable[int]) -> float:
    """One decode token for each of the given kv lengths (the token's own
    row included): the projections, attention over the cache, a state
    update and read a head."""
    p = sum(matmul_params_per_token(cfg).values())
    d, H, K, hd, f, di, A = _sizes(cfg)
    kv = list(kv_lens)
    Hs, P, N = cfg["n_mamba_heads"], cfg["mamba_headdim"], \
        cfg["mamba_d_state"]
    return (2.0 * p * len(kv) + 4.0 * H * hd * A * sum(kv)
            + 2.0 * 2 * Hs * P * N * cfg["num_hidden_layers"] * len(kv))
