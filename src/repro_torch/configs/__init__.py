"""Architecture configs: `get(arch_id)`, `reduced(cfg)` for smoke tests.

Copies of the JAX package's configs of every family it registers (dense,
moe, audio, vlm, the pure-SSM mamba2-2.7b and the hybrid zamba2-7b) and of
the paper's own models (`PAPER_MODELS`, reached through `get` as in the
JAX package; the launchers' `--arch` choices stay `ARCHS`).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (SHAPES, SHAPES_BY_NAME, ModelConfig,
                                      MoEConfig, PEFTConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.configs import (mamba2_2_7b, musicgen_medium, olmoe_1b_7b,
                                 phi3_5_moe, qwen2_5_32b, qwen2_vl_72b,
                                 qwen3_4b, yi_6b, yi_9b, zamba2_7b)
from repro_torch.configs.paper_models import PAPER_MODELS

ARCHS = {
    "yi-6b": yi_6b.CONFIG,
    "yi-9b": yi_9b.CONFIG,
    "qwen3-4b": qwen3_4b.CONFIG,
    "qwen2.5-32b": qwen2_5_32b.CONFIG,
    "musicgen-medium": musicgen_medium.CONFIG,
    "qwen2-vl-72b": qwen2_vl_72b.CONFIG,
    "olmoe-1b-7b": olmoe_1b_7b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi3_5_moe.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
    "mamba2-2.7b": mamba2_2_7b.CONFIG,
}

ARCH_IDS = tuple(ARCHS)


def get(arch: str) -> ModelConfig:
    if arch in ARCHS:
        return ARCHS[arch]
    if arch in PAPER_MODELS:
        return PAPER_MODELS[arch]
    raise KeyError(f"unknown arch {arch!r}; known: "
                   f"{sorted(ARCHS) + sorted(PAPER_MODELS)}")


def reduced(cfg: ModelConfig, *, layers: int = 2, width: int = 64,
            vocab: int = 256) -> ModelConfig:
    """Shrink a config to smoke-test size, preserving its structural family
    (GQA ratio, MoE top-k, SSM shape, hybrid wiring, codebooks, qk-norm,
    QKV bias, ...)."""
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=layers,
        d_model=width,
        vocab=vocab,
    )
    if cfg.n_heads:
        n_heads = max(4, min(cfg.n_heads, 4))
        # preserve GQA grouping: keep kv ratio if grouped, else MHA
        ratio = max(1, cfg.n_heads // max(cfg.n_kv, 1))
        n_kv = max(1, n_heads // min(ratio, n_heads))
        kw.update(n_heads=n_heads, n_kv=n_kv, head_dim=max(8, width // n_heads))
    if cfg.d_ff:
        kw.update(d_ff=width * 2)
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            num_experts=min(8, cfg.moe.num_experts),
            top_k=min(2, cfg.moe.top_k),
            d_ff_expert=width,
            capacity_factor=cfg.moe.capacity_factor,
        )
        kw["d_ff"] = width
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, state=16, head_dim=16, chunk=16)
    if cfg.zamba is not None:
        kw["zamba"] = dataclasses.replace(cfg.zamba, shared_every=2)
        kw["num_layers"] = max(layers, 4)
    return cfg.replace(**kw)


def shape_for(name: str) -> ShapeConfig:
    return SHAPES_BY_NAME[name]


__all__ = ["ModelConfig", "PEFTConfig", "ShapeConfig", "TrainConfig",
           "SHAPES", "SHAPES_BY_NAME", "ARCHS", "ARCH_IDS", "PAPER_MODELS",
           "get", "reduced", "shape_for"]
