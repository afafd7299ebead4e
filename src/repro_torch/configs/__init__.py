"""Architecture configs: `get(arch_id)`, `reduced(cfg)` for smoke tests.

Copies of the JAX package's dense-family configs. The other families
(moe, ssm, hybrid, audio, vlm) are not ported yet: asking for one raises
NotImplementedError (ROADMAP queue 1, "the other architecture families").
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (ModelConfig, MoEConfig, PEFTConfig,
                                      TrainConfig)
from repro_torch.configs import qwen2_5_32b, qwen3_4b, yi_6b, yi_9b

ARCHS = {
    "yi-6b": yi_6b.CONFIG,
    "yi-9b": yi_9b.CONFIG,
    "qwen3-4b": qwen3_4b.CONFIG,
    "qwen2.5-32b": qwen2_5_32b.CONFIG,
}

# registered by the JAX package, not ported yet (other families)
UNPORTED_ARCHS = ("musicgen-medium", "qwen2-vl-72b", "zamba2-7b",
                  "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b")

ARCH_IDS = tuple(ARCHS)


def get(arch: str) -> ModelConfig:
    if arch in ARCHS:
        return ARCHS[arch]
    if arch in UNPORTED_ARCHS:
        raise NotImplementedError(
            f"arch {arch!r} is not a dense model; the port covers the dense "
            "family only so far (ROADMAP queue 1: the other architecture "
            "families)")
    raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")


def reduced(cfg: ModelConfig, *, layers: int = 2, width: int = 64,
            vocab: int = 256) -> ModelConfig:
    """Shrink a config to smoke-test size, preserving its structural family
    (GQA ratio, qk-norm, QKV bias, ...)."""
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


__all__ = ["ModelConfig", "PEFTConfig", "TrainConfig", "ARCHS", "ARCH_IDS",
           "get", "reduced"]
