"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2 (hf:microsoft/Phi-3.5-MoE-instruct).

32L d_model=4096 32H (GQA kv=8) d_ff=6400/expert vocab=32064.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    head_dim=128,
    d_ff=6400,
    vocab=32064,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400),
)
