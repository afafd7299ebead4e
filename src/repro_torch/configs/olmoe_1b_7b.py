"""olmoe-1b-7b [moe] — 64 experts top-8 (arXiv:2409.02060).

16L d_model=2048 16H (MHA kv=16) d_ff=1024/expert vocab=50304. OLMoE uses
qk-norm and gated SwiGLU experts.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    head_dim=128,
    d_ff=1024,
    vocab=50304,
    qk_norm=True,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024),
)
