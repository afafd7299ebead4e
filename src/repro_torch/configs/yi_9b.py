"""yi-9b [dense] — llama-arch GQA (arXiv:2403.04652).

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv=4,
    head_dim=128,
    d_ff=11008,
    vocab=64000,
    rope_theta=10000.0,
)
