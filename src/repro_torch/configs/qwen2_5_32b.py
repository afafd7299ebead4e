"""qwen2.5-32b [dense] — GQA with QKV bias (hf:Qwen/Qwen2.5 family).

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    head_dim=128,
    d_ff=27648,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
)
