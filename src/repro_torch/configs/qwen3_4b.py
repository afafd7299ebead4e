"""qwen3-4b [dense] — qk_norm, GQA (hf:Qwen/Qwen3-4B family).

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936. Qwen3 uses head_dim=128
(attention dim 4096 > d_model) and per-head RMS q/k-norm, no QKV bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv=8,
    head_dim=128,
    d_ff=9728,
    vocab=151936,
    qk_norm=True,
    rope_theta=1000000.0,
)
