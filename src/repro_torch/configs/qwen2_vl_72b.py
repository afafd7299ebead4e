"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution (arXiv:2409.12191).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064. Backbone only: the
vision frontend is a STUB — a batch carries precomputed patch/text
embeddings (B, S, d_model) plus 3-D M-RoPE position ids (3, B, S).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    mrope=True,
    embed_inputs=False,
    rope_theta=1000000.0,
)
