"""musicgen-medium [audio] — decoder-only over EnCodec tokens (arXiv:2306.05284).

48L d_model=1536 24H (MHA, kv=24) d_ff=6144 vocab=2048, 4 codebooks.
MusicGen uses standard (non-gated) GELU FFN and full MHA. The EnCodec audio
frontend is a STUB per the assignment: inputs are the 4 codebook token ids per
frame; embeddings are summed, and 4 parallel LM heads predict each codebook.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv=24,
    head_dim=64,
    d_ff=6144,
    vocab=2048,
    n_codebooks=4,
    gated_mlp=False,
    rope_theta=10000.0,
)
