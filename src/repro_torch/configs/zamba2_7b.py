"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks (arXiv:2411.15242).

81L d_model=3584 32H (MHA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
A single shared transformer block (attention + MLP) is applied before every
group of 6 mamba blocks (weights shared across applications, each
application with its own KV cache and its own factored adapter row):
81 = 13·6 + 3, so 14 applications.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, ZambaConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv=32,
    head_dim=112,
    d_ff=14336,
    vocab=32000,
    ssm=SSMConfig(state=64, head_dim=64, expand=2, n_groups=1),
    zamba=ZambaConfig(shared_every=6, shared_lora_r=0),
    subquadratic=True,
)
