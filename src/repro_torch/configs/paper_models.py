"""The models of the FourierFT paper itself (a copy of the JAX package's
`configs/paper_models.py`): Table 1's parameter accounting and the paper's
own architectures at their published widths.

Paper Table 1 tunes only the query and value projections (L_t = 2 *
num_layers adapted matrices), and for RoBERTa/ViT additionally a
fully-trained classification head that is excluded from the reported
counts. The port builds each as the dense decoder (`models/transformer.py`):
GPT-2, RoBERTa and ViT with the non-gated GELU MLP and no RoPE
(`gated_mlp=False, rope_theta=0.0`), LLaMA2 gated with RoPE and no GQA.
"""
from repro_torch.configs.base import ModelConfig

# d1 = d2 = d_model for the q/v projections of all these models.
ROBERTA_BASE = ModelConfig(
    name="roberta-base", family="dense", num_layers=12, d_model=768,
    n_heads=12, n_kv=12, head_dim=64, d_ff=3072, vocab=50265,
    gated_mlp=False, rope_theta=0.0,
)
ROBERTA_LARGE = ROBERTA_BASE.replace(
    name="roberta-large", num_layers=24, d_model=1024, n_heads=16, n_kv=16,
    d_ff=4096,
)
GPT2_MEDIUM = ModelConfig(
    name="gpt2-medium", family="dense", num_layers=24, d_model=1024,
    n_heads=16, n_kv=16, head_dim=64, d_ff=4096, vocab=50257,
    gated_mlp=False, rope_theta=0.0,
)
GPT2_LARGE = GPT2_MEDIUM.replace(
    name="gpt2-large", num_layers=36, d_model=1280, n_heads=20, n_kv=20,
    d_ff=5120,
)
LLAMA2_7B = ModelConfig(
    name="llama2-7b", family="dense", num_layers=32, d_model=4096,
    n_heads=32, n_kv=32, head_dim=128, d_ff=11008, vocab=32000,
)
LLAMA2_13B = LLAMA2_7B.replace(
    name="llama2-13b", num_layers=40, d_model=5120, n_heads=40, n_kv=40,
    d_ff=13824,
)
VIT_BASE = ModelConfig(
    name="vit-base", family="dense", num_layers=12, d_model=768,
    n_heads=12, n_kv=12, head_dim=64, d_ff=3072, vocab=1000,
    gated_mlp=False, rope_theta=0.0,
)
VIT_LARGE = VIT_BASE.replace(
    name="vit-large", num_layers=24, d_model=1024, n_heads=16, n_kv=16,
    d_ff=4096,
)

PAPER_MODELS = {
    m.name: m
    for m in (ROBERTA_BASE, ROBERTA_LARGE, GPT2_MEDIUM, GPT2_LARGE,
              LLAMA2_7B, LLAMA2_13B, VIT_BASE, VIT_LARGE)
}
