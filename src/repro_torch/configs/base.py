"""Config dataclasses for models, PEFT and training.

A copy of the JAX package's `configs/base.py` (ModelConfig, PEFTConfig,
TrainConfig and the family extras they reference), kept here so that the port imports
nothing of the JAX package. It adds one class the JAX package lacks,
`Zamba2Published` (Zamba2 as published, an option of the port's hybrid
family), and has one difference in meaning, not in fields:
`PEFTConfig.kernel_backend` names the same four policies, and
`repro_torch.kernels.api` maps them onto the port's backends — `auto` and
`pallas` select the CUDA kernel for CUDA tensors, `einsum` the plain PyTorch
version, and `interpret` is rejected at resolution (it has no meaning here).
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    state: int
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class ZambaConfig:
    shared_every: int = 6
    shared_lora_r: int = 0


@dataclass(frozen=True)
class Zamba2Published:
    """Zamba2's hybrid wiring as published (HF transformers'
    `Zamba2ForCausalLM`), held in `ModelConfig.zamba` in place of the JAX
    package's `ZambaConfig`: `num_mem_blocks` shared blocks, applied in
    turn before each of `hybrid_layer_ids`, each reading the residual
    stream with the embeddings beside it (width 2·d_model), attention at
    scale (head_dim / 2) ** -0.5, an erf-GELU gated MLP with each
    application's own rank-`adapter_rank` LoRA on its gate and up
    projections, then the application's own d x d `linear`;
    the block's output joins the next mamba layer's input before its
    norm. The mamba layers' gated norm is grouped by `ssm.n_groups`.
    `models/zamba2.py` says the rest."""
    hybrid_layer_ids: Tuple[int, ...]
    num_mem_blocks: int
    adapter_rank: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    vocab: int
    # attention (ignored for pure-ssm)
    n_heads: int = 0
    n_kv: int = 0
    head_dim: int = 0
    d_ff: int = 0
    qk_norm: bool = False
    qkv_bias: bool = False
    mrope: bool = False          # multimodal 3-D RoPE (qwen2-vl)
    rope_theta: float = 10000.0
    gated_mlp: bool = True       # SwiGLU vs GELU MLP
    # extras
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    zamba: Optional[ZambaConfig] = None     # or Zamba2Published
    n_codebooks: int = 0         # musicgen: parallel codebook embeddings/heads
    embed_inputs: bool = True    # False for VLM stub (input = patch embeddings)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # numerics
    dtype: str = "bfloat16"      # activation dtype
    param_dtype: str = "bfloat16"
    # long-context capability flag (drives long_500k skip logic)
    subquadratic: bool = False

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv * self.head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class PEFTConfig:
    method: str = "fourierft"     # fourierft | dct | none (ported so far)
    # --- FourierFT ---
    n: int = 1000
    alpha: float = 300.0
    entry_seed: int = 2024        # paper: value 2024 shared across layers
    freq_bias: bool = False       # Eq. 5 Gaussian band-pass sampling
    fc: float = 0.0               # favored central frequency
    bandwidth: float = 200.0
    basis: str = "fourier"        # fourier | random | orthogonal (Table 6)
    strategy: str = "merged"      # merged | factored
    # kernel-backend policy: auto/pallas = the CUDA kernel for CUDA tensors,
    # einsum = the plain PyTorch version, interpret = rejected at resolution
    kernel_backend: str = "auto"  # auto | pallas | interpret | einsum
    use_pallas: Optional[str] = None  # DEPRECATED -> kernel_backend (shim)
    # --- LoRA baseline ---
    lora_r: int = 8
    lora_alpha: float = 16.0
    # --- common ---
    target_modules: Tuple[str, ...] = ("wq", "wv")
    train_head: bool = False
    param_dtype: str = "float32"  # adapters train in f32

    def __post_init__(self):
        if self.use_pallas is not None:
            mapped = _USE_PALLAS_TO_BACKEND.get(self.use_pallas)
            if mapped is None:
                raise ValueError(
                    f"legacy use_pallas={self.use_pallas!r}; one of "
                    f"{sorted(_USE_PALLAS_TO_BACKEND)} (or use kernel_backend)")
            warnings.warn(
                "PEFTConfig.use_pallas is deprecated; use kernel_backend="
                f"{mapped!r}", DeprecationWarning, stacklevel=3)
            object.__setattr__(self, "kernel_backend", mapped)
            object.__setattr__(self, "use_pallas", None)
        if self.kernel_backend not in ("auto", "pallas", "interpret",
                                       "einsum"):
            raise ValueError(
                f"unknown kernel_backend {self.kernel_backend!r}; one of "
                "('auto', 'pallas', 'interpret', 'einsum')")

    def replace(self, **kw) -> "PEFTConfig":
        return dataclasses.replace(self, **kw)


# legacy tri-state -> registry backend policy
_USE_PALLAS_TO_BACKEND = {"auto": "auto", "never": "einsum",
                          "interpret": "interpret"}


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The assigned LM shape set (identical across the 10 archs), the JAX
# package's: the planner prices a cell at one of these.
SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-3
    head_learning_rate: float = 1e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "linear"      # linear | cosine | constant
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatch: int = 0           # 0 = no accumulation
    remat: str = "full"           # full | dots | none
    anomaly_threshold: float = 1e4
    seed: int = 0
    # gradient all-reduce compression: none | int8_ef (dist/compression.py)
    grad_compression: str = "none"

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
