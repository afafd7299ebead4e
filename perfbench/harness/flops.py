"""The yardstick: the operations a model's step requires, the byte and
operation bounds of the hand-written kernels, and the card's peaks.

Required operations of a decoder (per the benchmark's definition): the
matrix products of the forward (2 operations per multiply-add), the
backward's products for the activation gradients (as many again), and
attention counted causal: 2·H·hd·S² operations a layer and sequence
forward (QKᵀ and PV over the lower triangle), twice that backward.
Recomputation, the frozen base's weight gradients (the adapted weights'
too) and the adapter's own ΔW transforms are not counted.

K1/K2's bound is a frozen copy of the bring-up smoke's: ΔW (or its
gradient g) written or read once in f32, against the operations of a
real-data 2-D FFT of d1·d2 points a layer (2.5·N·log2 N) at the f32 peak.
K3's bound is its bytes: every live kv row read once in the cache's type,
the queries read and the outputs written once.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Iterable

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def peaks(device_name: str) -> Dict[str, float]:
    """The published peaks of the card named `device_name` (a key of
    peaks.json that the name contains); KeyError for an unknown card."""
    table = json.loads(PEAKS_FILE.read_text())
    for key, row in table.items():
        if key in device_name:
            return row
    raise KeyError(f"no peaks for {device_name!r} in {PEAKS_FILE.name}")


def matmul_params_per_token(cfg: Dict) -> Dict[str, int]:
    """Multiply-adds a token costs in each group of the model's matrices:
    attention projections, the gated MLP over all layers, and the output
    head."""
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    K = cfg.get("num_key_value_heads", H)
    hd = cfg.get("model", {}).get("head_dim", d // H)
    f = cfg["intermediate_size"]
    attn = d * H * hd * 2 + d * K * hd * 2
    return {"attention": L * attn, "mlp": L * 3 * d * f,
            "head": d * cfg["vocab_size"]}


def attention_core(cfg: Dict) -> int:
    """H·hd·L: causal attention's forward costs 2·this·S² a sequence."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = cfg.get("model", {}).get("head_dim", d // H)
    return H * hd * cfg["num_hidden_layers"]


def train_step_ops(cfg: Dict, batch: int, seq: int) -> float:
    """Required operations of one training step of batch x seq tokens."""
    p = sum(matmul_params_per_token(cfg).values())
    fwd = 2.0 * p * batch * seq + 2.0 * attention_core(cfg) * seq ** 2 \
        * batch
    mm_bwd = 2.0 * p * batch * seq
    attn_bwd = 2.0 * (2.0 * attention_core(cfg) * seq ** 2 * batch)
    return fwd + mm_bwd + attn_bwd


def prefill_ops(cfg: Dict, length: int) -> float:
    """A prompt of `length` tokens: every layer over every token, causal
    attention, the head for the one next token."""
    m = matmul_params_per_token(cfg)
    return (2.0 * (m["attention"] + m["mlp"]) * length + 2.0 * m["head"]
            + 2.0 * attention_core(cfg) * length ** 2)


def decode_ops(cfg: Dict, kv_lens: Iterable[int]) -> float:
    """One decode token for each of the given kv lengths (the token's own
    row included)."""
    p = sum(matmul_params_per_token(cfg).values())
    kv = list(kv_lens)
    return 2.0 * p * len(kv) + 4.0 * attention_core(cfg) * sum(kv)


def bound(flops: float, nbytes: float, peak_flops: float,
          bytes_per_s: float) -> float:
    """Seconds: the larger of the operations and the bytes at peak."""
    return max(flops / peak_flops, nbytes / bytes_per_s)


def fft_ops(d1: int, d2: int, L: int) -> float:
    """Operations of the FFT formulation of K1's and K2's functions: a
    real-data 2-D FFT of d1 x d2 points a layer, 2.5·N·log2 N."""
    size = float(d1 * d2)
    return 2.5 * size * math.log2(size) * L


def deltaw_bound(d1: int, d2: int, L: int, pk: Dict[str, float]) -> float:
    """Seconds of one K1 (ΔW) or K2 (dc) launch over a (L, d1, d2) stack."""
    return bound(fft_ops(d1, d2, L), 4.0 * L * d1 * d2, pk["f32_flops"],
                 pk["hbm_bytes_per_s"])


def paged_attention_bound(kv_lens: Iterable[int], heads: int,
                          kv_heads: int, head_dim: int, elem: int,
                          pk: Dict[str, float]) -> float:
    """Seconds of one K3 launch (one layer, one query row a slot) over
    slots with the given kv lengths."""
    kv = list(kv_lens)
    nbytes = (sum(kv) * kv_heads * head_dim * 2 * elem
              + len(kv) * heads * head_dim * 2 * elem)
    flops = 4.0 * heads * head_dim * sum(kv)
    return bound(flops, nbytes, pk["bf16_flops"], pk["hbm_bytes_per_s"])
