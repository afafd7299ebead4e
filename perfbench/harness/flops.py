"""The yardstick: the byte and operation bounds of the hand-written
kernels, and the card's peaks. The operations a model's step requires are
its family's (perfbench/families/<reference>.py: `train_step_ops`,
`prefill_ops`, `decode_ops`).

K1/K2's bound is a frozen copy of the bring-up smoke's: ΔW (or its
gradient g) written or read once in f32, against the operations of a
real-data 2-D FFT of d1·d2 points a layer (2.5·N·log2 N) at the f32 peak.
K3's bound is its bytes: every live kv row read once in the cache's type,
the queries read and the outputs written once.
The fused attention kernel's bound is a frozen copy of the program's cost
of a launch: 4·H·hd operations a visible (query, key) pair forward, twice
that backward, over B·(S² + S)/2 pairs causal; q, k, v (and out, dout,
dq, dk, dv backward) moved once in bf16 and the f32 row statistics once,
at the bf16 peak.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Iterable, Tuple

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def peaks(device_name: str) -> Dict[str, float]:
    """The published peaks of the card named `device_name` (a key of
    peaks.json that the name contains); KeyError for an unknown card."""
    table = json.loads(PEAKS_FILE.read_text())
    for key, row in table.items():
        if key in device_name:
            return row
    raise KeyError(f"no peaks for {device_name!r} in {PEAKS_FILE.name}")


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


def fused_attention_bound(shape: Tuple[int, int, int, int, int],
                          pk: Dict[str, float], backward: bool = False
                          ) -> float:
    """Seconds of one causal launch of the fused attention kernel over q
    (B, S, H, hd) and k/v (B, S, K, hd): the forward, or with `backward`
    its two backward passes together."""
    B, S, H, K, hd = shape
    pairs = B * (S * S + S) / 2.0
    q, kv, rows = B * S * H * hd, B * S * K * hd, B * H * S
    if backward:
        flops, nbytes = 8.0 * H * hd * pairs, 2 * (4 * q + 4 * kv) + 4 * rows
    else:
        flops, nbytes = 4.0 * H * hd * pairs, 2 * (2 * q + 2 * kv) + 4 * rows
    return bound(flops, nbytes, pk["bf16_flops"], pk["hbm_bytes_per_s"])
