"""The host-side plan of the FFT-structured kernels: K1 and K2 of FourierFT
(`csrc/fourier_deltaw.cu`) and K4 and K5 of the dct method
(`csrc/dct_deltaw.cu`), whose passes are `csrc/fft_rows.cuh` and transform
routine `csrc/fft_smem.cuh`.

All four run one in-place complex transform of length d2 per pair of rows
of ΔW or g, in shared memory, so a site (d1, d2) has one plan for both
bases. The plan fixes, for a site:

- `radices`: the transform's stages, in order. Odd prime factors first
  (ascending, the generic radix-p stage, p ≤ MAX_RADIX), then the power of
  two as radix 8 stages with one 4, 4·4 or 2 to finish it.
- `pairs`: row pairs per block (one complex buffer each), a power of two
  up to 8; about 32 KB of shared memory per block at small d2, one buffer
  at d2 ≥ 4096.
- `cluster`: the blocks one row pair spans. 1 up to CTA_ROW points (one
  f32 complex row in one block's shared memory); 2 past it, up to
  MAX_D2: a thread-block cluster of two blocks on neighbouring SMs, each
  holding N/2 contiguous points of the row in its own shared memory. The
  radices are then the plan of N/2 followed by (2,), so every stage but
  the last acts within one half, and the last (radix 2, span N/2) pairs
  point k of one block with point k + N/2 of the other through
  distributed shared memory (`csrc/fft_rows.cuh`). Below CTA_ROW the plan
  is what it was before clusters existed.
- `k2_slabs`, `k2_row_blocks`: K2 (and K5) walks `k2_slabs` groups of
  `pairs` row pairs per block, so a layer has at most K2_ROW_BLOCKS partial
  sums per entry for the fixed-order reduction.
- `shift`: a row's point i lives at i + (i >> shift) in shared memory:
  4 (one pad word per 16 points, so the strided first stages read without
  bank conflicts) wherever the padded rows fit, else 30 (no padding: the
  largest rows fill the shared memory).
- `smem_bytes`: one padded f32 complex row (of a cluster: half a row) per
  pair, per block.

`digit_reverse(radices)` is the position of each spectrum index in the
buffer the stages leave or expect (K1 and K4 write their spectra there, K2
and K5 read their transforms from there); `stage_twiddles(radices)` says
which entries of the length-d2 twiddle table each stage reads, in the order
its threads read them. The wrapper builds both on the card once per
(d2, device).

Limits (a shape beyond them raises, naming the limit): d2 ≤ MAX_D2 (one
buffer in the 227 KB of shared memory of each of a cluster's two blocks),
d2 even past CTA_ROW (the cluster splits the row in halves), every odd
prime factor of d2 ≤ MAX_RADIX, d1 ≤ MAX_D1 (K1/K2's row phase j·u is one
32-bit product; K4/K5's (2j+1)·u mod 4d1 is a 64-bit one, so this is not
what binds them, but they share the plan), n ≤ MAX_N (the ΔW kernels'
scatter plan holds 2n ints in shared memory).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np

SMEM_BYTES = 232_448            # shared memory one H100 block can have
CTA_ROW = SMEM_BYTES // 8       # 29056: one complex f32 buffer in a block
CLUSTER = 2                     # blocks of the cluster a longer row spans
MAX_D2 = CLUSTER * CTA_ROW      # 58112
MAX_D1 = 65_535                 # (d1 - 1)^2 < 2^32
MAX_RADIX = 63                  # the generic stage's register array is 64
MAX_N = 16_384                  # K1's scatter plan: 8n bytes of shared memory
MAX_STAGES = 16                 # the C side's FftPlan arrays
TARGET_BYTES = 32_768           # shared memory per block when d2 is small
MAX_PAIRS = 8
K2_ROW_BLOCKS = 512             # partial sums per entry and layer, at most

# What the C side of the FFT-structured kernels assumes (KernelOp.caps;
# analysis/kernel_audit.py derives MAX_D2, MAX_D1, MAX_N and MAX_RADIX from
# it and holds it against csrc/fft_rows.cuh and csrc/fft_smem.cuh):
#   phase:            "linear" — K1/K2's row phase (j·u) mod d1, j, u < d1;
#                     "half" — K4/K5's ((2j+1)·u) mod 4·d1, u < 4·d1
#   phase_bits, phase_signed: the integer type of that one product
#                     (unsigned 32-bit j·u; a 64-bit product for the DCT)
#   accum_bits:       the running phase p += step, p and step < the modulus
#   smem_bytes:       the dynamic shared memory a block may request
#   point_bytes:      one transform point (a complex f32)
#   scatter_entry_bytes, scatter_static_bytes: the scatter plan's 2n ints
#                     per entry and its static part[SORT_THREADS] ints
#   entry_chunk:      n is padded to a multiple of this (NC)
#   odd_radix_regs:   the generic odd stage's local array (FFT_MAX_ODD)
#   max_stages:       the C side's FftPlan arrays (FFT_MAX_STAGES)
#   cluster:          the blocks of the thread-block cluster one row may
#                     span (FFT_CLUSTER), so MAX_D2 = cluster · smem_bytes /
#                     point_bytes
_CAPS = {"kind": "fft_rows", "smem_bytes": SMEM_BYTES, "point_bytes": 8,
         "scatter_entry_bytes": 8, "scatter_static_bytes": 4 * 1024,
         "entry_chunk": 16, "odd_radix_regs": 64, "max_stages": MAX_STAGES,
         "accum_bits": 32, "cluster": CLUSTER}
FOURIER_CAPS = {**_CAPS, "phase": "linear", "phase_bits": 32,
                "phase_signed": False}
DCT_CAPS = {**_CAPS, "phase": "half", "phase_bits": 64,
            "phase_signed": False}


@dataclass(frozen=True)
class FftPlan:
    d1: int
    d2: int
    radices: Tuple[int, ...]
    pairs: int
    k2_slabs: int
    k2_row_blocks: int
    shift: int
    smem_bytes: int
    cluster: int = 1

    def as_ints(self) -> Tuple[int, ...]:
        """The C side's `int plan[PLAN_INTS]`: stages, radices (zero-padded
        to MAX_STAGES), pairs, k2_slabs, shift, cluster."""
        r = self.radices + (0,) * (MAX_STAGES - len(self.radices))
        return (len(self.radices),) + r + (self.pairs, self.k2_slabs,
                                            self.shift, self.cluster)


PLAN_INTS = 1 + MAX_STAGES + 4
PAD_SHIFT, NO_PAD_SHIFT = 4, 30


def row_words(d2: int, shift: int) -> int:
    """Complex words of one padded row: the last point's place + 1."""
    return d2 + ((d2 - 1) >> shift)


def _odd_then_pow2(m: int, d2: int) -> Tuple[int, ...]:
    """Radices of a transform of length m (product m): odd prime factors
    ascending, then the power of two as 8s with one 4, 4·4 or 2 to finish
    it; raises naming d2 when an odd prime exceeds MAX_RADIX."""
    rest, odd = m, []
    while rest % 2 == 0:
        rest //= 2
    pow2 = m // rest
    p = 3
    while rest > 1:
        while rest % p == 0:
            if p > MAX_RADIX:
                raise ValueError(
                    f"d2={d2} has the prime factor {p}: the kernels' "
                    f"generic radix stage takes odd primes <= {MAX_RADIX}")
            odd.append(p)
            rest //= p
        p += 2
    k = pow2.bit_length() - 1
    tail = {0: (), 1: (2,) if k < 4 else (4, 4), 2: (4,)}[k % 3]
    eights = (k - sum(r.bit_length() - 1 for r in tail)) // 3
    return tuple(odd) + (8,) * eights + tail


def cluster_of(d2: int) -> int:
    """The blocks one row of length d2 spans: 1 up to CTA_ROW, else
    CLUSTER."""
    return 1 if d2 <= CTA_ROW else CLUSTER


@lru_cache(maxsize=None)
def factor(d2: int) -> Tuple[int, ...]:
    """The stage radices of a length-d2 transform (product d2), or raise
    naming the limit d2 breaks. Past CTA_ROW: the radices of d2/2, then
    the cluster's radix-2 stage."""
    if not 1 <= d2 <= MAX_D2:
        raise ValueError(f"d2={d2}: the FFT-structured kernels take "
                         f"1 <= d2 <= {MAX_D2} (one complex f32 row in the "
                         f"{SMEM_BYTES}-byte shared memory of each of a "
                         f"cluster's {CLUSTER} blocks)")
    if cluster_of(d2) == 1:
        return _odd_then_pow2(d2, d2)
    if d2 % CLUSTER:
        raise ValueError(f"d2={d2}: a row longer than {CTA_ROW} points "
                         f"(one block's shared memory) is split in halves "
                         f"over a cluster of {CLUSTER} blocks, so d2 must "
                         "be even")
    return _odd_then_pow2(d2 // CLUSTER, d2) + (CLUSTER,)


@lru_cache(maxsize=None)
def fft_plan(d1: int, d2: int, n: int = 0) -> FftPlan:
    """The plan of K1/K2 (and K4/K5) for a (d1, d2) site with n entries;
    raises ValueError naming the limit a shape breaks."""
    radices = factor(d2)
    if not 1 <= d1 <= MAX_D1:
        raise ValueError(f"d1={d1}: the kernels take 1 <= d1 <= {MAX_D1} "
                         "(K1/K2's row phase j·u is one 32-bit product)")
    if n > MAX_N:
        raise ValueError(f"n={n}: the ΔW kernels' scatter plan takes "
                         f"n <= {MAX_N}")
    cluster = cluster_of(d2)
    points = d2 // cluster                      # of a row, in one block
    total = -(-d1 // 2)                         # row pairs of a layer
    cap = max(1, min(MAX_PAIRS, TARGET_BYTES // (8 * d2), total))
    pairs = 1 << (cap.bit_length() - 1)         # K1 is built for 1, 2, 4, 8
    groups = -(-total // pairs)                 # groups of `pairs` pairs
    slabs = -(-groups // K2_ROW_BLOCKS)
    shift = PAD_SHIFT if 8 * row_words(points, PAD_SHIFT) * pairs \
        <= SMEM_BYTES else NO_PAD_SHIFT
    return FftPlan(d1, d2, radices, pairs, slabs, -(-groups // slabs), shift,
                   8 * row_words(points, shift) * pairs, cluster)


def digit_reverse(radices: Tuple[int, ...]) -> np.ndarray:
    """pos (N,) int32 for the in-place stages with these radices (stage s
    combines blocks of span m_s = r_0···r_{s-1}): the decimation-in-time
    stages, run on a buffer that holds x[t] at pos[t], leave the transform
    in natural order; the decimation-in-frequency stages, run on x in
    natural order, leave X[t] at pos[t]. pos[t] reverses t's mixed-radix
    digits: t's least significant digit (base r_{S-1}) weighs m_{S-1}."""
    n = int(np.prod(radices, dtype=np.int64)) if radices else 1
    t = np.arange(n, dtype=np.int64)
    pos = np.zeros(n, dtype=np.int64)
    span = [int(np.prod(radices[:s], dtype=np.int64)) for s in
            range(len(radices))]
    for s in reversed(range(len(radices))):
        pos += (t % radices[s]) * span[s]
        t //= radices[s]
    return pos.astype(np.int32)


def stage_twiddles(radices: Tuple[int, ...]) -> np.ndarray:
    """Indices into the length-N twiddle table exp(2πi p/N) of the table
    the stages read (csrc/fft_smem.cuh): stage s's exp(2πi q·k/m_{s+1})
    at m_s - 1 + (q-1)·m_s + k (q < r_s, k < m_s; N - 1 entries in all),
    then, for each odd stage in order, its roots exp(2πi j/r_s), j < r_s."""
    n = int(np.prod(radices, dtype=np.int64)) if radices else 1
    parts, roots, m = [], [], 1
    for r in radices:
        q = np.arange(1, r)[:, None]
        k = np.arange(m)[None, :]
        parts.append((q * k * (n // (m * r))).reshape(-1))
        if r % 2:
            roots.append(np.arange(r) * (n // r))
        m *= r
    idx = np.concatenate(parts + roots) if parts else np.zeros(0)
    return idx.astype(np.int64)
