"""FourierFT's ΔW from its definition (arXiv:2405.03003, Eq. 2-4 and
Algorithm 1): the n coefficients are scattered into a d1 x d2 spectrum at
frozen entries, and ΔW = α · Re(IFFT2(spectrum)), IFFT2 normalised by
1/(d1·d2).

The entries are drawn by a frozen copy of the rule the measured program
states for them: one shared entry seed (the paper's 2024), offset per
weight shape, then n distinct flat positions of the d1·d2 grid from
numpy's `default_rng` (a permutation for grids up to 2**24 points, draw
and deduplicate above). Plain numpy and torch only.
"""
from __future__ import annotations

import numpy as np
import torch


def entry_seed(entry_seed_base: int, d1: int, d2: int) -> int:
    """The entry seed of a (d1, d2) weight: the shared seed, offset by the
    shape so that grids of different sizes draw their own entries."""
    return entry_seed_base + hash((d1, d2)) % 1000


def sample_entries(d1: int, d2: int, n: int, seed: int) -> np.ndarray:
    """n distinct spectral entries of a d1 x d2 grid: (2, n) int64 rows u
    (frequency along d1) and v (along d2)."""
    if n > d1 * d2:
        raise ValueError(f"n={n} exceeds the {d1}x{d2} grid")
    rng = np.random.default_rng(seed)
    if d1 * d2 <= (1 << 24):
        flat = rng.permutation(d1 * d2)[:n]
    else:
        flat = np.unique(rng.integers(0, d1 * d2, size=2 * n))
        while flat.size < n:
            flat = np.unique(np.concatenate(
                [flat, rng.integers(0, d1 * d2, size=2 * n)]))
        flat = rng.permutation(flat)[:n]
    return np.stack(np.divmod(flat.astype(np.int64), d2))


def delta_w(c: torch.Tensor, entries: torch.Tensor, d1: int, d2: int,
            alpha: float) -> torch.Tensor:
    """ΔW (d1, d2) f32 of one layer's coefficients c (n,): the scattered
    spectrum's inverse 2-D FFT, real part, times α. Differentiable in c."""
    spec = torch.zeros((d1, d2), dtype=torch.complex64, device=c.device)
    spec = spec.index_put((entries[0], entries[1]),
                          c.to(torch.float32).to(torch.complex64))
    return torch.fft.ifft2(spec).real * alpha
