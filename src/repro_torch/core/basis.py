"""Basis-expressiveness ablation (paper Table 6): replace the Fourier basis
with random Gaussian or orthogonal bases (the JAX package's
`core/basis.py`).

Paper formulation: S = B¹ F B², F sparse at entries (u_l, v_l). Only the
selected columns/rows of B¹/B² ever touch F, so exactly those are made:
ΔW = scale · (B1 ⊙ c) @ B2ᵀ with B1 (d1, n), B2 (d2, n).

The bases are drawn on the host with the JAX package's random stream
(`core/prng.py`) from the same key, so a random- or orthogonal-basis
adapter exported by either package imports into the other with the same
ΔW (neither stores b1/b2: both regenerate them from the entry seed).
Orthogonal bases are the reduced QR of those draws in float64, rounded to
float32; LAPACK's Householder QR, which JAX's float32 QR also calls, fixes
the signs.

Scale convention (matching the expected ΔW Frobenius magnitude of the
Fourier path, so one α sweep compares the bases):
    fourier:    α/(d1·d2)          (||basis col||² ≈ d/2)
    random:     α/(d1·d2)          (||col||² ≈ d)
    orthogonal: α/(2·√(d1·d2))     (||col||² = 1)
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import prng

KINDS = ("random", "orthogonal")


def make_basis(key: np.ndarray, kind: str, d1: int, d2: int, n: int):
    """-> (b1 (d1, n), b2 (d2, n)) float32 numpy arrays drawn from `key`
    ((2,) uint32, `prng.prng_key`/`fold_in`) as `jax.random` draws them."""
    if kind not in KINDS:
        raise ValueError(f"unknown basis kind {kind!r}")
    if kind == "orthogonal" and n > min(d1, d2):
        raise ValueError(f"orthogonal basis needs n <= min(d1,d2), got "
                         f"n={n}, dims=({d1},{d2})")
    k1, k2 = prng.split(key)
    b1 = prng.normal(k1, (d1, n))
    b2 = prng.normal(k2, (d2, n))
    if kind == "orthogonal":
        b1 = np.linalg.qr(b1.astype(np.float64))[0].astype(np.float32)
        b2 = np.linalg.qr(b2.astype(np.float64))[0].astype(np.float32)
    return b1, b2


@functools.lru_cache(maxsize=16)
def site_basis(entry_seed: int, kind: str, d1: int, d2: int, n: int):
    """The basis of a (d1, d2) site: drawn once per (seed, kind, shape,
    n) from fold_in(PRNGKey(entry_seed), d1·131071 + d2), as the JAX
    package's `FourierFT.init_site` keys it. Read-only arrays."""
    b1, b2 = make_basis(prng.fold_in(prng.prng_key(entry_seed),
                                     d1 * 131071 + d2), kind, d1, d2, n)
    b1.flags.writeable = b2.flags.writeable = False
    return b1, b2


def basis_scale(kind: str, d1: int, d2: int, alpha: float) -> float:
    if kind in ("random", "fourier"):
        return alpha / (d1 * d2)
    return alpha / (2.0 * (d1 * d2) ** 0.5)


def materialize_delta_basis(c: torch.Tensor, b1: torch.Tensor,
                            b2: torch.Tensor, kind: str,
                            alpha: float) -> torch.Tensor:
    """ΔW for one layer (c: (n,)) or a stack (c: (L, n) -> (L, d1, d2)):
    one (batched) torch.matmul of (B1 ⊙ c) by B2ᵀ, in f32 (callers on the
    card keep TF32 off)."""
    scale = basis_scale(kind, b1.shape[0], b2.shape[0], alpha)
    c = c.to(torch.float32)
    lhs = b1 * c if c.ndim == 1 else b1[None] * c[:, None, :]
    return torch.matmul(lhs, b2.T) * scale
