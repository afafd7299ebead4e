"""FourierFT core (the paper's contribution).

ΔW = α · Re(IFFT2(ToDense(E, c)))  (paper Eq. 2–4, Algorithm 1 normalization)

in the closed form the JAX package uses

    ΔW[j,k] = α/(d1·d2) · Σ_l c_l · cos(2π(j·u_l/d1 + k·v_l/d2))
            = [cosθ ⊙ c] @ cosφᵀ − [sinθ ⊙ c] @ sinφᵀ

— FourierFT as a rank-2n adapter with frozen Fourier factors and a
trainable diagonal. The FFT form survives as the oracle in
`repro_torch.kernels.ref`; the hand-written CUDA kernel that materializes
ΔW is `repro_torch.kernels.fourier_deltaw`.

Entries are drawn with numpy's `default_rng` exactly as the JAX package
draws them, so both packages adapt the same spectral positions.
"""
from __future__ import annotations

import math

import numpy as np
import torch

TWO_PI = 2.0 * math.pi


# ---------------------------------------------------------------------------
# Entry sampling (host-side, deterministic; runs once at adapter init)
# ---------------------------------------------------------------------------

def _bandpass_prob(d1: int, d2: int, fc: float, bandwidth: float,
                   centered: bool = True) -> np.ndarray:
    """Paper Eq. 5: p(u,v) = exp(-((D² - fc²) / (D·W))²), D = distance to the
    matrix center (centered=False: wraparound distance to DC). D=0 is a
    removable singularity: p→1 iff fc==0 else p→0."""
    if centered:
        u = np.arange(d1, dtype=np.float64)[:, None] - d1 / 2.0
        v = np.arange(d2, dtype=np.float64)[None, :] - d2 / 2.0
    else:
        uu = np.arange(d1, dtype=np.float64)
        vv = np.arange(d2, dtype=np.float64)
        u = np.minimum(uu, d1 - uu)[:, None]
        v = np.minimum(vv, d2 - vv)[None, :]
    D = np.sqrt(u * u + v * v)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = (D * D - fc * fc) / (D * bandwidth)
    p = np.exp(-np.square(z))
    p[D == 0] = 1.0 if fc == 0 else 0.0
    return p


def sample_entries(d1: int, d2: int, n: int, seed: int = 2024, *,
                   freq_bias: bool = False, fc: float = 0.0,
                   bandwidth: float = 200.0,
                   centered: bool = True) -> torch.Tensor:
    """Sample n distinct spectral entries of a d1×d2 grid. Returns int32
    (2, n) on the CPU — the same draw as the JAX package's."""
    if n > d1 * d2:
        raise ValueError(f"n={n} exceeds grid size {d1}x{d2}")
    rng = np.random.default_rng(seed)
    if freq_bias:
        logp = np.log(_bandpass_prob(d1, d2, fc, bandwidth, centered)
                      + 1e-30).ravel()
        gumbel = rng.gumbel(size=logp.shape)
        flat = np.argpartition(-(logp + gumbel), n - 1)[:n]
    elif d1 * d2 <= (1 << 24):
        flat = rng.permutation(d1 * d2)[:n]
    else:
        # huge grids (e.g. embedding-sized): draw-and-dedup, O(n) memory
        flat = np.unique(rng.integers(0, d1 * d2, size=2 * n))
        while flat.size < n:
            flat = np.unique(np.concatenate(
                [flat, rng.integers(0, d1 * d2, size=2 * n)]))
        flat = rng.permutation(flat)[:n]
    uv = np.stack(np.divmod(flat.astype(np.int64), d2))
    return torch.from_numpy(uv.astype(np.int32))


# ---------------------------------------------------------------------------
# Fourier bases
# ---------------------------------------------------------------------------

def fourier_angles(entries: torch.Tensor, d1: int, d2: int):
    """Phase grids for the selected entries: θ[j,l] = 2π·((j·u_l) mod d1)/d1
    (d1, n) and φ[k,l] = 2π·((k·v_l) mod d2)/d2 (d2, n), f32.

    The phase is reduced exactly in int64 before the float conversion, as
    the CUDA kernel reduces it, so cos/sin see arguments in [0, 2π) at any
    dimension."""
    dev = entries.device
    u = entries[0].to(torch.int64)
    v = entries[1].to(torch.int64)
    j = torch.arange(d1, dtype=torch.int64, device=dev)[:, None]
    k = torch.arange(d2, dtype=torch.int64, device=dev)[:, None]
    theta = ((j * u[None, :]) % d1).to(torch.float32) * (TWO_PI / d1)
    phi = ((k * v[None, :]) % d2).to(torch.float32) * (TWO_PI / d2)
    return theta, phi


def fourier_bases(entries: torch.Tensor, d1: int, d2: int):
    theta, phi = fourier_angles(entries, d1, d2)
    return torch.cos(theta), torch.sin(theta), torch.cos(phi), torch.sin(phi)


# ---------------------------------------------------------------------------
# ΔW materialization (the plain PyTorch version; the kernel lives in
# repro_torch.kernels.fourier_deltaw)
# ---------------------------------------------------------------------------

def materialize_delta(c: torch.Tensor, entries: torch.Tensor, d1: int,
                      d2: int, alpha: float, *,
                      out_dtype=None) -> torch.Tensor:
    """ΔW for one layer (c: (n,)) or a stack (c: (L, n) -> (L, d1, d2)), in
    f32 with `torch.matmul` (callers on the card keep TF32 off)."""
    cos_t, sin_t, cos_p, sin_p = fourier_bases(entries.to(c.device), d1, d2)
    scale = alpha / (d1 * d2)
    c = c.to(torch.float32)
    if c.ndim == 1:
        dw = (cos_t * c) @ cos_p.T - (sin_t * c) @ sin_p.T
    else:
        # stacked layers: contract n against shared bases
        dw = ((cos_t[None] * c[:, None, :]) @ cos_p.T
              - (sin_t[None] * c[:, None, :]) @ sin_p.T)
    dw = dw * scale
    return dw.to(out_dtype) if out_dtype is not None else dw


def factored_apply(x: torch.Tensor, c: torch.Tensor, entries: torch.Tensor,
                   d1: int, d2: int, alpha: float,
                   bases=None) -> torch.Tensor:
    """y += x @ ΔW without materializing ΔW (rank-2n bypass).

    x: (..., d1) -> (..., d2). Equals x @ materialize_delta(...). `bases`:
    the four tables `fourier_bases(entries, d1, d2)` gives, when the caller
    built them once beforehand (then `entries` is not read)."""
    if bases is None:
        bases = fourier_bases(entries.to(x.device), d1, d2)
    cos_t, sin_t, cos_p, sin_p = bases
    from repro_torch.dist.dtensor import is_dtensor, shard_like_columns
    if is_dtensor(x):
        # on a mesh the output columns follow a column-parallel weight's
        # shard over `model` (the bases' d2 rows split with them)
        cos_p, sin_p = (shard_like_columns(t, x) for t in (cos_p, sin_p))
    scale = alpha / (d1 * d2)
    xf = x.to(torch.float32)
    c = c.to(torch.float32)
    pc = (xf @ cos_t) * c                      # (..., n)
    ps = (xf @ sin_t) * c
    y = pc @ cos_p.T - ps @ sin_p.T
    return (y * scale).to(x.dtype)


def delta_norm(c: torch.Tensor, entries: torch.Tensor, d1: int, d2: int,
               alpha: float) -> torch.Tensor:
    """||ΔW||_F via Parseval, without materialization. Conjugate-pair
    entries share one real basis function, so the Gram matrix is not
    diagonal; the exact O(n²) form is cheap at adapter sizes."""
    entries = entries.to(c.device)
    u, v = entries[0].to(torch.int64), entries[1].to(torch.int64)
    cf = c.to(torch.float32)
    conj = ((u[:, None] == (d1 - u[None, :]) % d1)
            & (v[:, None] == (d2 - v[None, :]) % d2))
    s = torch.sum(cf * cf) + torch.einsum(
        "l,m,lm->", cf, cf, conj.to(torch.float32))
    scale = alpha / (d1 * d2)
    return scale * torch.sqrt(torch.clamp(s, min=0.0) * d1 * d2 / 2.0)
