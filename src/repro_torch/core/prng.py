"""The JAX package's default random stream (threefry2x32, in its
partitionable form) in numpy, for the draws the port must reproduce bit
for bit: the Table-6 random and orthogonal bases, which neither package
stores in an adapter checkpoint and both regenerate at import from the
entry seed (`core/basis.py`).

    key = prng_key(seed)          # jax.random.PRNGKey(seed): (2,) uint32
    key = fold_in(key, data)      # jax.random.fold_in
    k1, k2 = split(key)           # jax.random.split(key, 2)
    bits = random_bits(key, shape)
    x = normal(key, shape)        # jax.random.normal(key, shape, float32)

The bits are exact: threefry2x32 with the Threefry-2x32 rotations and key
schedule, counters taken from the flat index as a (hi, lo) pair of uint32
(`jax_threefry_partitionable=True`, the default since JAX 0.5), and 32 bits
drawn as the xor of the two output words. `normal` maps them as JAX does:
23 mantissa bits to a float32 in [1, 2), shifted to [nextafter(-1, 0), 1),
then sqrt(2)·erfinv in float32 with the polynomial XLA evaluates (M. Giles,
"Approximating the erfinv function"). Its log1p is numpy's, not XLA's, so
the normals agree to a few float32 ulps (most of them bit for bit), not
all bit for bit.
"""
from __future__ import annotations

import math

import numpy as np

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash of the counter pairs (x0, x1) under `key`
    ((2,) uint32): 20 rounds in five groups of four, a key injection after
    each group. Returns the two output words, uint32, shaped like x0."""
    k0, k1 = (np.uint32(k) for k in np.asarray(key, np.uint32))
    ks = (k0, k1, np.uint32(int(k0) ^ int(k1) ^ _PARITY))
    y0 = np.asarray(x0, np.uint32) + ks[0]
    y1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            y0 = y0 + y1
            y1 = _rotl(y1, r) ^ y0
        y0 = y0 + ks[(i + 1) % 3]
        y1 = y1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return y0, y1


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` for a 32-bit seed: (0, seed mod 2^32)."""
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return np.array([0, seed & _MASK], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """`jax.random.fold_in(key, data)`: the hash of the counter pair
    (0, data)."""
    if not 0 <= data <= _MASK:
        raise OverflowError(f"fold_in data {data} is not a uint32")
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([data], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def _counters(count: int):
    idx = np.arange(count, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(_MASK)).astype(np.uint32))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)`: (num, 2) uint32, key i the hash of
    the counter i."""
    y0, y1 = threefry2x32(key, *_counters(num))
    return np.stack([y0, y1], axis=1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32 random bits per element (the xor of the hash's two words at the
    element's flat index)."""
    y0, y1 = threefry2x32(key, *_counters(math.prod(shape)))
    return (y0 ^ y1).reshape(shape)


def uniform(key: np.ndarray, shape, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`,
    bit for bit: the top 23 bits as the mantissa of a float in [1, 2)."""
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)) \
        .view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


# erfinv's float32 polynomial in w = -log1p(-x²): one set of coefficients
# below w = 5, one in sqrt(w) beyond, highest degree first
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erfinv32(x: np.ndarray) -> np.ndarray:
    """erfinv in float32 as XLA evaluates it, for |x| < 1."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.zeros_like(x)
    for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE):
        p = np.where(small, np.float32(a), np.float32(b)) + p * w
    return p * x


def normal(key: np.ndarray, shape) -> np.ndarray:
    """`jax.random.normal(key, shape, float32)`: sqrt(2)·erfinv(u) of a
    uniform u in [nextafter(-1, 0), 1) (module docstring: within a few
    float32 ulps of JAX's)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return np.float32(math.sqrt(2.0)) * erfinv32(u)
