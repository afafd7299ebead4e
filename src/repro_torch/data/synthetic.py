"""Deterministic, seekable synthetic data (the JAX package's
`data/synthetic.py`: `SyntheticLM` and `SyntheticClassification`).

Every batch is a pure function of (seed, step): any host can regenerate any
shard of any step after a restart, with no iterator state to checkpoint.
Sequences come from a fixed first-order Markov "teacher" (seeded by
`task_seed`), so models measurably learn.

Draws come from numpy generators (`np.random.default_rng`), not from
`jax.random`, whose threefry streams cannot be reproduced here: the port's
batches are not the JAX package's. Tests that compare the two packages feed
both sides the same arrays.

The teacher differs in one respect of cost, not of kind: each token keeps
at most `FANOUT` successors (with normal logits × `concentration`). At a
vocabulary of up to `FANOUT` tokens that is the JAX package's dense
(vocab, vocab) table; at a full vocabulary (yi-6b: 64000) the dense table
would hold 4.1e9 logits (16 GB), while (vocab, FANOUT) holds 32.8e6 and a
batch is drawn in milliseconds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.devices import resolve_device

FANOUT = 512


def markov_teacher(vocab: int, task_seed: int, concentration: float = 1.5):
    """-> (successors (vocab, F) int32, logits (vocab, F) f32), F =
    min(vocab, FANOUT). With F == vocab every token may follow every
    token (a dense table)."""
    rng = np.random.default_rng(task_seed)
    fan = min(vocab, FANOUT)
    if fan == vocab:
        succ = np.broadcast_to(np.arange(vocab, dtype=np.int32),
                               (vocab, vocab))
    else:
        succ = rng.integers(0, vocab, size=(vocab, fan), dtype=np.int32)
    logits = (rng.standard_normal((vocab, fan), dtype=np.float32)
              * np.float32(concentration))
    return succ, logits


def sample_markov(rng: np.random.Generator, succ: np.ndarray,
                  logits: np.ndarray, batch: int, seq: int) -> np.ndarray:
    """(batch, seq) int32 token chains: uniform first tokens, then Gumbel-max
    draws from each token's successor logits."""
    vocab = succ.shape[0]
    out = np.empty((batch, seq), dtype=np.int32)
    out[:, 0] = rng.integers(0, vocab, size=batch)
    rows = np.arange(batch)
    gumbel = rng.gumbel(size=(seq - 1, batch, succ.shape[1]))
    for t in range(1, seq):
        prev = out[:, t - 1]
        pick = np.argmax(logits[prev] + gumbel[t - 1], axis=-1)
        out[:, t] = succ[prev, pick]
    return out


@dataclass
class SyntheticLM:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    task_seed: int = 1
    codebooks: int = 0

    def __post_init__(self):
        self._succ, self._logits = markov_teacher(self.vocab, self.task_seed)

    def batch_at(self, step: int, shard: int = 0,
                 num_shards: int = 1) -> Dict[str, torch.Tensor]:
        """Batch for global `step` as int32 CPU tensors; `shard`/
        `num_shards` carve the global batch deterministically."""
        rng = np.random.default_rng((self.seed, step))
        toks = sample_markov(rng, self._succ, self._logits, self.batch,
                             self.seq + 1)
        if num_shards > 1:
            per = self.batch // num_shards
            toks = toks[shard * per:(shard + 1) * per]
        tokens, labels = toks[:, :-1], toks[:, 1:]
        if self.codebooks:
            tokens = np.repeat(tokens[..., None], self.codebooks, axis=-1)
            labels = np.repeat(labels[..., None], self.codebooks, axis=-1)
        return {"tokens": torch.from_numpy(np.ascontiguousarray(tokens)),
                "labels": torch.from_numpy(np.ascontiguousarray(labels))}


@dataclass
class SyntheticClassification:
    """K-class Gaussian-blob classification (paper Appendix C.2 setting).
    The JAX package draws these with numpy too, so at the same seed the
    arrays are the same bits."""
    num_classes: int = 8
    dim: int = 2
    noise: float = 0.4
    seed: int = 0

    def dataset(self, n_per_class: int = 64,
                device: Optional[Union[str, torch.device]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x (K·n, dim) f32, y (K·n,) int32), shuffled, on `device` (the
        card unless the caller names another)."""
        dev = resolve_device(device)
        rng = np.random.default_rng(self.seed)
        angles = np.linspace(0, 2 * np.pi, self.num_classes, endpoint=False)
        centers = np.stack([np.cos(angles), np.sin(angles)], -1) * 2.0
        if self.dim > 2:
            centers = np.concatenate(
                [centers, np.zeros((self.num_classes, self.dim - 2))], -1)
        xs, ys = [], []
        for c in range(self.num_classes):
            xs.append(centers[c] + rng.normal(size=(n_per_class, self.dim))
                      * self.noise)
            ys.append(np.full(n_per_class, c))
        x = np.concatenate(xs).astype(np.float32)
        y = np.concatenate(ys).astype(np.int32)
        perm = rng.permutation(len(y))
        return (torch.from_numpy(x[perm]).to(dev),
                torch.from_numpy(y[perm]).to(dev))
