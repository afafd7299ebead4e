"""Everything a run feeds the program and the reference, made from
`--seed`: base weights, adapter coefficients, training batches and the
serving traffic.

Weights are made on the device with one `torch.Generator` in a few large
calls, in the type they are served in. Traffic sizes and arrival gaps come
from the mix's own `shape_seed`, the same for every run seed; the run seed
draws the tokens and the tenants, so every seed asks for the same work.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

INIT_STD = 0.02


def subseed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose of one run seed (any whole number)."""
    h = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, purpose: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, purpose))
    return g


def make_base(layout: Dict, seed: int, device, dtype=torch.bfloat16
              ) -> Dict:
    """The base weights in a family's layout (`base_layout`: {leaf path:
    (shape, kind)}, kind normal, the served type, or ones) as a nested
    dict, each leaf under its path's parts ("layers/wq" ->
    base["layers"]["wq"]): every normal leaf, in the layout's order, a view
    of one buffer drawn in one call."""
    gen = generator(seed, "base", device)
    normal = [(k, s) for k, (s, kind) in layout.items() if kind == "normal"]
    total = sum(int(np.prod(s)) for _, s in normal)
    buf = torch.randn(total, generator=gen, dtype=dtype, device=device)
    buf.mul_(INIT_STD)
    flat, off = {}, 0
    for k, s in normal:
        n = int(np.prod(s))
        flat[k] = buf[off:off + n].view(s)
        off += n
    for k, (s, kind) in layout.items():
        if kind == "ones":
            flat[k] = torch.ones(s, dtype=dtype, device=device)
    base: Dict = {}
    for k, t in flat.items():
        *parents, name = k.split("/")
        node = base
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = t
    return base


def make_coeffs(sites, n: int, seed: int, device, tenants: int = 0
                ) -> Dict[str, torch.Tensor]:
    """{site: coefficients} normal(0, 1) f32: (L, n) each, or (tenants, L,
    n) for a bank's tenants."""
    gen = generator(seed, "coefficients", device)
    lead = (tenants,) if tenants else ()
    return {name: torch.randn(lead + (L, n), generator=gen,
                              dtype=torch.float32, device=device)
            for name, _, _, L in sites}


def train_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
                device) -> Dict[str, torch.Tensor]:
    """Step `step`'s batch: uniform tokens, labels the next token."""
    gen = generator(seed, f"batch{step}", device)
    t = torch.randint(0, vocab, (batch, seq + 1), generator=gen,
                      dtype=torch.int64, device=device).to(torch.int32)
    return {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}


@dataclass
class ServeRequest:
    due: float                  # seconds after the window opens
    prompt: np.ndarray          # (P,) int32
    max_new: int
    tenant: Optional[int]       # None: the base model


def lognormal_lengths(rng: np.random.Generator, spec: Dict,
                      count: int) -> np.ndarray:
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"], size=count)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def serve_traffic(mix: Dict, seconds: float, seed: int, vocab: int,
                  rate: Optional[float] = None) -> List[ServeRequest]:
    """The open-loop requests of one window: round(rate · seconds) of them,
    due by Poisson gaps that sum to under `seconds`. The gaps, and each
    request's prompt and output lengths, are the mix's own (`shape_seed`),
    in the same order for every run seed: the order sets the bursts, and
    with it the tails. The seed draws the prompts' tokens and the
    tenants."""
    rate = float(mix["rate_per_s"] if rate is None else rate)
    n = max(1, int(round(rate * seconds)))
    shape = np.random.default_rng(mix["shape_seed"])
    gaps = shape.exponential(1.0 / rate, size=n)
    gaps *= seconds * (n - 0.5) / n / gaps.sum()
    due = np.cumsum(gaps) - gaps[0]
    prompts = lognormal_lengths(shape, mix["prompt"], n)
    outputs = lognormal_lengths(shape, mix["output"], n)
    rng = np.random.default_rng(subseed(seed, "traffic"))
    T = mix["tenants"]
    zipf = 1.0 / np.arange(1, T + 1) ** mix["zipf_a"]
    zipf /= zipf.sum()
    reqs = []
    for i in range(n):
        base = rng.random() < mix["base_share"]
        tenant = None if base else int(rng.choice(T, p=zipf))
        reqs.append(ServeRequest(
            due=float(due[i]),
            prompt=rng.integers(0, vocab, size=int(prompts[i]))
            .astype(np.int32),
            max_new=int(outputs[i]), tenant=tenant))
    return reqs
