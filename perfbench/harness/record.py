"""What one run measured, handed to the per-layer readers
(`perfbench/metrics/<metric>.py`, each `read(run) -> float | None`)."""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from harness.trace import Trace


@dataclass
class Run:
    kind: str                       # "train" | "serve"
    cfg: Dict                       # the configuration file
    mix: Dict                       # the traffic file
    peaks: Dict[str, float]         # the card's published peaks
    window_s: float = 0.0
    # train: host seconds of every step in the window, each ending in the
    # step's one loss read; serve: host seconds of every tick that worked
    step_s: List[float] = field(default_factory=list)
    tick_s: List[float] = field(default_factory=list)
    tokens: int = 0                 # trained (train) or emitted (serve)
    # train: the required operations of one step; serve: those of the
    # window's working ticks, and the ticks' summed wall time
    step_ops: float = 0.0
    required_ops: float = 0.0
    busy_rounds_s: float = 0.0
    ttft_s: List[float] = field(default_factory=list)
    tpot_s: List[float] = field(default_factory=list)
    lag_s: List[float] = field(default_factory=list)
    peak_window_bytes: int = 0      # after a reset at the window's start
    trace: Optional[Trace] = None   # the traced stretch (--trace 1)
    # counts over the traced stretch: kernel launches by the program's
    # counters, and what the yardstick needs per launch
    counters: Dict[str, float] = field(default_factory=dict)
    sites: List = field(default_factory=list)   # (name, d1, d2, L)
    # (B, S, H, K, hd) of one attention call of a training step (the
    # family's `attention_shape`), None where the family has none
    attention: Optional[Tuple[int, int, int, int, int]] = None
    k3_rounds: List[List[int]] = field(default_factory=list)  # kv lengths


def quantile(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank quantile: the ceil(q·N)-th smallest (None when
    empty)."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, min(len(v) - 1, math.ceil(q * len(v)) - 1))]
