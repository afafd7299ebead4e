"""Tiered-memory serving: priority classes, preempt-and-resume, and host
tiers for KV pages and adapter-bank rows (the JAX package's
`serve/tiering`, on pinned host tensors)."""
from repro_torch.serve.tiering.config import (  # noqa: F401
    DEFAULT_PRIORITY, PRIORITIES, TieringConfig, priority_rank,
)
from repro_torch.serve.tiering.host_pool import (  # noqa: F401
    HostAdapterTier, HostPagePool,
)
from repro_torch.serve.tiering.preempt import (  # noqa: F401
    VictimInfo, choose_mode, choose_victim,
)
