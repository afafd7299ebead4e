"""Serving: merged-adapter engine and adapter bank (`engine`), paged KV
bookkeeping (`paging`), the continuous-batching scheduler (`scheduler`),
its speculative drafters (`spec`), tiered memory (`tiering`) and the
OpenAI-compatible gateway (`gateway`, imported on its own)."""
from repro_torch.serve.engine import (  # noqa: F401
    AdapterBank, BankFullError, Engine, Request, merge_for_serving,
)
from repro_torch.serve.paging import (  # noqa: F401
    OutOfPagesError, PageAllocator, PagedKVCache, PageError, PrefixCache,
)
from repro_torch.serve.scheduler import (  # noqa: F401
    ContinuousScheduler, RequestQueue, ServingMetrics, SlotManager,
)
from repro_torch.serve.spec import NGramDrafter, SelfDrafter  # noqa: F401
from repro_torch.serve.tiering import (  # noqa: F401
    DEFAULT_PRIORITY, PRIORITIES, HostAdapterTier, HostPagePool,
    TieringConfig, priority_rank,
)
