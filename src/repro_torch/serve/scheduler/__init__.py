"""Continuous-batching scheduler: arrival queue (`queue`), slot lifecycle
(`slots`), metrics (`metrics`) and the paged runtime (`runtime`)."""
from repro_torch.serve.scheduler.metrics import ServingMetrics  # noqa: F401
from repro_torch.serve.scheduler.queue import RequestQueue  # noqa: F401
from repro_torch.serve.scheduler.runtime import ContinuousScheduler  # noqa: F401
from repro_torch.serve.scheduler.slots import SlotManager  # noqa: F401
