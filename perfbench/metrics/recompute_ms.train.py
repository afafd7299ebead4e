"""Device busy time a training step of remat's recompute (ms): the
operations whose chain holds a `layer` span opened inside a backward node
(`torch.utils.checkpoint` re-entering the layer), over the traced steps
(harness/spans.py)."""
from harness import spans


def read(run):
    return spans.per_step_ms(run, "recompute_ms.train",
                             lambda att: att.busy_s(spans.recomputed))
