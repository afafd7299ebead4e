"""Device busy time a training step of the attention core (ms): the
operations whose chain of program spans holds `attention/<path>` (the
forward, its recompute and the backward), over the traced steps
(harness/spans.py)."""
from harness import spans

UNDER = spans.has(spans.ATTENTION)


def read(run):
    return spans.per_step_ms(run, "attention_ms.train",
                             lambda att: att.busy_s(UNDER))
