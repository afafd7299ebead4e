"""Device busy time a training step of the mamba layers' SSD scan (ms): the
operations whose chain of program spans holds `ssd` (each layer's scan
forward, in remat's recompute and backward), over the traced steps
(harness/spans.py). None where the trace holds no `ssd` range."""
from harness import spans

SSD = spans.PREFIX + "ssd"


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    att = spans.attribute(run.trace)
    if att is None or not any(r.name == SSD for r in att.ranges):
        return None
    spans.log_unattributed("ssd_ms.train", att)
    return 1e3 * att.busy_s(spans.has(SSD)) / run.mix["trace_steps"]
