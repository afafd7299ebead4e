"""Device busy time a training step of the hybrid's shared-block
applications (HF Zamba2's memory blocks; ms): the operations whose chain
of program spans holds `shared` (each application from the concat to its
own linear: norms, projections with the factored adapter, attention, MLP
with its LoRA; forward, recompute and backward), over the traced steps
(harness/spans.py). None where the trace holds no `shared` range."""
from harness import spans

SHARED = spans.PREFIX + "shared"


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    att = spans.attribute(run.trace)
    if att is None or not any(r.name == SHARED for r in att.ranges):
        return None
    spans.log_unattributed("mem_block_ms.train", att)
    return 1e3 * att.busy_s(spans.has(SHARED)) / run.mix["trace_steps"]
