"""Device busy time a training step of the adapter merge (ms): the
operations whose chain of program spans holds `adapter`: ΔW of every site
(K1), its cast and add into the base, and their backward (the cotangent's
f32 cast, K2), over the traced steps (harness/spans.py). The projections'
weight-gradient products are the linear layers' own."""
from harness import spans

UNDER = spans.has(spans.ADAPTER)


def read(run):
    return spans.per_step_ms(run, "adapter_ms.train",
                             lambda att: att.busy_s(UNDER))
