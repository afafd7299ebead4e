"""Device idle time a training step while the program's step runs (ms):
the gaps between device operations whose middle falls inside a `step`
span, over the traced steps (harness/spans.py). The rest of the idle time
falls between steps, in the benchmark's own loop."""
from harness import spans


def read(run):
    return spans.per_step_ms(
        run, "idle_in_step_ms.train",
        lambda att: spans.idle_in(att, run.trace.span_s, spans.STEP))
