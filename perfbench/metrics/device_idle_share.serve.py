"""The share of the traced stretch in which no device operation ran, in %:
1 - (union of the device's operation intervals) / (stretch)."""


def read(run):
    if run.kind != "serve" or run.trace is None or run.trace.span_s <= 0 \
            or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.span_s)
