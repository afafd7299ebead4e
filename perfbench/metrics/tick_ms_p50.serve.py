"""Median host time of a scheduler round that did work in the window (ms):
the benchmark's clock around each `tick()` that admitted, primed or
decoded."""
import statistics


def read(run):
    if run.kind != "serve" or not run.tick_s:
        return None
    return 1e3 * statistics.median(run.tick_s)
