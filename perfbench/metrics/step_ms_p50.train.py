"""Median host time of a training step in the window (ms): the benchmark's
clock around each call of the train step, each call ending in the step's
one loss read."""
import statistics


def read(run):
    if run.kind != "train" or not run.step_s:
        return None
    return 1e3 * statistics.median(run.step_s)
