"""Time to first token (ms): the median (nearest rank) over every request
due in the window of first token - due time, a request that erred, was
refused or never finished counting as infinitely late. A traced run
counts only the requests finished before the profiler started, and the
failed ones."""
from harness.record import quantile


def read(run):
    if run.kind != "serve" or not run.ttft_s:
        return None
    return 1e3 * quantile(run.ttft_s, 0.5)
