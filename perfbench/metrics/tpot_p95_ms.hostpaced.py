"""Time per output token (ms): the 95th percentile (nearest rank) over
every request due in the window of (last token - first token) / (tokens -
1), a request that erred, was refused or never finished counting as
infinitely late. Where the card idles between the host's rounds, the host
paces it. A traced run counts only the requests finished before the
profiler started, and the failed ones."""
from harness.record import quantile


def read(run):
    if run.kind != "serve" or not run.tpot_s:
        return None
    return 1e3 * quantile(run.tpot_s, 0.95)
