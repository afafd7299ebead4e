"""How late the open-loop sender submitted (ms): the 95th percentile
(nearest rank) over the window's requests of submission time minus due
time."""
from harness.record import quantile


def read(run):
    if run.kind != "serve" or not run.lag_s:
        return None
    return 1e3 * quantile(run.lag_s, 0.95)
