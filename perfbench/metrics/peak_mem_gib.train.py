"""Peak device memory allocated during the window (GiB), after a reset of
the peak at the window's start."""


def read(run):
    if run.kind != "train" or run.peak_window_bytes <= 0:
        return None
    return run.peak_window_bytes / 2 ** 30
