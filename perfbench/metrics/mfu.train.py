"""The window's required model operations (harness/flops.py) over the
window's seconds at the card's bf16 peak, in %. The steps are back to
back, so the window is the sum of their host times; a traced run leaves
out the profiled steps (the profiler's own start, stop and reading)."""


def read(run):
    if run.kind != "train" or not run.step_s \
            or "bf16_flops" not in run.peaks:
        return None
    return 100.0 * run.step_ops * len(run.step_s) / (
        sum(run.step_s) * run.peaks["bf16_flops"])
