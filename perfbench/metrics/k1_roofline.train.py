"""K1 (the ΔW kernel) in the traced stretch: its bound over every launch
(harness/flops.py `deltaw_bound`, a launch per adapted site a step) over
its kernels' device time by name, in %."""
from harness import flops

KERNELS = ("scatter_plan_kernel", "deltaw_kernel")


def read(run):
    if run.kind != "train" or run.trace is None or not run.sites:
        return None
    device_s, _ = run.trace.kernel_s(KERNELS)
    launches = run.counters.get("k1_launches", 0)
    if device_s <= 0 or launches <= 0 or "f32_flops" not in run.peaks:
        return None
    cycle = sum(flops.deltaw_bound(d1, d2, L, run.peaks)
                for _, d1, d2, L in run.sites)
    return 100.0 * cycle * launches / len(run.sites) / device_s
