"""The fused attention kernel in the traced stretch: the bound of every
launch (harness/flops.py `fused_attention_bound`, forward launches by the
counter `fused_attention.launches`, backward by `bwd_launches`, each at
the shape of the family's attention call) over the device time of its
kernels by name (`fwd_kernel`, `bwd_dq_kernel`, `bwd_dkdv_kernel`), in
%."""
from harness import flops
from harness.trace import short

KERNELS = ("fwd_kernel<", "bwd_dq_kernel<", "bwd_dkdv_kernel<")


def read(run):
    if run.kind != "train" or run.trace is None or run.attention is None \
            or "bf16_flops" not in run.peaks:
        return None
    fwd = run.counters.get("attention_launches", 0)
    bwd = run.counters.get("attention_bwd_launches", 0)
    device_s = sum(b - a for n, a, b in run.trace.device
                   if short(n).startswith(KERNELS))
    if device_s <= 0 or fwd + bwd <= 0:
        return None
    bound_s = (fwd * flops.fused_attention_bound(run.attention, run.peaks)
               + bwd * flops.fused_attention_bound(run.attention, run.peaks,
                                                   backward=True))
    return 100.0 * bound_s / device_s
