"""Required operations of the window's model rounds (prompt tokens
prefilled at their true lengths, one decode token for each live slot of a
round; harness/flops.py) over the summed wall time of those rounds at the
card's bf16 peak, in %."""


def read(run):
    if run.kind != "serve" or run.busy_rounds_s <= 0 \
            or "bf16_flops" not in run.peaks:
        return None
    return 100.0 * run.required_ops / (run.busy_rounds_s
                                       * run.peaks["bf16_flops"])
