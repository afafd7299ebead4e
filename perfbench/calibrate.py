"""The readings that a cell's limits are set from (not part of a
benchmark run): for each seed, in one process on the card,

- the program: its compared numbers against the reference;
- the control: the reference itself with every linear layer in fp8 (e4m3
  operands and e5m2 gradients, a scale per tensor; the precision below
  the configurations' bf16), put in the program's place;
- training cells: the program with half of each batch left out (its mean
  loss over the rest). A state left unchanged needs no run: it reads 1 in
  grad_gap and change_gap.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,13 \
        [--program-seeds 14,15,...] [--seconds 10]

One JSON line per seed and reading on standard output. Serving cells run
a window of `--seconds` at the cell's own rate for each seed and compare
the same sample a run compares; the control reads, at each position of
those prompts and served tokens, the reference's gap of the token that the
fp8 forward puts first.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import run as runner  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control-only", action="store_true",
                    help="training cells: the control's readings alone")
    args = ap.parse_args(argv)
    runner.cache_env(runner.ROOT)
    runner.paths(runner.ROOT)
    import torch
    from harness import checks, flops, inputs, spec
    from harness import serve as serve_driver
    from harness import train as train_driver

    dev = torch.device("cuda")
    cell = spec.cell(runner.ROOT, args.workload)
    peaks = flops.peaks(torch.cuda.get_device_name(dev))
    seeds = [int(s) for s in args.seeds.split(",") if s]
    program_seeds = [int(s) for s in args.program_seeds.split(",") if s]

    def ctx(seed, seconds, faults=()):
        return runner.Ctx(cell, seed, seconds, False, dev, peaks,
                          time.perf_counter(), tuple(faults), check=False)

    def both(ref, readings):
        return {**checks.train_gaps(ref, **readings),
                **checks.train_diagnostics(ref, **readings)}

    def emit(seed, what, numbers):
        print(json.dumps({"cell": cell.name, "seed": seed, "reading": what,
                          **numbers}), flush=True)

    for seed in seeds + program_seeds:
        full = seed in seeds
        if cell.mix["kind"] == "train":
            batches = train_driver.checked_batches(ctx(seed, 0))
            tcfg = train_driver.train_config(cell.mix)
            base = inputs.make_base(cell.family.base_layout(cell.cfg), seed,
                                    dev)
            c0 = inputs.make_coeffs(cell.family.adapted_sites(cell.cfg),
                                    cell.cfg["adapter"]["n"], seed, dev)
            ref = checks.train_reference(cell.reference, cell.cfg, base, c0,
                                         batches, tcfg)
            if not args.control_only:
                prog = train_driver.run(ctx(seed, 0))
                emit(seed, "program", both(ref, prog["readings"]))
                del prog
            if not full:
                continue
            if not args.control_only:
                half = train_driver.run(ctx(seed, 0, ("half_batch",)))
                emit(seed, "half_batch", both(ref, half["readings"]))
                del half
            ctl = checks.train_reference(cell.reference, cell.cfg, base, c0,
                                         batches, tcfg, linear="fp8")
            emit(seed, "control", both(ref, ctl))
        else:
            out = serve_driver.run(ctx(seed, args.seconds))
            base, coeffs = out["inputs"]
            emit(seed, "program", {
                **checks.serve_numbers(cell.reference, cell.cfg, base,
                                       out["sample"], coeffs),
                "failed": out["failed"], "attempted": out["attempted"],
                "served_tokens": sum(len(r["served"])
                                     for r in out["sample"])})
            if full:
                emit(seed, "control", checks.serve_numbers(
                    cell.reference, cell.cfg, base, out["sample"], coeffs,
                    linear="fp8"))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
