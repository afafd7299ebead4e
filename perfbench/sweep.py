"""The knee of a serving cell: one set-up, then one open-loop window at
each offered rate, ascending, on the card (not part of a benchmark run).

    python3 perfbench/sweep.py --workload <cell> --rates 2,4,6,8 \
        --seconds 20 --seed 7

One JSON line per rate: requests offered and finished, the window's
tokens/s, TTFT p50/p95 and TPOT p95 (ms), the sender's lag p95 and the
backlog (queued or in flight) when the window closed. The sweep stops
after the first rate whose TTFT p95 passes `--stop-ttft-s`.
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
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--stop-ttft-s", type=float, default=10.0)
    args = ap.parse_args(argv)
    runner.cache_env(runner.ROOT)
    runner.paths(runner.ROOT)
    import torch
    from harness import flops, spec
    from harness import serve as serve_driver
    from harness.record import quantile

    dev = torch.device("cuda")
    cell = spec.cell(runner.ROOT, args.workload)
    peaks = flops.peaks(torch.cuda.get_device_name(dev))
    ctx = runner.Ctx(cell, args.seed, args.seconds, False, dev, peaks,
                     time.perf_counter(), check=False)
    prepared = serve_driver.build(ctx)
    serve_driver.warm(prepared[0], ctx)
    for rate in (float(r) for r in args.rates.split(",")):
        out = serve_driver.run(ctx, rate=rate, prepared=prepared)
        rec = out["run"]
        row = {"cell": cell.name, "rate_per_s": rate,
               "offered": out["attempted"], "failed": out["failed"],
               "finished_in_window": sum(
                   1 for t in out["tracks"]
                   if t.done and t.stamps and t.stamps[-1] <= rec.window_s),
               "tokens_per_s": rec.tokens / rec.window_s,
               "ttft_p50_ms": 1e3 * (quantile(rec.ttft_s, 0.5) or 0),
               "ttft_p95_ms": 1e3 * (quantile(rec.ttft_s, 0.95) or 0),
               "tpot_p95_ms": 1e3 * (quantile(rec.tpot_s, 0.95) or 0),
               "lag_p95_ms": 1e3 * (quantile(rec.lag_s, 0.95) or 0),
               "backlog_at_close": sum(
                   1 for t in out["tracks"]
                   if not t.stamps or t.stamps[-1] > rec.window_s)}
        print(json.dumps(row), flush=True)
        if row["ttft_p95_ms"] > 1e3 * args.stop_ttft_s:
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
