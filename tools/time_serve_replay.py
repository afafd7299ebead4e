#!/usr/bin/env python3
"""Wall time of chip_smoke.py phase 7's serving replay on one NVIDIA card,
for one source tree: yi-6b at full width, cut to 2 layers (phase 7's
depth) and at all 32, bf16, FourierFT n = 1000, alpha = 300 on wq/wv,
merged by K1 and served by the paged ContinuousScheduler (K3) on the
launcher's 8-request staggered trace (8 slots, page 16, max_len 128).

    python3 tools/time_serve_replay.py [--src DIR]

`--src` is the `src/` directory whose `repro_torch` is imported (default:
this checkout's), so that two trees are timed in one call on one card.
For each depth: one cold replay, then REPLAYS warm ones, each timed on the
host clock around a synchronised replay: the scheduler's tokens/s and the
wall ms a decode round. Where the scheduler records dispatch signatures
(`ContinuousScheduler._note`), one more replay times that recording: its
host µs a decode round and its share of the replay's wall time.

Prints the card's name and power limit first, then one JSON line a depth.
Imports nothing of JAX; needs nvcc (the K1 and K3 libraries are built).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEPTHS = (2, 32)
REPLAYS = 5
SLOTS, PAGE, PAGES_PER_SEQ = 8, 16, 8
REQUESTS, MAX_NEW, GAP = 8, 16, 2.0


def replay(engine, prompts, timed_note: bool = False):
    """One replay of the trace on a fresh scheduler; -> (wall s, decode
    rounds, tokens/s, recording s or None)."""
    import torch
    from repro_torch.launch.serve import demo_trace
    from repro_torch.serve import ContinuousScheduler
    sched = ContinuousScheduler(engine, page_size=PAGE)
    spent = None
    if timed_note:
        spent = [0.0]
        real = sched._note

        def note(name, *args):
            t = time.perf_counter()
            real(name, *args)
            spent[0] += time.perf_counter() - t
        sched._note = note
    reqs, arrivals = demo_trace(prompts, REQUESTS, MAX_NEW, GAP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.serve(reqs, arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for i, r in enumerate(reqs):
        if r.out is None or len(r.out) != r.max_new:
            raise SystemExit(f"request {i} emitted {r.out!r}")
    return (wall, sched.metrics.steps,
            sched.metrics.summary()["tokens_per_s"],
            spent[0] if spent else None)


def time_depth(layers: int, src: str) -> dict:
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import PEFTConfig
    from repro_torch.launch.serve import demo_prompts
    from repro_torch.models import build
    from repro_torch.serve import ContinuousScheduler, Engine
    dev = torch.device("cuda")
    cfg = configs.get("yi-6b").replace(num_layers=layers)
    model = build(cfg, PEFTConfig(method="fourierft", n=1000, alpha=300.0))
    engine = Engine(model, model.init(0, dev), batch_slots=SLOTS,
                    max_len=PAGE * PAGES_PER_SEQ, device=dev)
    prompts = demo_prompts(cfg, SLOTS)
    replay(engine, prompts)                           # cold: set-up paid
    runs = [replay(engine, prompts) for _ in range(REPLAYS)]
    out = {"src": src, "layers": layers,
           "tokens_per_s": [r[2] for r in runs],
           "ms_per_round": [r[0] / r[1] * 1e3 for r in runs],
           "decode_rounds": runs[0][1]}
    out["tokens_per_s_median"] = statistics.median(out["tokens_per_s"])
    out["ms_per_round_median"] = statistics.median(out["ms_per_round"])
    if hasattr(ContinuousScheduler, "_note"):
        wall, rounds, _, rec = replay(engine, prompts, timed_note=True)
        out["record_us_per_round"] = rec / rounds * 1e6
        out["record_share_of_wall"] = rec / wall
    else:
        out["record_us_per_round"] = None
    del engine
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch is timed")
    args = ap.parse_args()
    src = str(Path(args.src).resolve())
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        print("time_serve_replay: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    for layers in DEPTHS:
        print(json.dumps(time_depth(layers, src)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
