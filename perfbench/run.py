"""Run one cell of the port's benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds `src/repro_torch` and
BENCHMARK.json. It measures the PyTorch/CUDA port on the CUDA card(s) of
the machine it is started on and fails (exit 2, no result) without as
many as the cell asks for. The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), `device`,
with --trace 1 a `breakdown` of the traced stretch, and last `checks`:
every number that decided `correct` beside its limit (also the last
lines of standard error).

Set-up (the process's start to the window's first step) builds the
program's kernels where this checkout has not built them yet (under
`build/`), makes every input from the seed and warms the cell's shapes.
Every cache a run writes lies at a fixed path under `build/`.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional, Tuple  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# what the result line may not find loaded, by top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_env(root: Path) -> None:
    """Fixed cache directories inside the checkout, for anything in the
    process that compiles or caches kernels; no library may load JAX."""
    cache = root / "build" / "perfbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def paths(root: Path) -> None:
    for p in (str(HERE), str(root / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


@dataclass
class Ctx:
    cell: object
    seed: int
    seconds: float
    trace: bool
    device: object
    peaks: Dict[str, float]
    t_start: float
    faults: Tuple[str, ...] = ()
    check: bool = True              # run the reference after the window
    # perf_counter intervals from each profiler start to its trace read
    tracing_overhead: list = field(default_factory=list)

    def log(self, msg: str) -> None:
        print(f"perfbench: {self.cell.name}: {msg}", file=sys.stderr,
              flush=True)

    def traced(self, fn):
        """(Trace, fn()) of `fn` run under the profiler, synchronised at
        both ends."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        from harness import trace
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        prof = profile(activities=acts)
        called = time.perf_counter()
        prof.start()
        t0 = time.time_ns()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.time_ns()
        prof.stop()
        got = trace.capture(prof, t0, t1)
        self.tracing_overhead.append((called, time.perf_counter()))
        return got, out


def end_to_end(name: str, out: Dict) -> float:
    rec = out["run"]
    if name == "setup_s":
        return out["setup_s"]
    if name in ("train_tokens_per_s", "serve_tokens_per_s"):
        return rec.tokens / rec.window_s
    raise KeyError(f"the harness computes no end-to-end metric {name!r}")


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, faults: Tuple[str, ...] = (),
             t_start: Optional[float] = None) -> Dict:
    """One run of one cell on `device`; the result line as a dict."""
    import torch
    from harness import checks, flops, spec
    from harness import serve as serve_driver
    from harness import train as train_driver
    cell = spec.cell(root, workload)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    try:
        peaks = flops.peaks(name)
    except KeyError:
        peaks = flops.peaks("H100") if device.type == "cpu" else {}
    ctx = Ctx(cell, seed, seconds, trace, device, peaks,
              T_START if t_start is None else t_start, tuple(faults))
    driver = {"train": train_driver, "serve": serve_driver}[
        cell.mix["kind"]]
    out = driver.run(ctx)
    rec = out["run"]
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(root, m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": end_to_end(m["name"], out),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": name, "count": 1,
                   "memory_peak_bytes": out["memory_peak"]}
    result = {"correct": checks.verdict(out["numbers"], cell.limits),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    if trace and rec.trace is not None:
        device_info["busy_s"] = rec.trace.busy_s()
        device_info["window_s"] = rec.trace.span_s
        result["breakdown"] = {"device_ops": rec.trace.top_ops(),
                               "idle_gaps": rec.trace.idle_gaps()}
    for k, v in out["numbers"].items():
        if k not in cell.limits:
            ctx.log(f"reading {k} {v!r} (not compared)")
    result["checks"] = {k: {"value": out["numbers"].get(k), "limit": lim}
                        for k, lim in cell.limits.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = ROOT
    cache_env(root)
    paths(root)
    import torch
    from harness import spec
    chips = spec.cell(root, args.workload).spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_loaded()
    if bad:
        print(f"perfbench: the process loaded {bad}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(finite(result)))
    return 0


def finite(x):
    """x with every non-finite float as null (strict JSON)."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


if __name__ == "__main__":
    sys.exit(main())
