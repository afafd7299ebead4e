"""Finding a cell's files by the names in BENCHMARK.json.

A cell (an entry of `workloads`) names a configuration, whose `file` is
given in `configs`, and a traffic mix, read from
`perfbench/traffic/<traffic>.json`. The limits of the numbers its
correctness check compares are `perfbench/limits/<cell>.json`. Each
per-layer metric is read by `perfbench/metrics/<metric>.py`. A later cell,
mix, configuration or metric is a new file and a new entry: nothing here
changes.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

DIR = "perfbench"               # the harness's folder under the root


@dataclass
class Cell:
    name: str
    root: Path                  # the checkout's root (BENCHMARK.json's)
    spec: Dict                  # the workloads entry
    cfg: Dict                   # the configuration file
    mix: Dict                   # the traffic file
    limits: Dict                # {number: limit}
    end_to_end: List[Dict]      # the metrics this cell reports untraced
    per_layer: List[Dict]       # ... and traced


def load_bench(root: Path) -> Dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root: Path, name: str) -> Cell:
    root = Path(root)
    bench = load_bench(root)
    spec = next((w for w in bench["workloads"] if w["name"] == name), None)
    if spec is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == spec["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / DIR / "traffic"
                      / f"{spec['traffic']}.json").read_text())
    lim_path = root / DIR / "limits" / f"{name}.json"
    limits = json.loads(lim_path.read_text())["limits"]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    layer = [m for m in bench["per_layer"] if _applies(m, name)]
    return Cell(name, root, spec, cfg, mix, limits, e2e, layer)


def reader(root: Path, metric: str) -> Callable:
    """`read` of perfbench/metrics/<metric>.py."""
    path = Path(root) / DIR / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
