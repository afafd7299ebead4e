"""Finding a cell's files by the names in BENCHMARK.json.

A cell (an entry of `workloads`) names a configuration, whose `file` is
given in `configs`, and a traffic mix, read from
`perfbench/traffic/<traffic>.json`. The limits of the numbers its
correctness check compares are `perfbench/limits/<cell>.json`. Each
per-layer metric is read by `perfbench/metrics/<metric>.py`.

A configuration's `reference` key names its model family, two modules:
`perfbench/families/<reference>.py`, the harness's side (`model_config`,
`adapted_sites`, `base_layout`, `attention_shape`, and the required
operations `train_step_ops`, `prefill_ops` and `decode_ops`), and
`perfbench/reference/<reference>.py`, the plain PyTorch model the check
runs (`Dims`, `entries_for`, `loss_and_grads`, `logits_at`, `LINEARS`,
`plain_linear` and `precise`). Both are loaded by path from the checkout's
root, as a metric's reader is. A later cell, mix, configuration, family or
metric is new files and a new entry: nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

DIR = "perfbench"               # the harness's folder under the root
_LOADED: Dict[Path, ModuleType] = {}


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

    @property
    def family(self) -> ModuleType:
        return family(self.cfg, self.root)

    @property
    def reference(self) -> ModuleType:
        return reference(self.cfg, self.root)


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


def _load(root: Path, folder: str, name: str) -> ModuleType:
    """perfbench/<folder>/<name>.py of the root, loaded once by path."""
    path = (Path(root) / DIR / folder / f"{name}.py").resolve()
    if path not in _LOADED:
        if not path.is_file():
            raise FileNotFoundError(f"no {folder} module {name!r} at {path}")
        mod_name = "perfbench_" + "_".join(
            (folder, name.replace(".", "_").replace("-", "_")))
        mod_spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(mod_spec)
        # a dataclass looks its module up in sys.modules while it is made
        sys.modules[mod_name] = mod
        mod_spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def family(cfg: Dict, root: Path) -> ModuleType:
    """The harness's side of the configuration's family:
    perfbench/families/<reference>.py."""
    return _load(root, "families", cfg["reference"])


def reference(cfg: Dict, root: Path) -> ModuleType:
    """The plain model of the configuration's family:
    perfbench/reference/<reference>.py."""
    return _load(root, "reference", cfg["reference"])


def reader(root: Path, metric: str) -> Callable:
    """`read` of perfbench/metrics/<metric>.py."""
    return _load(root, "metrics", metric).read
