"""A checkout-shaped root for the harness's tests: BENCHMARK.json with
test-sized cells and their files under perfbench/, the real metric
readers, families and references beside them. The training cells take
BENCHMARK.json's metrics; the serving cell, which BENCHMARK.json has none
for yet, takes those of data/serve_metrics.json. Run on the CPU with the port's plain PyTorch
paths."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
DATA = Path(__file__).resolve().parent / "data"

for p in (str(BENCH), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = {
    "tiny-dense-train": ("tiny-dense", "tiny-train"),
    "tiny-dense-serve": ("tiny-dense", "tiny-serve"),
}


def make_root(tmp: Path) -> Path:
    """tmp as a root holding the test cells; returns it."""
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    serving = json.loads((DATA / "serve_metrics.json").read_text())
    pb = tmp / "perfbench"
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "families", "reference"):
        shutil.copytree(BENCH / sub, pb / sub, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for f in (DATA / "configs").iterdir():
        shutil.copy(f, pb / "configs" / f.name)
    for f in (DATA / "traffic").iterdir():
        shutil.copy(f, pb / "traffic" / f.name)
    workloads = []
    for name, (config, traffic) in CELLS.items():
        lim = "tiny-serve" if traffic == "tiny-serve" else "tiny-train"
        shutil.copy(DATA / "limits" / f"{lim}.json",
                    pb / "limits" / f"{name}.json")
        workloads.append({"name": name, "config": config, "traffic": traffic,
                          "chips": 1, "why": "test size"})
    trains = [w["name"] for w in workloads if "train" in w["name"]]
    serves = [w["name"] for w in workloads if "serve" in w["name"]]

    def remap(metric, cells):
        m = dict(metric)
        if "workloads" in m or cells is serves:
            m["workloads"] = cells
        return m
    bench = dict(real)
    bench["configs"] = [{"name": "tiny-dense", "source": "test",
                         "file": "perfbench/configs/tiny-dense.json",
                         "reduced": [], "why": "test size"}]
    bench["workloads"] = workloads
    for key in ("end_to_end", "per_layer"):
        bench[key] = [remap(m, trains) for m in real[key]] + [
            remap(m, serves) for m in serving[key]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp
