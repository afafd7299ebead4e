"""The benchmark's files against its contract: BENCHMARK.json's shape, what
the harness and the reference may import, how the harness fails without a
card or without the program, and that a new configuration, mix, cell and
per-layer metric are taken from new files alone."""
import ast
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import perfbench_testroot as tr
import run as runner
from harness import spec

BENCH = json.loads((tr.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"]) and _line(
            c["source"])
        assert c["file"].startswith("perfbench/")
        assert (tr.REPO / c["file"]).is_file()
        cfg = json.loads((tr.REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
    cells = [w["name"] for w in BENCH["workloads"]]
    assert len(set(cells)) == len(cells)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (tr.BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (tr.BENCH / "limits" / f"{w['name']}.json").is_file()
    assert {w["config"] for w in BENCH["workloads"]} == set(names)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_metrics_follow_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] == 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    layers = {}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(moved)
        if "roofline" in m["name"] or "mfu" in m["name"] \
                or "share" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        has = [m for m in BENCH["end_to_end"]
               if cell in m.get("workloads", cells)]
        assert len(has) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert (tr.BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_a_full_check_fits_with_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(tr.BENCH.rglob("*.py"))
    assert files
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "repro"), (f, mod)


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((tr.BENCH / "reference").rglob("*.py")):
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top in ("__future__", "math", "typing", "numpy", "torch",
                           "reference"), (f, mod)


def test_the_run_refuses_a_process_that_loaded_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert "repro" in runner.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert "repro_torch_like" not in runner.forbidden_loaded()


def _run(cwd: Path, *extra):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "yi6b-train-sft1k",
         "--seed", "3", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=240,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(cwd)})


def _no_result(proc):
    last = proc.stdout.strip().splitlines()[-1:] or [""]
    return proc.returncode != 0 and not last[0].startswith("{")


def test_fails_without_a_card():
    proc = _run(tr.REPO)
    assert _no_result(proc)
    assert "CUDA device" in proc.stderr


def test_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copy(tr.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(tr.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert _no_result(_run(tmp_path))


@pytest.mark.parametrize("extra", [{"num_experts": 8},
                                   {"model": {"qk_norm": True}}])
def test_a_config_the_reference_does_not_cover_is_refused(extra):
    cfg = json.loads((tr.DATA / "configs" / "tiny-dense.json").read_text())
    cfg.update(extra)
    with pytest.raises(ValueError, match="dense decoder"):
        spec.family(cfg, tr.REPO).model_config(cfg)


def test_new_files_add_a_config_mix_cell_and_metric(tmp_path):
    root = tr.make_root(tmp_path)
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "tiny-dense.json").read_text())
    cfg.update(name="tiny-dense-wide", intermediate_size=192)
    (pb / "configs" / "tiny-dense-wide.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "tiny-train.json").read_text())
    mix.update(batch=2, seq=48)
    (pb / "traffic" / "tiny-train-b2.json").write_text(json.dumps(mix))
    shutil.copy(pb / "limits" / "tiny-dense-train.json",
                pb / "limits" / "tiny-wide-b2.json")
    (pb / "metrics" / "tokens_per_step.train.py").write_text(
        "def read(run):\n"
        "    if run.kind != 'train' or not run.step_s:\n"
        "        return None\n"
        "    return run.mix['batch'] * run.mix['seq']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-dense-wide", "source": "test",
                             "file": "perfbench/configs/tiny-dense-wide.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-wide-b2",
                               "config": "tiny-dense-wide",
                               "traffic": "tiny-train-b2", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny-dense-train" in m.get("workloads", ()):
            m["workloads"].append("tiny-wide-b2")
    bench["per_layer"].append({
        "name": "tokens_per_step.train", "unit": "tokens", "better": "higher",
        "source": "host_clock", "layer": "train step",
        "moves": "train_tokens_per_s", "workloads": ["tiny-wide-b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell(root, "tiny-wide-b2")
    assert cell.cfg["intermediate_size"] == 192 and cell.mix["seq"] == 48
    res = runner.run_cell(root, "tiny-wide-b2", 77, 1.0, True,
                          torch.device("cpu"), t_start=time.perf_counter())
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["tokens_per_step.train"]["value"] == 96
