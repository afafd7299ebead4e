"""Whole runs of test-sized cells on the CPU (the port's plain PyTorch
paths): the result line's shape, `correct` on sound runs, and `correct`
false with the timed path broken underneath or the control (the reference
in fp8) in the program's place."""
import math
import time

import pytest
import torch

import perfbench_testroot as tr
import run as runner
from harness import checks, flops, spec
from harness import serve as serve_driver
from harness import train as train_driver

SEED = 2 ** 31 + 12345
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tr.make_root(tmp_path_factory.mktemp("root"))


def run_cell(root, cell, trace=False, faults=(), seed=SEED):
    return runner.run_cell(root, cell, seed, 1.0, trace, CPU, faults,
                           t_start=time.perf_counter())


@pytest.mark.parametrize("cell", ["tiny-dense-train", "tiny-dense-serve"])
def test_sound_run_is_correct(root, cell):
    res = run_cell(root, cell)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in spec.cell(root, cell).end_to_end}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    for k, v in res["checks"].items():
        assert v["value"] <= v["limit"]


@pytest.mark.parametrize("cell,fault", [
    ("tiny-dense-train", "unchanged_state"),
    ("tiny-dense-train", "half_batch"),
    ("tiny-dense-serve", "altered_token"),
])
def test_broken_timed_path_is_not_correct(root, cell, fault):
    res = run_cell(root, cell, faults=(fault,))
    assert res["correct"] is False, res["checks"]


def test_traced_run_reports_per_layer_metrics(root):
    res = run_cell(root, "tiny-dense-train", trace=True)
    assert "step_ms_p50.train" in res["metrics"]
    assert "mfu.train" in res["metrics"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    serve = run_cell(root, "tiny-dense-serve", trace=True)
    assert {"tick_ms_p50.serve", "mfu.serve",
            "sender_lag_p95_ms.serve"} <= set(serve["metrics"])


def test_a_traced_run_traces_past_a_step_that_outlasts_the_window(root):
    res = runner.run_cell(root, "tiny-dense-train", SEED + 2, 1e-3, True,
                          CPU, t_start=time.perf_counter())
    assert res["correct"] is True, res["checks"]
    assert res["device"]["window_s"] > 0
    assert {"step_ms_p50.train", "mfu.train"} <= set(res["metrics"])


def _ctx(root, cell, seed):
    return runner.Ctx(spec.cell(root, cell), seed, 0.0, False, CPU,
                      flops.peaks("H100"), time.perf_counter(), check=False)


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_train_control_is_not_correct(root, seed):
    ctx = _ctx(root, "tiny-dense-train", seed)
    prog = train_driver.run(ctx)
    base, c0, tcfg = prog["inputs"]
    batches = train_driver.checked_batches(ctx)
    model = ctx.cell.reference
    ref = checks.train_reference(model, ctx.cell.cfg, base, c0, batches,
                                 tcfg)
    assert checks.verdict(checks.train_gaps(ref, **prog["readings"]),
                          ctx.cell.limits)
    ctl = checks.train_reference(model, ctx.cell.cfg, base, c0, batches,
                                 tcfg, linear="fp8")
    assert not checks.verdict(checks.train_gaps(ref, **ctl),
                              ctx.cell.limits)


def test_serve_control_is_not_correct(root):
    ctx = _ctx(root, "tiny-dense-serve", SEED)
    ctx.seconds = 1.0
    out = serve_driver.run(ctx)
    base, coeffs = out["inputs"]
    cfg, limits = ctx.cell.cfg, ctx.cell.limits
    model = ctx.cell.reference
    assert checks.verdict(checks.serve_numbers(model, cfg, base,
                                               out["sample"], coeffs), limits)
    assert not checks.verdict(checks.serve_numbers(
        model, cfg, base, out["sample"], coeffs, linear="fp8"), limits)


def test_a_refused_request_misses_every_latency_limit(root):
    ctx = _ctx(root, "tiny-dense-serve", SEED)
    ctx.seconds = 1.0
    # a cache too short for the mix's longest prompts: the scheduler
    # refuses those at submission
    ctx.cell.mix.update(max_len=40, warm_prompts=[8, 16, 32])
    out = serve_driver.run(ctx)
    rec = out["run"]
    assert out["failed"] > 0
    assert sum(math.isinf(x) for x in rec.ttft_s) == out["failed"]
    assert sum(math.isinf(x) for x in rec.tpot_s) == out["failed"]


@pytest.mark.cuda
def test_tiny_cells_on_the_card(root):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for cell in ("tiny-dense-train", "tiny-dense-serve"):
        res = runner.run_cell(root, cell, SEED, 2.0, True,
                              torch.device("cuda", 0),
                              t_start=time.perf_counter())
        assert res["correct"] is True, res["checks"]
        assert res["device"]["busy_s"] > 0
