"""The port's static analyzer (`repro_torch.analysis`) against seeded
regressions, and against the JAX package's analyzer where the two share a
surface.

- The source lint, the kernel audit, the dispatch lint and the baseline
  gate each catch a seeded regression (a host sync in a loop, truthiness
  of a tensor in an autograd Function, a draw from the global RNG, a
  loosened kernel limit, an out-of-place optimizer update, ...) and pass
  the conservative or correct variant.
- The report module is a copy of JAX's: the same findings render, diff and
  gate identically and write the same baseline file.
- The scheduler's signature contract: JAX's and the port's schedulers
  replay the same tiny paged trace (and its SelfDrafter(k=2) variant) with
  equal `expected_compile_bounds()` and equal `compiled_signatures()` on
  every key (no gap on these traces).
- The CLI gates the tree clean against the committed baseline, and
  `launch.serve --analyze` prints the reference launcher's lines.
- chip_smoke's phase 20 rehearses on the CPU at reduced configs.

CPU only; the card's shared-memory audit is `cuda`-marked and skips here.
"""
import dataclasses
import json
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.analysis.report as jax_report
from repro.kernels import ops as jax_ops
from repro_torch.analysis import (ast_lint, dispatch_lint, graphs,
                                  kernel_audit, report)
from repro_torch.analysis import __main__ as cli
from repro_torch.kernels import api as kernel_api
from repro_torch.kernels import fft_plan
from repro_torch.kernels import paged_attention as pak

ROOT = Path(__file__).resolve().parents[1]


def _rules(src):
    return [f.rule for f in ast_lint.lint_source(textwrap.dedent(src))]


# ---------------------------------------------------------------------------
# source lint
# ---------------------------------------------------------------------------

class TestAstLint:
    def test_item_in_loop_flagged_and_fails_gate(self):
        src = """
        import torch
        def drain(xs):
            total = 0.0
            for x in xs:
                total += x.item()
            return total
        """
        found = ast_lint.lint_source(textwrap.dedent(src), "m.py")
        assert [f.rule for f in found] == ["host-sync-in-loop"]
        assert report.gate(found, {}) == 1
        assert report.gate(found, {found[0].key: "justified"}) == 0

    def test_cpu_and_tolist_outside_a_loop_are_host_syncs(self):
        assert _rules("""
        def f(t):
            a = t.cpu()
            return t.tolist()
        """) == ["host-sync", "host-sync"]

    def test_numpy_values_are_not_flagged(self):
        assert _rules("""
        import numpy as np
        def f(a):
            b = np.asarray(a)
            for i in range(3):
                b.tolist()
            return np.zeros(3).tolist()
        """) == []

    def test_int_of_a_device_expression(self):
        assert _rules("""
        import torch
        def f(x):
            y = torch.argmax(x)
            return int(y), int(x.shape[0])
        """) == ["host-sync"]

    def test_bool_in_autograd_function_forward(self):
        src = """
        import torch
        class Scale(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                y = torch.abs(x).max()
                if bool(y > 0):
                    return x / y
                return x
        """
        assert _rules(src) == ["tracer-bool"]

    def test_truthiness_under_compile_and_graph_capture(self):
        assert _rules("""
        import torch
        def body(x):
            y = torch.sum(x)
            if y:
                return x
            return -x
        fast = torch.compile(body)
        def step(g, x):
            with torch.cuda.graph(g):
                z = x.clone()
                while z.any():
                    z = z - 1
        """) == ["tracer-bool", "tracer-bool"]

    def test_same_pattern_outside_capture_is_a_host_sync(self):
        assert _rules("""
        import torch
        def f(x):
            if bool(torch.sum(x) > 0):
                return x
        """) == ["host-sync"]

    def test_global_rng(self):
        assert _rules("""
        import torch
        def f(gen):
            torch.manual_seed(0)
            a = torch.rand(3)
            b = torch.randn(3, generator=gen)
            c = torch.empty(3).normal_()
            d = torch.empty(3).uniform_(generator=gen)
            return a, b, c, d
        """) == ["rng-global", "rng-global", "rng-global"]

    def test_generator_seed_is_not_global(self):
        assert _rules("""
        import torch
        def f():
            g = torch.Generator()
            g.manual_seed(0)
            return torch.randint(0, 9, (3,), generator=g)
        """) == []

    def test_suppression_on_line_and_line_above(self):
        assert _rules("""
        def f(t):
            a = t.item()  # repro: allow(host-sync)
            # repro: allow(host-sync)
            return t.cpu()
        """) == []

    def test_suppression_is_rule_specific(self):
        src = """
        import torch
        def f(xs):
            torch.manual_seed(0)  # repro: allow(host-sync)
            for x in xs:
                x.item()  # repro: allow(host-sync)
        """
        assert _rules(src) == ["rng-global", "host-sync-in-loop"]

    def test_attribute_assign_does_not_poison_self(self):
        assert _rules("""
        import torch
        class A:
            def f(self, x):
                self.buf = torch.zeros(3)
                return int(self.n)
        """) == []

    def test_reassignment_clears_device_name(self):
        assert _rules("""
        import torch
        def f():
            x = torch.zeros(3)
            x = 3
            return int(x)
        """) == []

    def test_synchronize_calls(self):
        assert _rules("""
        import torch
        def f(stream, xs):
            torch.cuda.synchronize()
            for x in xs:
                stream.synchronize()
        """) == ["host-sync", "host-sync-in-loop"]

    def test_tree_findings_are_all_known(self):
        found = cli._ast_findings([])
        base = report.load_baseline()
        assert report.gate(found, base) == 0, report.render(found, base)
        assert all(f.rule in ast_lint.RULES for f in found)


# ---------------------------------------------------------------------------
# kernel audit
# ---------------------------------------------------------------------------

def _op(method="fourierft", **changes):
    kernel_api.all_ops()
    op = next(o for o in kernel_api.all_ops()
              if o.op == "deltaw" and o.method == method
              and o.backend == "cuda" and o.caps)
    return dataclasses.replace(op, **changes)


def _k3_op(**changes):
    op = next(o for o in kernel_api.all_ops() if o.op == "paged_attention"
              and o.backend == "cuda")
    return dataclasses.replace(op, **changes)


@pytest.fixture(autouse=False)
def fresh_plans():
    """fft_plan memoizes plans and radices: a plan made while a limit was
    monkeypatched loose must not outlive the patch."""
    fft_plan.fft_plan.cache_clear()
    fft_plan.factor.cache_clear()
    yield
    fft_plan.fft_plan.cache_clear()
    fft_plan.factor.cache_clear()


@pytest.mark.usefixtures("fresh_plans")
class TestKernelAudit:
    def test_derived_limits_exact(self):
        f = kernel_audit.derived_fft_limits(fft_plan.FOURIER_CAPS)
        # a row over a cluster of two blocks: 2 x 232448 / 8 points
        assert f == {"MAX_D2": 58112, "MAX_D1": 65536, "MAX_N": 28544,
                     "MAX_RADIX": 63}
        d = kernel_audit.derived_fft_limits(fft_plan.DCT_CAPS)
        assert d["MAX_D1"] == 2 ** 29 and d["MAX_D2"] == 58112
        one_block = dict(fft_plan.FOURIER_CAPS, cluster=1)
        assert kernel_audit.derived_fft_limits(one_block)["MAX_D2"] == 29056
        signed = dict(fft_plan.FOURIER_CAPS, phase_signed=True)
        assert kernel_audit.derived_d1(signed) == 46341
        k3 = kernel_audit.derived_k3(pak.CAPS)
        assert k3 == {"MAX_HEAD_DIM": 256, "MAX_ROWS": {True: 64, False: 32}}
        sizes = {(dt, hc): b for dt, hc, _, _, b in kernel_audit.k3_instances(
            pak.CAPS, pak.MAX_HEAD_DIM, pak.MAX_ROWS)}
        assert sizes[("bfloat16", 256)] == 102400
        assert sizes[("float32", 256)] == 103296

    def test_registry_clean_but_for_the_reference_gap(self, monkeypatch):
        """The cluster path takes every width the JAX package's routes take
        (46336 Fourier, 32500 DCT), so the registry is clean; at one
        block's 29056 the gap to the reference would show again."""
        found = kernel_audit.run()
        assert found == []
        assert report.gate(found, report.load_baseline()) == 0
        monkeypatch.setattr(fft_plan, "MAX_D2", fft_plan.CTA_ROW)
        gap = kernel_audit.reference_findings()
        assert {f.rule for f in gap} == {"limit-below-reference"}
        assert {f.where for f in gap} == {"deltaw/fourierft/cuda/MAX_D2",
                                          "deltaw/dct/cuda/MAX_D2"}

    def test_reference_limits_are_the_jax_packages(self):
        assert kernel_audit.REFERENCE_LIMITS == {
            "fourier": jax_ops.FOURIER_INT32_SAFE_DIM,
            "dct": jax_ops.DCT_INT32_SAFE_DIM}

    @pytest.mark.parametrize("name,value", [("MAX_D2", 58113),
                                            ("MAX_D1", 65537),
                                            ("MAX_N", 28560)])
    def test_loosened_limit_fails_the_gate(self, monkeypatch, name, value):
        monkeypatch.setattr(fft_plan, name, value)
        found = kernel_audit.audit_registry([_op()])
        assert any(f.rule == "bound-loosened"
                   and f.where.endswith("/" + name) for f in found)
        assert report.gate(found, report.load_baseline()) == 1

    def test_conservative_limit_passes(self, monkeypatch):
        monkeypatch.setattr(fft_plan, "MAX_D2", 16384)
        monkeypatch.setattr(fft_plan, "MAX_N", 8192)
        assert kernel_audit.audit_registry([_op(), _op("dct")]) == []

    def test_signed_phase_product_loosens_max_d1(self):
        caps = dict(fft_plan.FOURIER_CAPS, phase_signed=True)
        found = kernel_audit.audit_registry([_op(caps=caps)])
        # the declared MAX_D1 is above the derivation, and accepts admits
        # the first d1 past it
        assert {(f.rule, f.where) for f in found} == {
            ("bound-loosened", "deltaw/fourierft/cuda/MAX_D1"),
            ("bound-missing", "deltaw/fourierft/cuda/MAX_D1")}
        assert all("46341" in f.message for f in found)

    def test_missing_or_permissive_accepts(self):
        missing = kernel_audit.audit_registry([_op(accepts=None)])
        assert [f.rule for f in missing] == ["bound-missing"]
        lax = kernel_audit.audit_registry(
            [_op(accepts=lambda *a: (True, ""))])
        assert {f.where.rsplit("/", 1)[1] for f in lax} == {
            "MAX_D2", "MAX_D1", "MAX_N", "MAX_RADIX"}

    def test_k3_limits(self, monkeypatch):
        assert kernel_audit.audit_registry([_k3_op()]) == []
        monkeypatch.setattr(pak, "MAX_HEAD_DIM", 512)
        assert any(f.rule == "bound-loosened"
                   for f in kernel_audit.audit_registry([_k3_op()]))
        monkeypatch.setattr(pak, "MAX_HEAD_DIM", 256)
        tight = dict(pak.CAPS, smem_bytes=100_000)
        over = kernel_audit.audit_registry([_k3_op(caps=tight)])
        assert {f.rule for f in over} == {"smem-over-budget"}
        assert {f.where for f in over} == {
            "paged_attention/attention/cuda/bfloat16/256",
            "paged_attention/attention/cuda/float32/256"}

    def test_unknown_caps_and_capless_ops(self):
        found = kernel_audit.audit_registry([_op(caps={"kind": "tiles"})])
        assert [f.rule for f in found] == ["unknown-caps"]
        plain = [o for o in kernel_api.all_ops() if o.backend == "einsum"]
        assert plain and kernel_audit.audit_registry(plain) == []

    def test_constant_drift_against_the_sources(self, monkeypatch, tmp_path):
        assert kernel_audit.declared_constants_findings() == []
        monkeypatch.setattr(fft_plan, "MAX_N", 16000)
        found = kernel_audit.declared_constants_findings()
        assert {f.where for f in found} == {"fft_plan.MAX_N"}
        monkeypatch.setattr(fft_plan, "MAX_N", 16384)
        for src in kernel_audit.CSRC.iterdir():
            (tmp_path / src.name).write_text(src.read_text())
        cu = tmp_path / "paged_attention.cu"
        cu.write_text(cu.read_text().replace(
            "run_f32<256, 16, 32>", "run_f32<256, 8, 32>"))
        found = kernel_audit.declared_constants_findings(tmp_path)
        assert [f.where for f in found] == ["paged_attention.CAPS.classes"]

    def test_cluster_caps_need_the_cluster_launch(self, tmp_path):
        """The caps' cluster of two (MAX_D2 = 2 x one block's row) holds
        only while fft_rows.cuh declares FFT_CLUSTER 2 and launches such a
        cluster after checking that it fits."""
        for src in kernel_audit.CSRC.iterdir():
            (tmp_path / src.name).write_text(src.read_text())
        rows = tmp_path / "fft_rows.cuh"
        text = rows.read_text()
        assert kernel_audit.declared_constants_findings(tmp_path) == []
        rows.write_text(text.replace("cudaOccupancyMaxActiveClusters",
                                     "cudaOccupancyMaxActiveBlocks"))
        found = kernel_audit.declared_constants_findings(tmp_path)
        assert {f.where for f in found} == {"fft_plan.FOURIER_CAPS.cluster",
                                            "fft_plan.DCT_CAPS.cluster"}
        assert all(f.rule == "constant-drift" for f in found)
        rows.write_text(text.replace("FFT_CLUSTER = 2;", "FFT_CLUSTER = 4;"))
        found = kernel_audit.declared_constants_findings(tmp_path)
        assert {f.where for f in found} == {"fft_plan.CLUSTER",
                                            "fft_plan.FOURIER_CAPS.cluster",
                                            "fft_plan.DCT_CAPS.cluster"}

    @pytest.mark.cuda
    def test_the_cards_shared_memory_holds_every_request(self):
        if not torch.cuda.is_available():
            pytest.skip("no CUDA device: the audit reads the card")
        assert kernel_audit.device_smem_optin("cuda") >= 232448
        assert kernel_audit.audit_device("cuda") == []


# ---------------------------------------------------------------------------
# dispatch lint
# ---------------------------------------------------------------------------

class TestDispatchLint:
    def test_item_in_a_loop_region(self):
        rec = dispatch_lint.DispatchRecorder("cpu")
        x = torch.arange(6.0)
        with rec:
            for _ in range(3):
                with rec.region("step", loop=True):
                    for i in range(2):
                        float(x[i] * 2)
            with rec.region("once"):
                torch.nonzero(x > 2)
                x[x > 3]
        found = {f.where: f for f in rec.findings()}
        assert found["step/_local_scalar_dense"].rule == \
            "host-transfer-in-loop"
        assert found["step/_local_scalar_dense"].mult == 2
        assert "test_torch_analysis.py" in \
            found["step/_local_scalar_dense"].message
        assert found["once/nonzero"].rule == "host-transfer"
        assert found["once/index[bool]"].mult == 1
        assert rec.summary("step")["transfers_per_region"] == 2

    def test_upcast_f32_literal(self):
        rec = dispatch_lint.DispatchRecorder("cpu")
        x = torch.ones(4, dtype=torch.bfloat16)
        with rec:
            with rec.region("f"):
                x.float() * torch.tensor(2.0)      # typed f32 constant
                x.float() * 2.0                    # weak: stays weak
                x.float() + torch.ones(4)          # not a 0-dim constant
        found = rec.findings()
        assert [(f.rule, f.where) for f in found] == [
            ("upcast-f32-literal", "f/mul")]

    def test_the_optimizers_update_is_out_of_place(self):
        from repro_torch.configs.base import TrainConfig
        from repro_torch.optim import adamw
        params = {"c": torch.ones(16)}
        opt = adamw.init(params)
        state = {"trainable": params, "opt": opt}
        before = dispatch_lint.data_ptrs(state)
        new_p, new_opt = adamw.update({"c": torch.full((16,), 0.5)}, opt,
                                      params, 1e-2, TrainConfig())
        found = dispatch_lint.donation_findings(
            before, {"trainable": new_p, "opt": new_opt}, "adamw")
        assert [(f.rule, f.mult) for f in found] == [("donation-miss", 4)]

    def test_out_of_place_update_is_a_donation_miss(self):
        p = {"w": torch.ones(8), "opt": {"mu": torch.zeros(8)}}
        before = dispatch_lint.data_ptrs(p)
        new = {"w": p["w"] - 0.1, "opt": {"mu": p["opt"]["mu"] * 0.9}}
        found = dispatch_lint.donation_findings(before, new, "step")
        assert [f.rule for f in found] == ["donation-miss"]
        assert found[0].mult == 2 and "64 bytes" in found[0].message
        p["w"].sub_(0.1)
        p["opt"]["mu"].mul_(0.9)
        assert dispatch_lint.donation_findings(before, p, "step") == []

    def test_recompile_budget(self):
        found = dispatch_lint.recompile_findings(
            {"decode": 3, "reset": 1, "prefill": 9}, {"decode": 1,
                                                      "reset": 1}, "serve")
        assert [f.where for f in found] == ["serve/decode"]
        assert found[0].rule == "recompile-budget"

    def test_graphs_gate_clean(self):
        found = graphs.run("cpu")
        assert report.gate(found, report.load_baseline()) == 0, \
            report.render(found, report.load_baseline())
        assert {f.where for f in found if f.rule == "donation-miss"} == {
            "train_step"}


# ---------------------------------------------------------------------------
# report parity and the baseline
# ---------------------------------------------------------------------------

_FINDINGS = [("ast", "host-sync", "a.py:3", "sync", 1.0),
             ("dispatch", "host-transfer-in-loop", "serve/decode/copy_d2h",
              "drain", 0.25),
             ("kernels", "bound-loosened", "deltaw/x/cuda/MAX_D2", "wide",
              1.0)]


def test_report_matches_the_jax_module(tmp_path):
    mine = [report.Finding(*f) for f in _FINDINGS]
    theirs = [jax_report.Finding(*f) for f in _FINDINGS]
    base = {mine[0].key: "known", "gone:rule:x": "stale"}
    assert report.render(mine, base) == jax_report.render(theirs, base)
    assert report.render([], {}) == jax_report.render([], {})
    assert report.to_json(mine, base) == jax_report.to_json(theirs, base)
    assert [f.key for f in report.diff(mine, base)[0]] == \
        [f.key for f in jax_report.diff(theirs, base)[0]]
    assert report.diff(mine, base)[1] == jax_report.diff(theirs, base)[1]
    assert report.gate(mine, base) == jax_report.gate(theirs, base) == 1
    report.save_baseline(mine, str(tmp_path / "a.json"), old=base)
    jax_report.save_baseline(theirs, str(tmp_path / "b.json"), old=base)
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()
    assert report.load_baseline(str(tmp_path / "a.json"))[mine[0].key] == \
        "known"


def test_committed_baseline_is_justified():
    with open(report.DEFAULT_BASELINE) as f:
        data = json.load(f)
    assert data["version"] == report.BASELINE_VERSION
    assert data["findings"]
    for key, why in data["findings"].items():
        assert len(why) > 40 and "TODO" not in why, key
    assert any("engine.py:" in k and "tolist" not in k
               for k in data["findings"])
    # the FFT kernels' gap to the reference's widths closed with the
    # cluster path: no finding of it is baselined any more
    assert not any("limit-below-reference" in k for k in data["findings"])


# ---------------------------------------------------------------------------
# the scheduler's signature contract against JAX's
# ---------------------------------------------------------------------------

def _jax_sched(budgets, drafter):
    import repro.configs as jc
    from repro.configs.base import PEFTConfig as JaxPEFT
    from repro.models import registry
    from repro.serve import ContinuousScheduler, Engine, Request, SelfDrafter
    cfg = jc.reduced(jc.get("yi-6b")).replace(
        vocab=64, dtype="float32", param_dtype="float32")
    model = registry.build(cfg, JaxPEFT(method="none"))
    eng = Engine(model, model.init(jax.random.PRNGKey(0)), batch_slots=2,
                 max_len=32)
    sched = ContinuousScheduler(eng, page_size=8, drafter=SelfDrafter(k=2)
                                if drafter else None)
    sched.serve([Request(prompt=jnp.asarray([(3 * i + j) % 64
                                             for j in range(3 + i)],
                                            jnp.int32), max_new=b)
                 for i, b in enumerate(budgets)])
    return sched


@pytest.mark.parametrize("budgets,drafter", [([3, 2, 4], False),
                                             ([4, 3], True)],
                         ids=["paged", "self_drafter"])
def test_signatures_match_the_jax_scheduler(budgets, drafter):
    from repro_torch.serve import ContinuousScheduler, Engine, SelfDrafter
    model = graphs.tiny_serve_model()
    eng = Engine(model, model.init(0, "cpu"), batch_slots=2, max_len=32,
                 device="cpu")
    mine = ContinuousScheduler(eng, page_size=8, drafter=SelfDrafter(k=2)
                               if drafter else None)
    mine.serve(graphs.tiny_trace(budgets))
    theirs = _jax_sched(budgets, drafter)
    assert mine.expected_compile_bounds() == theirs.expected_compile_bounds()
    # the port has a dispatch point for every JAX graph: the same keys,
    # and on these traces the same counts (no gap to explain)
    assert mine.compiled_signatures() == theirs.compiled_signatures()
    assert dispatch_lint.scheduler_recompile_findings(mine) == []


def test_signature_overflow_is_caught():
    from repro_torch.serve import ContinuousScheduler, Engine
    model = graphs.tiny_serve_model()
    eng = Engine(model, model.init(0, "cpu"), batch_slots=2, max_len=32,
                 device="cpu")
    sched = ContinuousScheduler(eng, page_size=8, bucket=True)
    sched.serve(graphs.tiny_trace([2, 2]))
    # a second decode shape leaking past the fixed (n_slots, 1) batch
    sched._note("decode", {"tokens": torch.zeros((3, 1), dtype=torch.int32)})
    found = dispatch_lint.scheduler_recompile_findings(sched, "serve")
    assert [f.where for f in found] == ["serve/decode"]


# ---------------------------------------------------------------------------
# the CLI and the launcher
# ---------------------------------------------------------------------------

def test_cli_all_gates_the_tree_clean(capsys, tmp_path):
    out = tmp_path / "report.json"
    assert cli.main(["--all", "--device", "cpu", "--json", str(out)]) == 0
    data = json.loads(out.read_text())
    assert data["n_new"] == 0 and data["n_findings"] > 0
    # the kernel pass is clean since the cluster path closed the FFT
    # kernels' gap to the reference's widths
    assert set(data["counts"]) == {"ast", "dispatch"}
    # stale here: only the copies between card and host, which the CPU
    # has none of (chip_smoke's phase 20 gates them on the card)
    assert all(k.startswith("dispatch:") and k.endswith("/copy_d2h")
               for k in data["stale_baseline"])


def test_cli_fails_on_a_seeded_regression(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("def f(xs):\n    for x in xs:\n        x.item()\n")
    assert cli.main(["--ast", str(bad)]) == 1
    assert "NEW finding" in capsys.readouterr().out
    base = tmp_path / "base.json"
    assert cli.main(["--ast", "--baseline", str(base), "--update-baseline",
                     str(bad)]) == 0
    assert cli.main(["--ast", "--baseline", str(base), str(bad)]) == 0


_SEEDED_SOURCES = {
    "item_in_loop": "def f(xs):\n    for x in xs:\n        x.item()\n",
    "bool_in_forward": textwrap.dedent("""
        import torch
        class F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x if bool(torch.sum(x) > 0) else -x
        """),
    "rand_without_generator": "import torch\nx = torch.rand(3)\n",
}


@pytest.mark.parametrize("case", sorted(_SEEDED_SOURCES) + [
    "loose_max_d2", "loose_max_d1", "loose_max_n", "sync_in_decode"])
@pytest.mark.usefixtures("fresh_plans")
def test_cli_exits_1_on_each_seeded_regression(case, tmp_path, monkeypatch,
                                               capsys):
    if case in _SEEDED_SOURCES:
        bad = tmp_path / "bad.py"
        bad.write_text(_SEEDED_SOURCES[case])
        argv = ["--ast", str(bad)]
    elif case.startswith("loose_"):
        name = case[len("loose_"):].upper()
        monkeypatch.setattr(fft_plan, name, {"MAX_D2": 60000,
                                             "MAX_D1": 70000,
                                             "MAX_N": 28560}[name])
        argv = ["--kernels", "--device", "cpu"]
    else:
        # a stray host read in the decode loop, once per step
        from repro_torch.serve import ContinuousScheduler
        real = ContinuousScheduler.dispatch

        def dispatch(self, name, fn, *args, **kw):
            out = real(self, name, fn, *args, **kw)
            if name == "decode":
                int(out[0][0])
            return out
        monkeypatch.setattr(ContinuousScheduler, "dispatch", dispatch)
        argv = ["--graphs", "--device", "cpu"]
    assert cli.main(argv) == 1
    assert "NEW finding" in capsys.readouterr().out


def test_cli_refuses_sharding_and_a_missing_card(capsys):
    """--sharding runs the ported audit (no device needed; clean on the
    tree); --kernels without a card and without --device refuses."""
    assert cli.main(["--sharding"]) == 0
    assert "NEW finding" not in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--kernels"])
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    assert "--kernels, --sharding and --graphs" in " ".join(
        capsys.readouterr().out.split())


def test_launcher_analyze_prints_the_audit(capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", "yi-6b", "--reduced", "--continuous",
                       "--analyze", "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("analyze:")]
    assert lines[0].startswith("analyze: compiled signatures ")
    assert "decode=1" in lines[0] and "prefill_paged=" in lines[0]
    assert lines[-1] == "analyze: recompile audit clean"
    with pytest.raises(SystemExit, match="--continuous"):
        launch_serve.main(["--arch", "yi-6b", "--reduced", "--analyze",
                           "--device", "cpu"])


# ---------------------------------------------------------------------------
# chip_smoke's phase 20, rehearsed on the CPU
# ---------------------------------------------------------------------------

def test_analysis_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """Phase 20 at reduced configs: the kernels' CUDA routes resolve for
    CPU tensors (their wrappers compute the plain versions there), counted
    as launches; the card's shared memory is read as the H100's."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from repro_torch import configs
    from repro_torch.kernels import fourier_deltaw as fdk
    from repro_torch.models import registry

    monkeypatch.setattr(kernel_api, "_device_type", lambda d: "cuda")
    monkeypatch.setattr(kernel_audit, "device_smem_optin", lambda d: 232448)
    real_deltaw, real_dc = fdk.deltaw, fdk.dc

    def deltaw(*a):
        fdk.launches += 1
        return real_deltaw(*a)

    def dc(*a):
        fdk.dc_launches += 1
        return real_dc(*a)

    monkeypatch.setattr(fdk, "deltaw", deltaw)
    monkeypatch.setattr(fdk, "dc", dc)
    real_pa = registry.Model.paged_attention

    def paged_attention(self, device, dtype):
        fn = real_pa(self, device, dtype)

        def counted(*a):
            pak.launches += 1
            return fn(*a)
        return counted

    monkeypatch.setattr(registry.Model, "paged_attention", paged_attention)
    cfg = configs.reduced(configs.get("yi-6b")).replace(vocab=64)
    out = chip_smoke.analysis_phase(
        torch.device("cpu"), {"train": cfg, "serve": cfg},
        {"train": (2, 16, 2), "serve": (2, 64, 8, 4, 6, 1.0)},
        lambda: None, lambda mode: None,
        ["--arch", "yi-6b", "--reduced", "--continuous", "--analyze",
         "--device", "cpu"])
    text = capsys.readouterr().out
    launches = out["launches"]["analysis"]
    assert launches["K1"] == 2 * 2 + 2 and launches["K2"] == 2 * 2
    assert launches["K3"] > 0 and launches["K3"] % cfg.num_layers == 0
    assert "[analysis] launcher: analyze: recompile audit clean" in text
    assert "NEW finding" not in text
    assert out["decode_transfers_per_step"] == 0
