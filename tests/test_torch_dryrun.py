"""The port's production dry run (`launch/dryrun_lib.py`, `launch/dryrun.py`)
and roofline report (`launch/roofline.py`) against the JAX package's.

- The accounting helpers against tests/test_roofline_tools.py's
  expectations and against `repro.launch.dryrun_lib`'s own functions on
  the same configs; the constraint hook's specs against JAX's
  `make_constrain` (its `with_sharding_constraint` captured).
- The renderer: JAX's table rows from results/dryrun_baseline_v0 (the hint
  text of the summary is the card's).
- The mini dry run of tests/test_dist.py (yi-6b, olmoe-1b-7b, zamba2-7b ×
  train_4k, decode_32k at 2 layers, width 64; mesh 4x2, a fake group of 8
  ranks), the plain route on both sides, each package in subprocesses of
  its own (a process group is global): every leaf's placement equals
  JAX's in_shardings spec, the argument bytes and model flops are JAX's,
  the decode cells' dot flops within 10 % of JAX's; the searched plan's
  measured collective bytes are at most the rules' at yi-6b train and
  decode (tests/test_sharding_plan.py's requirement of its own).
- K1–K5 as custom ops: fake CUDA tensors take the kernels' route (no
  launch counted), OpStats prices each as one op; the memory tracker; the
  CLI (plain route, the card route's refusal without a CUDA build).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import PEFTConfig
from repro_torch.dist.cost_model import MeshSpec
from repro_torch.launch import dryrun_lib as dl
from repro_torch.launch import roofline as R
from repro_torch.models import build

ROOT = Path(__file__).resolve().parents[1]
ARCHS = tuple(configs.ARCH_IDS)

# both packages' mini cells (tests/test_dist.py's MINI_DRYRUN)
MINI_SETUP = r"""
import json, os, sys
{prelude}
orig_get = C.get
dl.configs.get = lambda a: C.reduced(orig_get(a), layers=2, width=64,
                                     vocab=256)
shapes = {{"train_4k": ShapeConfig("train_4k", 128, 8, "train"),
          "decode_32k": ShapeConfig("decode_32k", 256, 8, "decode")}}
dl.configs.shape_for = lambda n: shapes[n]
"""

PORT_CELLS = MINI_SETUP.format(prelude="""
import repro_torch.configs as C
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun_lib as dl
""") + r"""
for spec in sys.argv[1:]:
    arch, shape, plan = spec.split(":")
    res = dl.run_cell(arch, shape, False, mesh_shape="4x2", route="plain",
                      sharding_plan=plan)
    print("CELL " + json.dumps({"arch": arch, "shape": shape, "plan": plan,
        "specs": res["leaf_specs"], "memory": res["memory"],
        "model_flops": res["model_flops"],
        "dot_flops": res["dot_flops_per_device"],
        "flops": res["flops_per_device"],
        "collective_bytes": res["collective_bytes_per_device"],
        "source": res["sharding_plan"]["source"],
        "predicted": "predicted" in res["sharding_plan"]}), flush=True)
"""

JAX_CELLS = MINI_SETUP.format(prelude="""
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import repro.configs as C
from repro.configs.base import ShapeConfig
from repro.launch import dryrun_lib as dl
from repro.launch.mesh import make_mesh
""") + r"""
mesh = make_mesh((4, 2), ("data", "model"))


def key(k):
    return str(getattr(k, "key", getattr(k, "idx", k)))


for arch in ["yi-6b", "olmoe-1b-7b", "zamba2-7b"]:
    for shape in ["train_4k", "decode_32k"]:
        cell = dl.build_cell(arch, shape, mesh)
        specs = {}
        for i, tree in enumerate(cell.in_shardings):
            for path, sh in jax.tree_util.tree_flatten_with_path(tree)[0]:
                specs["/".join([str(i)] + [key(k) for k in path])] = [
                    list(e) if isinstance(e, tuple) else e for e in sh.spec]
        with mesh:
            compiled = dl.lower_cell(cell).compile()
        res = dl.analyze(cell, None, compiled, mesh, 0.0)
        print("CELL " + json.dumps({"arch": arch, "shape": shape,
            "specs": specs, "argument_bytes":
            res["memory"]["argument_bytes"], "model_flops":
            res["model_flops"], "dot_flops": res["dot_flops_per_device"],
            "backbone": list(dl.backbone_params(cell.model))}), flush=True)
"""


def _start(script: str, *args, jax_side: bool = False):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    if jax_side:
        env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen([sys.executable, "-c", script, *args],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _cells(proc, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return [json.loads(ln[5:]) for ln in out.splitlines()
            if ln.startswith("CELL ")]


@pytest.fixture(scope="module")
def mini():
    """The six mini cells (rules) and yi-6b's two with the searched plan,
    from three port processes, beside JAX's six."""
    jax_p = _start(JAX_CELLS, jax_side=True)
    port = [_start(PORT_CELLS, *cells) for cells in (
        ["yi-6b:train_4k:rules", "yi-6b:decode_32k:rules",
         "yi-6b:train_4k:search", "yi-6b:decode_32k:search"],
        ["olmoe-1b-7b:train_4k:rules", "olmoe-1b-7b:decode_32k:rules"],
        ["zamba2-7b:train_4k:rules", "zamba2-7b:decode_32k:rules"])]
    got = {}
    for p in port:
        for c in _cells(p):
            got[(c["arch"], c["shape"], c["plan"])] = c
    want = {(c["arch"], c["shape"]): c for c in _cells(jax_p)}
    return got, want


def _norm(spec):
    """A spec as a tuple without trailing Nones, one-axis tuples as the
    axis (JAX's PartitionSpec and the port's P alike)."""
    out = [tuple(e) if isinstance(e, list) and len(e) > 1
           else (e[0] if isinstance(e, list) and e else
                 (None if isinstance(e, list) else e)) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


CELLS = [(a, s) for a in ("yi-6b", "olmoe-1b-7b", "zamba2-7b")
         for s in ("train_4k", "decode_32k")]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_mini_cell_placements_bytes_and_flops_match_jax(mini, arch, shape):
    got, want = mini
    g, w = got[(arch, shape, "rules")], want[(arch, shape)]
    assert set(g["specs"]) == set(w["specs"])
    bad = {k: (g["specs"][k], w["specs"][k]) for k in w["specs"]
           if _norm(g["specs"][k]) != _norm(w["specs"][k])}
    assert not bad, bad
    assert g["memory"]["argument_bytes"] == w["argument_bytes"]
    assert g["model_flops"] == w["model_flops"]
    model = build(dl.configs.reduced(configs.get(arch), layers=2, width=64,
                                     vocab=256), PEFTConfig(method="none"))
    assert list(dl.backbone_params(model)) == w["backbone"]
    assert g["memory"]["fits_hbm"] and g["flops"] > 0
    if shape == "decode_32k":
        assert abs(g["dot_flops"] - w["dot_flops"]) <= 0.1 * w["dot_flops"]


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_searched_plan_moves_no_more_collective_bytes(mini, shape):
    got, _ = mini
    rules = got[("yi-6b", shape, "rules")]
    search = got[("yi-6b", shape, "search")]
    assert rules["source"] == "rules" and search["source"] == "plan"
    assert search["predicted"] and rules["predicted"]
    assert search["collective_bytes"] <= rules["collective_bytes"]


# ---- accounting against the JAX package's functions -------------------------
@pytest.fixture(scope="module")
def jdl():
    from repro.launch import dryrun_lib
    return dryrun_lib


@pytest.mark.parametrize("arch", ARCHS)
def test_accounting_matches_jax(jdl, arch):
    import repro.configs as jax_configs
    from repro.configs.base import PEFTConfig as JaxPEFT
    from repro.dist.cost_model import MeshSpec as JaxMeshSpec
    from repro.models import build as jax_build
    model = build(configs.get(arch), PEFTConfig(method="none"))
    jmodel = jax_build(jax_configs.get(arch), JaxPEFT(method="none"))
    assert dl.backbone_params(model) == jdl.backbone_params(jmodel)
    for shape in configs.SHAPES:
        jshape = jax_configs.shape_for(shape.name)
        assert dl.model_flops(model, shape) == jdl.model_flops(jmodel, jshape)
        assert dl.long_context_skip(model.cfg, shape) \
            == jdl.long_context_skip(jmodel.cfg, jshape)
        for spec in ("16x16", "2x16x16", "64x4"):
            assert dl.auto_microbatch(model.cfg, shape,
                                      MeshSpec.from_string(spec)) \
                == jdl.auto_microbatch(jmodel.cfg, jshape,
                                       JaxMeshSpec.from_string(spec))
    for kind in ("train", "serve"):
        a, b = dl.peft_for(model.cfg, kind), jdl.peft_for(jmodel.cfg, kind)
        assert (a.method, a.n, a.alpha, a.strategy) \
            == (b.method, b.n, b.alpha, b.strategy)
    assert dl.peft_for(model.cfg, "train", "plain").kernel_backend == "einsum"


def test_strip_axis_and_tree_bytes(jdl):
    from jax.sharding import PartitionSpec
    from repro_torch.dist.sharding import P
    for entries in ((("pod", "data"), "model"), ("data", None),
                    (None, ("data", "model")), (("data",), None)):
        got = dl._strip_axis(P(*entries), "data")
        want = jdl._strip_axis(PartitionSpec(*entries), "data")
        assert _norm([list(e) if isinstance(e, tuple) else e for e in got]) \
            == _norm([list(e) if isinstance(e, tuple) else e for e in want])
    tree = {"a": torch.zeros((3, 4)), "b": {"c": torch.zeros(5,
                                                         dtype=torch.int32)}}
    assert dl.tree_bytes(tree) == 3 * 4 * 4 + 5 * 4


@pytest.mark.parametrize("arch", ["yi-6b", "olmoe-1b-7b", "qwen2-vl-72b"])
def test_constrain_specs_match_jax(jdl, monkeypatch, arch):
    """The hook's spec for each path it sees equals what JAX's hook hands
    `with_sharding_constraint` (captured), on the production meshes."""
    import jax
    import repro.configs as jax_configs
    from repro.dist.cost_model import MeshSpec as JaxMeshSpec
    seen = []
    monkeypatch.setattr(jdl, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(spec) or x)
    cfg, jcfg = configs.get(arch), jax_configs.get(arch)
    cases = [("moe/dispatch", (16, 64, 8, cfg.d_model)),
             ("moe/tokens", (16, 4096, cfg.d_model)),
             ("act/hidden", (256, 4096, cfg.d_model)),
             ("act/hidden", (32, 1, cfg.d_model)),
             ("fsdp_gather/wq", (cfg.d_model, cfg.attn_dim)),
             ("fsdp_gather/wo", (cfg.attn_dim, cfg.d_model)),
             ("layers/wq", (cfg.num_layers, cfg.d_model, cfg.attn_dim))]
    for spec_str in ("16x16", "2x16x16"):
        for fsdp in (False, True):
            port = dl.make_constrain(MeshSpec.from_string(spec_str), cfg,
                                     fsdp)
            jax_hook = jdl.make_constrain(JaxMeshSpec.from_string(spec_str),
                                          jcfg, fsdp)
            for path, shape in cases:
                seen.clear()
                jax_hook(path, jax.ShapeDtypeStruct(shape, np.float32))
                want = seen[0] if seen else None
                got = port.spec(path, torch.empty(shape, device="meta"))
                if want is None:
                    assert got is None, (path, shape)
                    continue
                assert _norm([list(e) if isinstance(e, tuple) else e
                              for e in got]) == _norm(
                    [list(e) if isinstance(e, tuple) else e for e in want]), \
                    (spec_str, fsdp, path, shape)


# ---- tests/test_roofline_tools.py's expectations on the port ------------
def test_backbone_param_counts_exclude_embeddings():
    model = build(configs.get("yi-6b"), PEFTConfig(method="none"))
    total, active = dl.backbone_params(model)
    assert total == active
    d, L, ff = 4096, 32, 11008
    analytic = L * (d * (4096 + 512 + 512 + 4096) + 3 * d * ff)
    assert abs(total - analytic) / analytic < 0.01


def test_moe_active_params():
    model = build(configs.get("olmoe-1b-7b"), PEFTConfig(method="none"))
    total, active = dl.backbone_params(model)
    assert active < total
    cfg = configs.get("olmoe-1b-7b")
    expert = cfg.num_layers * cfg.moe.num_experts * 3 * 2048 * 1024
    assert abs((total - active) - expert * (1 - 8 / 64)) / total < 0.02


def test_model_flops_conventions():
    model = build(configs.get("yi-6b"), PEFTConfig(method="none"))
    _, n = dl.backbone_params(model)
    assert dl.model_flops(model, configs.shape_for("train_4k")) \
        == pytest.approx(6.0 * n * 256 * 4096)
    assert dl.model_flops(model, configs.shape_for("prefill_32k")) \
        == pytest.approx(2.0 * n * 32 * 32768)
    assert dl.model_flops(model, configs.shape_for("decode_32k")) \
        == pytest.approx(2.0 * n * 128)


def test_long_context_gate():
    assert dl.long_context_skip(configs.get("yi-6b"),
                                configs.shape_for("long_500k"))
    assert not dl.long_context_skip(configs.get("mamba2-2.7b"),
                                    configs.shape_for("long_500k"))
    assert not dl.long_context_skip(configs.get("yi-6b"),
                                    configs.shape_for("train_4k"))


# ---- the renderer --------------------------------------------------------
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_renderer_reproduces_jax_rows(mesh):
    from repro.launch import roofline as J
    rows = R.load(str(ROOT / "results" / "dryrun_baseline_v0"))
    assert len(rows) >= 60
    assert R.render(rows, mesh) == J.render(rows, mesh)
    assert R.render_dryrun(rows, mesh) == J.render_dryrun(rows, mesh)
    got, want = (R.dominant_summary(rows, mesh).splitlines(),
                 J.dominant_summary(rows, mesh).splitlines())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.split(" — ")[0] == w.split(" — ")[0]
        assert "MXU" not in g and "ICI" not in g


def test_render_includes_skips_and_formats():
    base = {"arch": "yi-6b", "shape": "train_4k", "kind": "train",
            "mesh": "16x16", "variant": "baseline", "flops_per_device": 1e14,
            "collective_bytes_per_device": 1e11,
            "collective_counts": {"all-reduce": 10},
            "terms": {"compute_s": 0.5, "memory_s": 1.2,
                      "memory_s_upper": 3.0, "collective_s": 2.0},
            "dominant": "collective_s", "model_flops": 3e16,
            "useful_flops_ratio": 0.8, "roofline_fraction": 0.1,
            "memory": {"argument_bytes": 1, "temp_bytes": 1,
                       "fits_hbm": True}, "compile_seconds": 10.0}
    out = R.render([base, dict(base, arch="mamba2-2.7b")], "16x16")
    assert "| yi-6b | train_4k |" in out and out.count("SKIP") == 8
    assert "0.1000" in out
    assert R.fmt_s(2.0) == "2.00s" and R.fmt_s(0.0021) == "2.1ms"
    assert R.fmt_s(5e-6) == "5us"
    assert "NVLink" in R.dominant_summary([base], "16x16")


# ---- custom ops, the memory tracker, the CLI ------------------------------
def test_kernels_trace_as_custom_ops_on_fake_cuda_tensors():
    """A fake CUDA input takes each wrapper's custom op (its fake shape
    function; nothing launches, no counter moves) and OpStats prices the
    op by custom_ops.COSTS: chip_smoke's operations and bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.dist.opstats import OpStats
    from repro_torch.kernels import custom_ops
    from repro_torch.kernels import dct_deltaw as ddk
    from repro_torch.kernels import fourier_deltaw as fdk
    from repro_torch.kernels import paged_attention as pak
    before = (fdk.launches, fdk.dc_launches, ddk.launches, ddk.dc_launches,
              pak.launches)
    L, n, d1, d2 = 2, 32, 64, 48
    with FakeTensorMode():
        c = torch.empty(L, n, device="cuda")
        u = torch.empty(n, dtype=torch.int32, device="cuda")
        q = torch.empty(2, 1, 4, 16, dtype=torch.bfloat16, device="cuda")
        kp = torch.empty(10, 8, 2, 16, dtype=torch.bfloat16, device="cuda")
        bt = torch.empty(2, 4, dtype=torch.int32, device="cuda")
        kl = torch.empty(2, dtype=torch.int32, device="cuda")
        with OpStats() as rec:
            outs = [fdk.deltaw(c, u, u, d1, d2, 10.0),
                    ddk.deltaw(c, u, u, d1, d2, 10.0)]
            outs += [fdk.dc(outs[0], u, u, d1, d2, 10.0),
                     ddk.dc(outs[1], u, u, d1, d2, 10.0),
                     pak.paged_attention(q, kp, kp, bt, kl)]
    assert [tuple(o.shape) for o in outs] == [(L, d1, d2), (L, d1, d2),
                                              (L, n), (L, n), (2, 1, 4, 16)]
    assert outs[-1].dtype == torch.bfloat16
    assert (fdk.launches, fdk.dc_launches, ddk.launches, ddk.dc_launches,
            pak.launches) == before
    st = rec.stats
    assert st.kernel_counts == {"fourier_deltaw": 1, "dct_deltaw": 1,
                                "fourier_dc": 1, "dct_dc": 1,
                                "paged_attention": 1}
    fft = 2.5 * d1 * d2 * np.log2(d1 * d2) * L
    k3 = 4.0 * 4 * 16 * 2 * 1 * 32
    assert st.flops == pytest.approx(4 * fft + k3)
    assert st.dot_flops == 0
    k12 = 4.0 * (L * n + 2 * n + L * d1 * d2)
    k3_bytes = 2 * 2 * 4 * 16 * 2 + 2 * 2 * 32 * 2 * 16 * 2 + 4 * 8 + 8
    assert st.bytes_min == pytest.approx(4 * k12 + k3_bytes)
    assert custom_ops.is_fake(outs[0])
    assert not custom_ops.is_fake(torch.zeros(1))


def test_k1_op_differentiates_through_k2():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import custom_ops
    with FakeTensorMode():
        c = torch.empty(2, 32, requires_grad=True)
        u = torch.empty(32, dtype=torch.int32)
        dw = custom_ops.op("fourier_deltaw")(c, u, u, 64, 48, 10.0)
        (g,) = torch.autograd.grad(dw.sum(), [c])
    assert tuple(dw.shape) == (2, 64, 48) and tuple(g.shape) == (2, 32)


def test_memory_tracker_counts_live_storage():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.empty(1000)
        tracker = dl.MemoryTracker((x,))
        with tracker:
            for _ in range(5):
                y = x * 2                   # each replaces the last
            z = torch.cat([y, y])           # 8000 B beside y's 4000
            out = (x, z)
        mem = tracker.memory(out)
    assert mem["argument_bytes"] == 4000
    assert tracker.peak == 12000            # y and z; x is an argument
    assert mem["output_bytes"] == 12000 and mem["alias_bytes"] == 4000
    assert mem["peak_estimate_bytes"] == mem["argument_bytes"] \
        + mem["temp_bytes"] + mem["output_bytes"] - mem["alias_bytes"]


def test_cli_runs_a_cell_and_roofline_renders_it(tmp_path):
    """`python -m repro_torch.launch.dryrun` at a production cell (yi-6b
    decode_32k on the fake 16x16, the plain route) writes JAX's keys, and
    `python -m repro_torch.launch.roofline --dir` renders its row; the
    card route refuses on a CPU-only build."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = tmp_path / "dry"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "yi-6b", "--shape", "decode_32k", "--mesh",
                        "single", "--route", "plain", "--out", str(out)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads((out / "yi-6b__decode_32k__single.json").read_text())
    from repro.launch import dryrun_lib as jdl_mod   # noqa: F401 (keys)
    want = {"arch", "shape", "kind", "mesh", "chips", "flops_per_device",
            "dot_flops_per_device", "bytes_per_device",
            "bytes_per_device_upper", "collective_bytes_per_device",
            "collectives", "collective_counts", "terms", "dominant",
            "model_flops", "useful_flops_ratio", "roofline_fraction",
            "memory", "compile_seconds", "sharding_plan", "variant"}
    assert want <= set(res) and "xla_cost_analysis" not in set(res)
    assert res["mesh"] == "16x16" and res["chips"] == 256
    assert res["memory"]["fits_hbm"] and res["memory"]["alias_bytes"] > 0
    r2 = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline",
                         "--dir", str(out), "--summary"], cwd=ROOT, env=env,
                        capture_output=True, text=True, timeout=120)
    assert r2.returncode == 0 and "| yi-6b | decode_32k |" in r2.stdout
    if torch.version.cuda is None:
        r3 = subprocess.run([sys.executable, "-m",
                             "repro_torch.launch.dryrun", "--arch", "yi-6b",
                             "--shape", "decode_32k", "--out", str(out)],
                            cwd=ROOT, env=env, capture_output=True,
                            text=True, timeout=120)
        assert r3.returncode != 0 and "CUDA build" in r3.stderr
