"""The port's placement layer against the JAX package's, without devices:
the rule tables' state, cache and batch specs leaf by leaf for every arch,
adapter method, abstract mesh and FSDP setting; the planner's plan JSON for
the same cell and the same ClusterEnv; plan files crossing between the
packages; the planner's gate at the production 16x16 cell; the sharding
audit and its seeded regression; the launchers under `torchrun` on four
CPU ranks.

The JAX side evaluates `MeshSpec` in process (no devices); the port walks
meta tensors. The H100 defaults differ from JAX's v5e ones, so the parity
cases hand both packages JAX's constants explicitly.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import PEFTConfig
from repro_torch.dist import cost_model, plan as plan_mod, planner
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import build
from repro_torch.models.registry import analysis_models

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = ("fourierft", "dct", "lora", "circulant", "bitfit", "none")
MESHES = ("4x2", "2x4", "2x2x2", "16x16")


def _iter(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _iter(v, path + (str(k),))
    else:
        yield "/".join(path), tree


def _encoded(specs, encode):
    return {path: encode(spec) for path, spec in _iter(specs)}


def _jax_models(arch):
    import repro.configs as jax_configs
    from repro.configs.base import PEFTConfig as JaxPEFT
    from repro.models import build as jax_build
    cfg = jax_configs.reduced(jax_configs.get(arch))
    for m in METHODS:
        try:
            yield m, jax_build(cfg, JaxPEFT(method=m))
        except (ValueError, NotImplementedError):
            continue


@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_spec_tables_equal_jax_every_method_mesh_and_fsdp(arch):
    import repro.configs as jax_configs
    from repro.dist import cost_model as jcm
    from repro.dist import plan as jplan
    from repro.dist import sharding as jshd
    port_models = dict((m, model) for a, m, model in analysis_models(
        methods=METHODS, archs=(arch,)))
    checked = 0
    for method, jmodel in _jax_models(arch):
        tmodel = port_models.pop(method)
        jstate, tstate = jmodel.init_shapes(), tmodel.init_shapes()
        assert [p for p, _ in _iter(jstate)] == [p for p, _ in _iter(tstate)]
        for name in ("decode_32k", "train_4k"):
            jshape = jax_configs.shape_for(name)
            tshape = configs.shape_for(name)
            jbatch, tbatch = jmodel.input_specs(jshape), \
                tmodel.input_specs(tshape)
            for mesh in MESHES:
                jm = jcm.MeshSpec.from_string(mesh)
                tm = cost_model.MeshSpec.from_string(mesh)
                got = _encoded(plan_mod.RulesSource().batch_specs(
                    tbatch, tm, tshape), plan_mod.encode_spec)
                want = _encoded(jplan.RulesSource().batch_specs(
                    jbatch, jm, jshape), jplan.encode_spec)
                assert got == want, (arch, method, name, mesh)
                if name != "decode_32k":
                    continue
                got = _encoded(shd.cache_specs(
                    tmodel.cache_specs(tshape), tm, tmodel.cfg, tshape),
                    plan_mod.encode_spec)
                want = _encoded(jshd.cache_specs(
                    jmodel.cache_specs(jshape), jm, jmodel.cfg, jshape),
                    jplan.encode_spec)
                assert got == want, (arch, method, mesh)
                for fsdp in (False, True):
                    got = _encoded(shd.state_specs(tstate, tm, tmodel.cfg,
                                                   fsdp),
                                   plan_mod.encode_spec)
                    want = _encoded(jshd.state_specs(jstate, jm, jmodel.cfg,
                                                     fsdp),
                                    jplan.encode_spec)
                    assert got == want, (arch, method, mesh, fsdp)
                    checked += 1
        # the FSDP default decides alike on the same capacity
        for mesh in MESHES:
            assert shd.fsdp_default(
                tmodel.cfg, cost_model.MeshSpec.from_string(mesh),
                hbm_bytes=jshd.HBM_BYTES) == jshd.fsdp_default(
                    jmodel.cfg, jcm.MeshSpec.from_string(mesh))
    assert not port_models, f"port builds {sorted(port_models)}, JAX not"
    assert checked >= 2 * len(MESHES)


def _env_pair(mesh):
    from repro.dist import cost_model as jcm
    jenv = jcm.ClusterEnv(jcm.MeshSpec.from_string(mesh))
    links = {k: cost_model.LinkSpec(v.alpha_s, v.beta_bytes_s)
             for k, v in jenv.links.items()}
    tenv = cost_model.ClusterEnv(cost_model.MeshSpec.from_string(mesh),
                                 links=links, hbm_bw=jenv.hbm_bw,
                                 hbm_bytes=jenv.hbm_bytes,
                                 peak_flops=jenv.peak_flops)
    return jenv, tenv


def _plan_pair(shape_name, mesh="4x2"):
    import repro.configs as jax_configs
    from repro.configs.base import PEFTConfig as JaxPEFT
    from repro.dist import planner as jplanner
    from repro.models import build as jax_build
    remat = "full" if shape_name.startswith("train") else "none"
    jm = jax_build(jax_configs.reduced(jax_configs.get("yi-6b")),
                   JaxPEFT(method="fourierft", n=16, alpha=300.0),
                   remat=remat)
    tm = build(configs.reduced(configs.get("yi-6b")),
               PEFTConfig(method="fourierft", n=16, alpha=300.0),
               remat=remat)
    jenv, tenv = _env_pair(mesh)
    jp = jplanner.plan_model(jm, jenv.mesh,
                             shape=jax_configs.shape_for(shape_name),
                             env=jenv)
    tp = planner.plan_model(tm, tenv.mesh, shape=configs.shape_for(shape_name),
                            env=tenv)
    return jp, tp


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
def test_plan_json_equals_jax_on_the_same_cluster(shape_name):
    jp, tp = _plan_pair(shape_name)
    assert json.dumps(tp.to_json(), sort_keys=True) == \
        json.dumps(jp.to_json(), sort_keys=True)
    assert tp.meta["strategy"] == jp.meta["strategy"]


def test_plan_files_cross_between_the_packages(tmp_path):
    from repro.dist import plan as jplan
    jp, tp = _plan_pair("train_4k")
    jp.save(str(tmp_path / "jax.json"))
    tp.save(str(tmp_path / "port.json"))
    from_jax = plan_mod.ShardingPlan.load(str(tmp_path / "jax.json"))
    from_port = jplan.ShardingPlan.load(str(tmp_path / "port.json"))
    assert from_jax.to_json() == tp.to_json()
    assert from_port.to_json() == jp.to_json()
    assert (tmp_path / "jax.json").read_text() == \
        (tmp_path / "port.json").read_text()
    # a plan file resolves to a table source that specs every leaf alike
    src = plan_mod.resolve(str(tmp_path / "jax.json"))
    tm = build(configs.reduced(configs.get("yi-6b")),
               PEFTConfig(method="fourierft", n=16, alpha=300.0))
    state = tm.init_shapes()
    mesh = cost_model.MeshSpec.from_string("4x2")
    got = _encoded(src.state_specs(state, mesh, tm.cfg),
                   plan_mod.encode_spec)
    want = _encoded(jplan.PlanTableSource(jp).state_specs(
        state, mesh, tm.cfg), jplan.encode_spec)
    assert got == want


def test_production_plan_search_at_or_below_rules():
    """yi-6b at full width on the abstract 16x16 mesh for train_4k, on
    meta tensors and the H100 defaults: the winner's predicted cost is at
    or below the rule table's, and every leaf of the plan is decided."""
    from repro_torch.analysis import sharding_audit
    model = build(configs.get("yi-6b"),
                  PEFTConfig(method="fourierft", n=1000, alpha=300.0),
                  remat="full")
    mesh = mesh_mod.make_production_mesh()
    plan = planner.plan_model(model, mesh, shape=configs.shape_for(
        "train_4k"), env=cost_model.ClusterEnv(mesh, hbm_bytes=80e9))
    ranked = plan.meta["ranked"]
    rules = next(r for r in ranked if r["strategy"] == "rules")
    assert ranked[0]["objective_s"] <= rules["objective_s"]
    assert plan.meta["cost"]["total_s"] > 0
    assert sharding_audit.audit_tree(
        model.init_shapes(), "yi-6b[plan]",
        source=plan_mod.PlanTableSource(plan)) == []


def test_planner_cli_gate(tmp_path, capsys):
    out = tmp_path / "plan.json"
    assert planner.main(["--arch", "yi-6b", "--reduced", "--mesh", "4x2",
                         "--shape", "train_4k", "--out", str(out),
                         "--check-search-beats-rules", "--diff-rules",
                         "--audit"]) == 0
    text = capsys.readouterr().out
    assert "ok: search <= rules" in text and "spec diffs vs rules" in text
    assert plan_mod.ShardingPlan.load(str(out)).meta["arch"] \
        == "yi-6b-smoke"


def test_cost_model_defaults_are_the_h100s():
    env = cost_model.default_env(cost_model.MeshSpec.from_string("2x2x2"))
    assert env.peak_flops == 989e12 and env.hbm_bw == 3.35e12
    assert env.links["model"].beta_bytes_s == 450e9
    assert env.links["pod"].beta_bytes_s == 50e9
    if not torch.cuda.is_available():
        assert env.hbm_bytes == 80e9
    # the collective formulas are the JAX package's
    jenv, tenv = _env_pair("2x2x2")
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        for axes in (("model",), ("pod", "data"), ("data", "model")):
            assert tenv.collective_cost(kind, 1e6, axes) == \
                jenv.collective_cost(kind, 1e6, axes)
    src, dst = ("data", ("pod", "model")), (None, "model")
    assert tenv.resharding_cost(1e6, shd.P(*src), shd.P(*dst)) == \
        jenv.resharding_cost(1e6, src, dst) > 0


def test_spec_entries_normalize_like_partition_spec():
    assert shd.P(("data",), None) == shd.P("data", None)
    assert shd.P((), "model") == shd.P(None, "model")
    assert plan_mod.decode_spec(plan_mod.encode_spec(
        shd.P(("pod", "data"), None))) == shd.P(("pod", "data"), None)
    mesh = cost_model.MeshSpec.from_string("2x2x2")
    from torch.distributed.tensor import Replicate, Shard
    assert shd.placements(shd.P(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert shd.placements(shd.P(None, None), mesh) == (Replicate(),) * 3


def test_sharding_audit_clean_and_seeded_regression(monkeypatch):
    from repro_torch.analysis import report, sharding_audit
    assert sharding_audit.run() == []
    monkeypatch.setattr(shd, "_REPLICATE", shd._REPLICATE - {"A_log"})
    findings = sharding_audit.run(methods=("none",), archs=("mamba2-2.7b",))
    assert [f.rule for f in findings] == ["uncovered"]
    assert "A_log" in findings[0].where
    assert report.gate(findings, {}) == 1


def _torchrun(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_launchers_under_torchrun_on_four_cpu_ranks():
    """`torchrun --nproc-per-node 4 ... --device cpu`: the train launcher
    with every mesh flag of the JAX launcher, then the serve launcher's
    continuous replay on a 2x2 mesh; one rank prints."""
    r = _torchrun(["repro_torch.launch.train", "--arch", "yi-6b",
                   "--reduced", "--steps", "2", "--batch", "4", "--seq",
                   "16", "--n", "16", "--model-parallel", "2", "--fsdp",
                   "--grad-compression", "int8_ef", "--sharding-plan",
                   "search", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "mesh=2x2" in r.stdout and "done: steps=2" in r.stdout
    assert r.stdout.count("done: steps=2") == 1
    assert "sharding plan: {'source': 'plan'" in r.stdout
    r = _torchrun(["repro_torch.launch.serve", "--arch", "yi-6b",
                   "--reduced", "--continuous", "--model-parallel", "2",
                   "--trace-n", "4", "--max-new", "4", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "mesh=2x2" in r.stdout
    assert "continuous: 4 requests" in r.stdout
