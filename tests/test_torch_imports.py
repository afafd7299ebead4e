"""The port stands alone and never falls back to the CPU unasked.

An AST walk of every module of `src/repro_torch`, of `chip_smoke.py` and of
the port's scripts under `tools/` finds no import of jax, jaxlib, ml_dtypes or the JAX package `repro`; the
entry points built without a device raise when there is no CUDA device; the
port's configs resolve only what it implements, and the paths it has not
ported refuse with a message."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import PEFTConfig, TrainConfig
from repro_torch.models import build
from repro_torch.serve import ContinuousScheduler, Engine, PagedKVCache

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 75
    return files + [ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "tools").glob("*.py"))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_walk_covers_the_family_modules():
    walked = {str(p.relative_to(ROOT)) for p in _port_files()}
    for rel in ("models/moe.py", "models/attention.py", "models/common.py",
                "models/mamba2.py", "models/ssm_lm.py", "models/zamba2.py",
                "configs/olmoe_1b_7b.py", "configs/phi3_5_moe.py",
                "configs/musicgen_medium.py", "configs/qwen2_vl_72b.py",
                "configs/mamba2_2_7b.py", "configs/zamba2_7b.py"):
        assert f"src/repro_torch/{rel}" in walked


def test_walk_covers_the_analysis_modules():
    walked = {str(p.relative_to(ROOT)) for p in _port_files()}
    for name in ("__init__", "__main__", "report", "ast_lint",
                 "kernel_audit", "dispatch_lint", "graphs"):
        assert f"src/repro_torch/analysis/{name}.py" in walked


def test_walk_covers_the_dist_modules():
    walked = {str(p.relative_to(ROOT)) for p in _port_files()}
    for name in ("__init__", "sharding", "cost_model", "plan", "planner",
                 "compression", "opstats", "dtensor"):
        assert f"src/repro_torch/dist/{name}.py" in walked
    for rel in ("launch/mesh.py", "analysis/sharding_audit.py"):
        assert f"src/repro_torch/{rel}" in walked
    import repro_torch.dist as dist_pkg
    assert set(dist_pkg.__all__) == {"compression", "cost_model", "dtensor",
                                     "opstats", "plan", "planner",
                                     "sharding"}


def test_walk_covers_the_dryrun_and_custom_op_modules():
    walked = {str(p.relative_to(ROOT)) for p in _port_files()}
    for rel in ("launch/dryrun.py", "launch/dryrun_lib.py",
                "launch/roofline.py", "kernels/custom_ops.py"):
        assert f"src/repro_torch/{rel}" in walked
    from repro_torch.launch import mesh as mesh_mod
    # the mesh refusals of the families and the bank are gone
    assert not hasattr(mesh_mod, "refuse_family_on_mesh")
    assert not hasattr(mesh_mod, "NEXT_SLICE")


def _tiny():
    cfg = configs.reduced(configs.get("yi-6b")).replace(
        vocab=64, param_dtype="float32", dtype="float32")
    model = build(cfg, PEFTConfig(n=16))
    return model, model.init(0, "cpu")


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    model, params = _tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(model, params, batch_slots=2, max_len=32)
    engine = Engine(model, params, batch_slots=2, max_len=32, device="cpu")
    assert engine.device.type == "cpu"
    sched = ContinuousScheduler(engine)
    assert sched.cache["pk"].device.type == "cpu"
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.train import step as train_step
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "yi-6b", "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "yi-6b", "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_step.init_state(model, TrainConfig(), 0)
    from repro_torch.launch import api as launch_api
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_api.main(["--arch", "yi-6b", "--reduced", "--port", "0"])


def test_unported_paths_are_rejected():
    model, params = _tiny()
    engine = Engine(model, params, batch_slots=2, max_len=32, device="cpu")
    from repro_torch.launch import api as launch_api
    with pytest.raises(ValueError, match="does not divide"):
        launch_api.main(["--arch", "yi-6b", "--reduced", "--device", "cpu",
                         "--model-parallel", "2"])
    from repro_torch.train import step as train_step
    with pytest.raises(ValueError, match="unknown grad_compression"):
        train_step.make_train_step(model,
                                   TrainConfig(grad_compression="int4"))
    for arch in ("zamba2-7b", "mamba2-2.7b"):
        # the recurrent families build; their per-slot and paged caches do
        # not exist (in the JAX package neither)
        tiny = build(configs.reduced(configs.get(arch)), PEFTConfig(n=16))
        with pytest.raises(NotImplementedError, match="per-slot cache"):
            tiny.init_cache(2, 32, torch.float32, "cpu", paged=True,
                            n_pages=4)
    with pytest.raises(ValueError, match="interpret"):
        build(model.cfg, PEFTConfig(kernel_backend="interpret"))
    with pytest.raises(ValueError, match="device"):
        PagedKVCache(2, 32).block_table_device()


def test_walk_covers_the_entry_point_modules():
    """The load harness, the examples and the kernels' bit comparison
    stand alone like the rest of the port."""
    walked = {str(p.relative_to(ROOT)) for p in _port_files()}
    for rel in ("launch/loadgen.py", "examples/__init__.py",
                "examples/quickstart.py", "examples/serve_batched.py",
                "examples/train_peft_100m.py",
                "examples/expressiveness_2d.py"):
        assert f"src/repro_torch/{rel}" in walked
    assert "tools/compare_fft_kernels.py" in walked
