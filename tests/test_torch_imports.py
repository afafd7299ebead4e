"""The port stands alone and never falls back to the CPU unasked.

An AST walk of every module of `src/repro_torch` and of `chip_smoke.py`
finds no import of jax, jaxlib, ml_dtypes or the JAX package `repro`; the
entry points built without a device raise when there is no CUDA device; the
port's configs resolve only what it implements."""
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
    assert len(files) > 20
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


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


def test_unported_paths_are_rejected():
    model, params = _tiny()
    engine = Engine(model, params, batch_slots=2, max_len=32, device="cpu")
    for kw in ({"paged": False}, {"drafter": object()},
               {"tiering": object()}):
        with pytest.raises(NotImplementedError, match="later slice"):
            ContinuousScheduler(engine, **kw)
    with pytest.raises(NotImplementedError, match="later slice"):
        Engine(model, params, batch_slots=2, max_len=32, device="cpu",
               bank=object())
    with pytest.raises(NotImplementedError, match="dense"):
        configs.get("olmoe-1b-7b")
    with pytest.raises(ValueError, match="interpret"):
        build(model.cfg, PEFTConfig(kernel_backend="interpret"))
    with pytest.raises(ValueError, match="device"):
        PagedKVCache(2, 32).block_table_device()
