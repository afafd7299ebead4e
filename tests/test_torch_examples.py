"""The JAX package's four examples on the port (`repro_torch.examples`), on
the CPU at cut `--steps`: quickstart's losses against the JAX package's
train step on the same params (the port's init, exported) and batches at
the tolerance of tests/test_torch_train.py (atol 1e-5, f32), then its
merged engine's generation; serve_batched's three tenants trained and
served; train_peft_100m's pre-train and both fine-tunes with FourierFT at
the paper's share of LoRA's parameters; expressiveness_2d's trajectory
against the JAX script's (its base weights and LoRA's A from the same
threefry keys). The JAX scripts are loaded from their files here."""
import importlib.util
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

import repro.configs as jax_configs
from repro.configs.base import PEFTConfig as JaxPEFT
from repro.configs.base import TrainConfig as JaxTrain
from repro.models import build as jax_build
from repro.optim import adamw as jax_adamw
from repro.train import step as jax_step
from repro_torch import configs
from repro_torch.configs.base import PEFTConfig
from repro_torch.data import SyntheticLM
from repro_torch.examples import (expressiveness_2d, quickstart,
                                  serve_batched, train_peft_100m)
from repro_torch.models import build

ROOT = Path(__file__).resolve().parents[1]


def _jax_example(name):
    key = f"jax_examples_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().numpy()


def test_quickstart_tracks_the_jax_train_step(tmp_path, capsys,
                                              monkeypatch):
    """Three steps of the quickstart in f32 give the losses of the JAX
    package's train step (lr 5e-2, warmup 10, head trained) from the
    port's own initial params and the SyntheticLM batches; the merged
    engine then generates 12 tokens for each prompt."""
    steps = 3
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    got = quickstart.main(["--device", "cpu", "--steps", str(steps),
                           "--dtype", "float32"])
    text = capsys.readouterr().out
    assert "deltaw -> einsum" in text and "generated:" in text
    assert [len(g) for g in got["generated"]] == [12, 12]
    assert got["anomalies"] == 0 and len(got["losses"]) == steps
    kw = dict(vocab=256, dtype="float32", param_dtype="float32")
    tcfg = configs.reduced(configs.get("yi-6b"), layers=4,
                           width=128).replace(**kw)
    jcfg = jax_configs.reduced(jax_configs.get("yi-6b"), layers=4,
                               width=128).replace(**kw)
    peft_kw = dict(method="fourierft", n=128, alpha=20.0, train_head=True)
    params = _numpy_tree(build(tcfg, PEFTConfig(**peft_kw)).init(0, "cpu"))
    jmodel = jax_build(jcfg, JaxPEFT(**peft_kw))
    jparams = jax.tree.map(jnp.asarray, params)
    tr, frozen = jax_step.split_params(jmodel, jparams)
    state = {"step": jnp.zeros((), jnp.int32), "trainable": tr,
             "opt": jax_adamw.init(tr),
             "loss_ema": jnp.zeros((), jnp.float32),
             "anomalies": jnp.zeros((), jnp.int32)}
    fn = jax.jit(jax_step.make_train_step(jmodel, JaxTrain(
        learning_rate=5e-2, total_steps=steps, warmup_steps=10)))
    data = SyntheticLM(vocab=256, batch=16, seq=64, task_seed=5)
    want = []
    for i in range(steps):
        batch = {k: jnp.asarray(v.numpy())
                 for k, v in data.batch_at(i).items()}
        state, m = fn(state, frozen, batch)
        want.append(float(m["loss"]))
    np.testing.assert_allclose(got["losses"], want, atol=1e-5, rtol=0)


def test_serve_batched_trains_and_serves_three_tenants(capsys):
    got = serve_batched.main(["--device", "cpu", "--steps", "2"])
    text = capsys.readouterr().out
    assert set(got["served"]) == {11, 22, 33}
    for task in (11, 22, 33):
        assert np.isfinite(got["losses"][task])
        assert f"adapter for task {task}: final loss" in text
        assert [len(o) for o in got["served"][task]] == [8, 8, 8]
    # 64 coefficients x 4 layers x 2 sites of f32: 2.0 KiB a tenant
    assert text.count("2.0 KiB checkpoint") == 3


def test_train_peft_100m_pretrains_and_fine_tunes_both_methods(capsys):
    got = train_peft_100m.main(["--device", "cpu", "--steps", "2",
                                "--pretrain-steps", "1", "--batch", "2",
                                "--seq", "16"])
    text = capsys.readouterr().out
    assert "base model: " in text and "pre-training base for 1 steps" in text
    f, lo = got["fourierft"], got["lora"]
    assert f["trainable"] == 256 * 2 * 12
    assert lo["trainable"] == 8 * (768 + 768 + 768 + 256) * 12
    for r in (f, lo):
        assert np.isfinite([r["first"], r["final"]]).all()
        assert r["anomalies"] == 0
    assert "FourierFT used 2.5% of LoRA's parameters" in text


def test_expressiveness_2d_follows_the_jax_scripts_trajectory(capsys):
    """101 epochs of both methods: the same accuracy at every logged epoch
    as the JAX script, losses within 1e-3 of its, and the same epoch at
    which FourierFT first reaches 100%."""
    epochs = 101
    got = expressiveness_2d.main(["--device", "cpu", "--steps",
                                  str(epochs)])
    text = capsys.readouterr().out
    assert text.count("reached 100% at epoch:") == 2
    ref = _jax_example("expressiveness_2d")
    for method in ("lora", "fourierft"):
        hist, first_100, n_params = ref.train(method, epochs=epochs)
        mine = got[method]
        assert mine["n_params"] == n_params == 128
        assert [e for e, _, _ in mine["hist"]] == [e for e, _, _ in hist]
        np.testing.assert_allclose([a for _, _, a in mine["hist"]],
                                   [a for _, _, a in hist], atol=0)
        np.testing.assert_allclose([l for _, l, _ in mine["hist"]],
                                   [l for _, l, _ in hist], rtol=1e-3,
                                   atol=1e-4)
        assert mine["first_100"] == first_100
