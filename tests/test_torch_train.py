"""The port's training slice against the JAX package, on the CPU, in f32.

Params come from `repro`'s `Model.init` and cross over through
`repro_torch.convert.from_jax_params`; batches are numpy arrays handed to
both sides (the two packages' random streams differ). Covered: the loss and
the gradients of the trainable leaves (atol 1e-5); AdamW, global-norm
clipping and the LR schedules; three `make_train_step` steps; microbatch
accumulation, the three remat modes and the anomaly guard; checkpoints
(resume after SIGTERM equals an uninterrupted run, and train states and
bf16 leaves cross between the packages' managers); adapter exports in both
directions; the synthetic data; the launcher; and a served model built from
trained coefficients holds no autograd graph. The cases that cross the
packages (loss and gradients, three steps, checkpoints, adapters) run for
both ΔW methods, FourierFT and the cosine-basis `dct`."""
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.checkpoint import adapters as jax_adapters
from repro.checkpoint import manager as jax_ckpt
from repro.configs.base import PEFTConfig as JaxPEFT
from repro.configs.base import TrainConfig as JaxTrain
from repro.models import build as jax_build
from repro.optim import adamw as jax_adamw
from repro.optim import schedules as jax_schedules
from repro.train import step as jax_step
from repro_torch import configs
from repro_torch.checkpoint import adapters, manager as ckpt
from repro_torch.configs.base import PEFTConfig, TrainConfig
from repro_torch.convert import from_jax_params
from repro_torch.data import SyntheticLM
from repro_torch.data.synthetic import FANOUT
from repro_torch.launch import train as launch_train
from repro_torch.models import build
from repro_torch.optim import adamw, schedules
from repro_torch.serve import ContinuousScheduler, Engine, Request
from repro_torch.train import loop
from repro_torch.train import step as ts
from repro_torch.tree import tree_leaves

VOCAB = 64
N, ALPHA = 32, 10.0


def _cfgs():
    kw = dict(vocab=VOCAB, param_dtype="float32", dtype="float32")
    return (jax_configs.reduced(jax_configs.get("yi-6b")).replace(**kw),
            configs.reduced(configs.get("yi-6b")).replace(**kw))


METHODS = ["fourierft", "dct"]


def _pair(train_head=False, remat="none", method="fourierft"):
    jcfg, tcfg = _cfgs()
    jmodel = jax_build(jcfg, JaxPEFT(method=method, n=N, alpha=ALPHA,
                                     train_head=train_head))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build(tcfg, PEFTConfig(method=method, n=N, alpha=ALPHA,
                                    train_head=train_head), remat=remat)
    return jmodel, jparams, tmodel, from_jax_params(jax.device_get(jparams),
                                                    "cpu")


def _batch(seed, B=4, S=16):
    toks = np.random.default_rng(seed).integers(
        0, VOCAB, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _torch_grads(model, params, batch):
    trainable, frozen = ts.split_params(model, params)
    return ts._value_and_grad(ts._loss_for(model), trainable, frozen, batch)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("train_head", [False, True])
def test_loss_and_trainable_gradients_match_jax(train_head, method):
    jmodel, jparams, tmodel, tparams = _pair(train_head, method=method)
    batch = _batch(1)
    jtr, jfr = jax_step.split_params(jmodel, jparams)
    jloss, jgrads = jax.value_and_grad(
        lambda tr: jmodel.loss_from_parts(tr, jfr["base"], jfr["peft"],
                                          _j(batch)))(jtr)
    assert float(tmodel.loss(tparams, _t(batch))) == pytest.approx(
        float(jmodel.loss(jparams, _j(batch))), abs=1e-5)
    tloss, tgrads = _torch_grads(tmodel, tparams, _t(batch))
    assert float(tloss) == pytest.approx(float(jloss), abs=1e-5)
    for site in ("layers/wq", "layers/wv"):
        np.testing.assert_allclose(tgrads["peft"][site]["c"].numpy(),
                                   np.asarray(jgrads["peft"][site]["c"]),
                                   atol=1e-5)
    assert ("head" in tgrads) == train_head
    if train_head:
        np.testing.assert_allclose(tgrads["head"].numpy(),
                                   np.asarray(jgrads["head"]), atol=1e-5)


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(2)
    params = {"a": rng.normal(size=(5,)).astype(np.float32),
              "b": {"c": rng.normal(size=(3, 4)).astype(np.float32)}}
    cfg_kw = dict(learning_rate=0.1, weight_decay=0.01)
    jp, tp = jax.tree.map(jnp.asarray, params), \
        {"a": torch.from_numpy(params["a"]),
         "b": {"c": torch.from_numpy(params["b"]["c"])}}
    jopt, topt = jax_adamw.init(jp), adamw.init(tp)
    for i in range(3):
        g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
            np.float32), params)
        jp, jopt = jax_adamw.update(jax.tree.map(jnp.asarray, g), jopt, jp,
                                    0.1, JaxTrain(**cfg_kw))
        tp, topt = adamw.update(
            {"a": torch.from_numpy(g["a"]),
             "b": {"c": torch.from_numpy(g["b"]["c"])}}, topt, tp, 0.1,
            TrainConfig(**cfg_kw))
    for mine, theirs in zip(tree_leaves(tp), _np_leaves(jp)):
        np.testing.assert_allclose(mine.numpy(), theirs, atol=1e-6)
    for key in ("mu", "nu"):
        for mine, theirs in zip(tree_leaves(topt[key]),
                                _np_leaves(jopt[key])):
            np.testing.assert_allclose(mine.numpy(), theirs, rtol=1e-6,
                                       atol=1e-9)
    assert int(topt["count"]) == int(jopt["count"]) == 3


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(3)
    g = {"a": rng.normal(size=(7,)).astype(np.float32),
         "b": rng.normal(size=(2, 3)).astype(np.float32)}
    jc, jn = jax_adamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                           max_norm)
    tc, tn = adamw.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    for k in g:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6)


@pytest.mark.parametrize("schedule", ["linear", "cosine", "constant"])
def test_lr_schedule_matches_jax(schedule):
    kw = dict(learning_rate=3e-3, warmup_steps=4, total_steps=20,
              schedule=schedule)
    for step in range(23):
        assert float(schedules.lr_at(step, TrainConfig(**kw))) == \
            pytest.approx(float(jax_schedules.lr_at(step, JaxTrain(**kw))),
                          rel=1e-6, abs=1e-12)
    t = torch.tensor(5, dtype=torch.int32)
    assert schedules.lr_at(t, TrainConfig(**kw)).dtype == torch.float32


@pytest.mark.parametrize("method", METHODS)
def test_three_train_steps_track_jax(method):
    """Losses and c within 1e-5 after each step (c drifts by 7e-7 at most
    here): Adam divides each gradient by its own running magnitude, so the
    two packages' f32 rounding differences grow for coefficients whose
    gradient is tiny, up to the step size lr = 1e-2 times their relative
    difference."""
    jmodel, jparams, tmodel, tparams = _pair(method=method)
    kw = dict(learning_rate=1e-2, total_steps=3, warmup_steps=1)
    jstate, jfrozen = jax_step.init_state(jmodel, JaxTrain(**kw),
                                          jax.random.PRNGKey(0))
    tstate, tfrozen = ts.state_from_params(tmodel, tparams)
    jfn = jax.jit(jax_step.make_train_step(jmodel, JaxTrain(**kw)))
    tfn = ts.make_train_step(tmodel, TrainConfig(**kw))
    for i in range(3):
        batch = _batch(10 + i)
        jstate, jm = jfn(jstate, jfrozen, _j(batch))
        tstate, tm = tfn(tstate, tfrozen, _t(batch))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  abs=1e-5)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        for site in ("layers/wq", "layers/wv"):
            np.testing.assert_allclose(
                tstate["trainable"]["peft"][site]["c"].numpy(),
                np.asarray(jstate["trainable"]["peft"][site]["c"]),
                atol=1e-5)
    assert int(tstate["step"]) == 3 and int(tstate["anomalies"]) == 0
    assert float(tstate["loss_ema"]) == pytest.approx(
        float(jstate["loss_ema"]), abs=1e-5)


def _first_moment_after_one_step(model, params, tcfg, batch):
    """mu after one step from zero is (1 - b1)·g: the step's gradient."""
    state, frozen = ts.state_from_params(model, params)
    out, m = ts.make_train_step(model, tcfg)(state, frozen, batch)
    return float(m["loss"]), out["opt"]["mu"]


def test_microbatch_equals_full_batch():
    _, _, tmodel, tparams = _pair(train_head=True)
    batch = _t(_batch(4, B=8))
    full = _first_moment_after_one_step(
        tmodel, tparams, TrainConfig(grad_clip=1e9), batch)
    micro = _first_moment_after_one_step(
        tmodel, tparams, TrainConfig(grad_clip=1e9, microbatch=2), batch)
    assert micro[0] == pytest.approx(full[0], abs=1e-6)
    for a, b in zip(tree_leaves(micro[1]), tree_leaves(full[1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_modes_give_equal_gradients(remat):
    _, _, plain_model, tparams = _pair()
    remat_model = build(plain_model.cfg, plain_model.peft, remat=remat)
    batch = _t(_batch(5))
    loss0, g0 = _torch_grads(plain_model, tparams, batch)
    loss1, g1 = _torch_grads(remat_model, tparams, batch)
    assert float(loss1) == pytest.approx(float(loss0), abs=1e-6)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7)
    with pytest.raises(ValueError, match="remat"):
        build(plain_model.cfg, plain_model.peft, remat="everything")


def test_anomaly_guard_skips_a_nan_step():
    _, _, tmodel, tparams = _pair()
    tcfg = TrainConfig(anomaly_threshold=1e4)
    state, frozen = ts.state_from_params(tmodel, tparams)
    step_fn = ts.make_train_step(tmodel, tcfg)
    state, _ = step_fn(state, frozen, _t(_batch(6)))
    poisoned = {"base": {**frozen["base"], "layers": {
        k: v * float("nan") if v.ndim >= 3 else v
        for k, v in frozen["base"]["layers"].items()}},
        "peft": frozen["peft"]}
    state2, m = step_fn(state, poisoned, _t(_batch(7)))
    assert int(m["skipped"]) == 1 and int(state2["anomalies"]) == 1
    assert int(state2["step"]) == 2
    assert float(state2["loss_ema"]) == pytest.approx(
        float(state["loss_ema"]), rel=1e-6)
    for a, b in zip(tree_leaves(state["trainable"]) + tree_leaves(
            state["opt"]), tree_leaves(state2["trainable"]) + tree_leaves(
            state2["opt"])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_fourierft_loss_decreases():
    cfg = _cfgs()[1]
    model = build(cfg, PEFTConfig(n=N, alpha=ALPHA, train_head=True))
    tcfg = TrainConfig(learning_rate=2e-2, total_steps=40, warmup_steps=4)
    state, frozen = ts.init_state(model, tcfg, 0, "cpu")
    step_fn = ts.make_train_step(model, tcfg)
    data = SyntheticLM(vocab=VOCAB, batch=8, seq=32, task_seed=3)
    losses = []
    for i in range(40):
        state, m = step_fn(state, frozen, data.batch_at(i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-8:]) < np.mean(losses[:8]) - 0.1


def test_synthetic_data_is_step_keyed():
    data = SyntheticLM(vocab=VOCAB, batch=4, seq=12, seed=3, task_seed=5)
    a, b = data.batch_at(7), data.batch_at(7)
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (4, 12)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert not torch.equal(a["tokens"], data.batch_at(8)["tokens"])
    half = data.batch_at(7, shard=1, num_shards=2)
    assert torch.equal(half["tokens"], a["tokens"][2:])
    again = SyntheticLM(vocab=VOCAB, batch=4, seq=12, seed=3, task_seed=5)
    assert torch.equal(again.batch_at(7)["labels"], a["labels"])
    assert bool((a["tokens"] >= 0).all()) and bool((a["tokens"] < VOCAB).all())
    cb = SyntheticLM(vocab=VOCAB, batch=2, seq=5, codebooks=3).batch_at(0)
    assert cb["tokens"].shape == (2, 5, 3)
    # up to FANOUT tokens the teacher is the dense table; wider rows sparse
    assert data._succ.shape == (VOCAB, VOCAB)
    wide = SyntheticLM(vocab=FANOUT * 2, batch=2, seq=4)
    assert wide._succ.shape == (FANOUT * 2, FANOUT)


def _run_loop(model, tcfg, data, ckpt_dir=None, stop_after=None):
    state, frozen = ts.init_state(model, tcfg, 0, "cpu")
    step_fn = ts.make_train_step(model, tcfg)
    calls = {"n": 0}

    def step(state, frozen, batch):
        out = step_fn(state, frozen, batch)
        calls["n"] += 1
        if calls["n"] == stop_after:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    return loop.run(step, state, frozen, data, tcfg, ckpt_dir=ckpt_dir,
                    ckpt_every=2 if ckpt_dir else 0, log_every=0,
                    log_fn=lambda s: None)


def test_sigterm_resume_equals_uninterrupted_run(tmp_path):
    model = build(_cfgs()[1], PEFTConfig(n=N, alpha=ALPHA))
    tcfg = TrainConfig(learning_rate=1e-2, total_steps=5, warmup_steps=1)
    data = SyntheticLM(vocab=VOCAB, batch=4, seq=16)
    ref_state, ref_report = _run_loop(model, tcfg, data)
    d = str(tmp_path / "ckpt")
    _, first = _run_loop(model, tcfg, data, ckpt_dir=d, stop_after=3)
    assert first.preempted and first.steps_run == 3
    assert ckpt.available_steps(d)[-1] == 3
    state, second = _run_loop(model, tcfg, data, ckpt_dir=d)
    assert second.resumed_from == 3 and second.steps_run == 2
    assert first.losses + second.losses == ref_report.losses
    for a, b in zip(tree_leaves(state), tree_leaves(ref_state)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert ckpt.available_steps(d) == [3, 4, 5]


@pytest.mark.parametrize("method", METHODS)
def test_train_state_crosses_between_checkpoint_managers(tmp_path, method):
    jmodel, _, tmodel, _ = _pair(method=method)
    jstate, _ = jax_step.init_state(jmodel, JaxTrain(),
                                    jax.random.PRNGKey(0))
    bf16 = np.random.default_rng(8).normal(size=(3, 5)).astype(np.float32)
    tree = {"state": jstate, "w": jnp.asarray(bf16, jnp.bfloat16)}
    jax_ckpt.save_sync(str(tmp_path / "jax"), 7, tree)
    mine, at = ckpt.restore(str(tmp_path / "jax"))
    assert at == 7
    assert mine["state"]["step"].dtype == torch.int32
    assert mine["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        mine["w"].float().numpy(),
        np.asarray(jnp.asarray(bf16, jnp.bfloat16).astype(jnp.float32)))
    for a, b in zip(tree_leaves(mine["state"]), _np_leaves(jstate)):
        np.testing.assert_array_equal(a.numpy(), b)
    # and back: the port's save restores in the JAX package
    ckpt.save_sync(str(tmp_path / "port"), 8, mine)
    theirs, at = jax_ckpt.restore(str(tmp_path / "port"))
    assert at == 8 and theirs["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(theirs["w"], np.float32),
                                  mine["w"].float().numpy())
    for a, b in zip(_np_leaves(theirs["state"]), _np_leaves(jstate)):
        np.testing.assert_array_equal(a, b)


def _site_deltas(model, adapters):
    by_name = {s.name: s for s in model.sites}
    return {name: np.asarray(model.method.site_delta(
        ad, by_name[name], model.peft)) for name, ad in adapters.items()}


@pytest.mark.parametrize("method", METHODS)
def test_adapters_cross_between_packages(tmp_path, method):
    jmodel, jparams, tmodel, tparams = _pair(method=method)
    jax_adapters.export_adapter(str(tmp_path), "from-jax", jparams["peft"],
                                jmodel.peft)
    assert adapters.list_adapters(str(tmp_path)) == ("from-jax",)
    assert adapters.read_manifest(str(tmp_path), "from-jax").n == N
    mine, peft = adapters.import_adapter(str(tmp_path), "from-jax",
                                         sites=tmodel.sites)
    assert peft == tmodel.peft
    theirs = _site_deltas(jmodel, jparams["peft"])
    for name, dw in _site_deltas(tmodel, mine).items():
        np.testing.assert_allclose(dw, theirs[name], atol=1e-5)
    # the reverse: a port export (scaled coefficients) merges in JAX
    trained = {site: {**ad, "c": ad["c"] * 1.5}
               for site, ad in tparams["peft"].items()}
    adapters.export_adapter(str(tmp_path), "from-port", trained, tmodel.peft)
    back, jpeft = jax_adapters.import_adapter(str(tmp_path), "from-port",
                                              sites=jmodel.sites)
    assert jpeft == jmodel.peft
    theirs = _site_deltas(jmodel, back)
    for name, dw in _site_deltas(tmodel, trained).items():
        np.testing.assert_allclose(theirs[name], dw, atol=1e-5)


def test_launcher_runs_on_cpu(capsys, tmp_path):
    argv = ["--arch", "yi-6b", "--reduced", "--steps", "3", "--device",
            "cpu", "--n", "64", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    launch_train.main(argv)
    out = capsys.readouterr().out
    assert "deltaw -> einsum" in out
    assert "done: steps=3" in out and "anomalies=0" in out
    launch_train.main(argv[:4] + ["4"] + argv[5:])
    assert "resumed from 3" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="factored"):
        launch_train.main(argv + ["--strategy", "factored"])


def test_serving_trained_coefficients_holds_no_graph():
    """Coefficients that require grad (as training leaves them) merge into
    weights that do not, and the scheduler serves them."""
    _, _, tmodel, tparams = _pair()
    for ad in tparams["peft"].values():
        ad["c"].requires_grad_(True)
    engine = Engine(tmodel, tparams, batch_slots=2, max_len=32,
                    device="cpu")
    for w in tree_leaves(engine.params["base"]):
        assert not w.requires_grad and w.grad_fn is None
    reqs = [Request(prompt=torch.arange(3 + i, dtype=torch.int32),
                    max_new=4) for i in range(3)]
    ContinuousScheduler(engine, page_size=8).serve(reqs, [0.0, 1.0, 2.0])
    assert [len(r.out) for r in reqs] == [4, 4, 4]
    outs = engine.generate([r.prompt for r in reqs[:2]], max_new=4)
    assert not any(o.requires_grad for o in outs)
