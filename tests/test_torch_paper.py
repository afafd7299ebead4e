"""The paper's own surface in the port against the JAX package, on the CPU:
the paper's models (`configs.PAPER_MODELS`), Table 1's accounting, the
paper models' forward and paged decode at reduced size, the `full` (FF)
baseline and factored training.

Params come from `repro`'s `Model.init` and cross over through
`repro_torch.convert.from_jax_params`; batches are seeded numpy arrays
handed to both sides. Tolerances are the JAX suite's: logits at atol 1e-5
/ rtol 1e-4 (tests/test_models.py); a train step's loss, gradients and
updated leaves at atol 1e-5 (tests/test_torch_train.py's)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.configs.base import PEFTConfig as JaxPEFT
from repro.configs.base import TrainConfig as JaxTrain
from repro.core import peft as jax_peft
from repro.models import build as jax_build
from repro.train import step as jax_step
from repro_torch import configs
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import PEFTConfig, TrainConfig
from repro_torch.convert import from_jax_params
from repro_torch.core import adapter as adapter_api
from repro_torch.core import peft as peft_mod
from repro_torch.launch import train as launch_train
from repro_torch.models import build
from repro_torch.serve import ContinuousScheduler, Engine, Request
from repro_torch.train import step as ts
from repro_torch.tree import tree_leaves

PAPER = sorted(jax_configs.PAPER_MODELS)
VOCAB = 64
N, ALPHA = 24, 10.0


def _np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _batch(seed, B=4, S=12):
    toks = np.random.default_rng(seed).integers(
        0, VOCAB, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _pair(arch, seed=0, **peft_kw):
    """(jax model, jax params, port model, port params) of `arch` at
    reduced size in f32, the same weights on both sides."""
    kw = dict(vocab=VOCAB, param_dtype="float32", dtype="float32")
    jcfg = jax_configs.reduced(jax_configs.get(arch)).replace(**kw)
    tcfg = configs.reduced(configs.get(arch)).replace(**kw)
    peft_kw = {"n": N, "alpha": ALPHA, **peft_kw}
    jmodel = jax_build(jcfg, JaxPEFT(**peft_kw))
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tmodel = build(tcfg, PEFTConfig(**peft_kw))
    return jmodel, jparams, tmodel, from_jax_params(jax.device_get(jparams),
                                                    "cpu")


# ---------------------------------------------------------------------------
# The paper's models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PAPER)
def test_paper_config_equals_jax(arch):
    mine = configs.get(arch)
    assert mine is configs.PAPER_MODELS[arch]
    assert dataclasses.asdict(mine) == dataclasses.asdict(
        jax_configs.PAPER_MODELS[arch])
    # the launchers' --arch choices stay the registered archs, as in JAX
    assert arch not in configs.ARCHS and arch not in jax_configs.ARCHS


def test_llama2_7b_builds_at_full_size():
    cfg = configs.get("llama2-7b")
    model = build(cfg, PEFTConfig(n=1000, alpha=300.0))
    assert (cfg.n_heads, cfg.n_kv, cfg.head_dim) == (32, 32, 128)
    assert model.trainable_params() == 64_000
    sites = {s.name: (s.d_in, s.d_out) for s in model.sites}
    assert sites["layers/wq"] == sites["layers/wv"] == (4096, 4096)
    with pytest.raises(KeyError, match="llama2-7b"):
        configs.get("llama2-7")


# ---------------------------------------------------------------------------
# Table 1 (tests/test_fourierft.py's and tests/test_adapter_api.py's counts)
# ---------------------------------------------------------------------------

def _both(arch, fn, **peft_kw):
    """fn(peft_mod, sites, peft) in the port and in JAX, on the q/v sites
    of the paper model `arch`."""
    mine = fn(peft_mod, peft_mod.qv_sites_for(configs.get(arch)),
              PEFTConfig(**peft_kw))
    theirs = fn(jax_peft, jax_peft.qv_sites_for(jax_configs.get(arch)),
                JaxPEFT(**peft_kw))
    assert mine == theirs
    return mine


def _count(mod, sites, peft):
    return mod.count_trainable(sites, peft)


def _storage(mod, sites, peft):
    return mod.storage_bytes(sites, peft)


@pytest.mark.parametrize("model,n,expected", [
    ("roberta-base", 200, 4_800), ("roberta-base", 1000, 24_000),
    ("roberta-large", 200, 9_600), ("roberta-large", 1000, 48_000),
    ("gpt2-medium", 500, 24_000), ("gpt2-medium", 1000, 48_000),
    ("gpt2-large", 500, 36_000), ("gpt2-large", 1000, 72_000),
    ("llama2-7b", 1000, 64_000), ("llama2-7b", 2000, 128_000),
    ("llama2-13b", 1000, 80_000), ("llama2-13b", 2000, 160_000),
    ("vit-base", 3000, 72_000), ("vit-base", 10000, 240_000),
    ("vit-large", 3000, 144_000), ("vit-large", 10000, 480_000),
])
def test_fourierft_param_counts(model, n, expected):
    assert _both(model, _count, method="fourierft", n=n) == expected


@pytest.mark.parametrize("model,r,expected", [
    ("roberta-base", 4, 147_456), ("roberta-base", 8, 294_912),
    ("roberta-large", 4, 393_216), ("roberta-large", 8, 786_432),
    ("gpt2-medium", 4, 393_216), ("llama2-7b", 16, 8_388_608),
    ("llama2-7b", 64, 33_554_432), ("llama2-13b", 64, 52_428_800),
    ("vit-base", 16, 589_824), ("vit-large", 16, 1_572_864),
])
def test_lora_param_counts(model, r, expected):
    assert _both(model, _count, method="lora", lora_r=r) == expected


def test_fourierft_vs_lora_ratio_llama2_7b():
    """Headline claim: 0.064M vs 33.5M (≈0.2%) on LLaMA2-7B."""
    four = _both("llama2-7b", _count, method="fourierft", n=1000)
    lora = _both("llama2-7b", _count, method="lora", lora_r=64)
    assert four == 64_000 and lora == 33_554_432
    assert four / lora < 0.002


def test_storage_bytes():
    b = _both("llama2-7b", _storage, method="fourierft", n=1000)
    # 64K coefficients + one shared 2x1000 entry matrix, f32
    assert b == (64_000 + 2_000) * 4 == 264_000
    assert b / 1024 < 260  # paper: 250KB


@pytest.mark.parametrize("method,count,storage", [
    ("dct", 64_000, (64_000 + 2_000) * 4),
    ("circulant", 2 * 32 * 4096, 2 * 32 * 4096 * 4),
])
def test_new_method_counts(method, count, storage):
    """dct mirrors fourierft (n per layer per site + 2n entries per shape);
    circulant stores max(d1, d2) per layer per site and nothing frozen."""
    assert _both("llama2-7b", _count, method=method, n=1000) == count
    assert _both("llama2-7b", _storage, method=method, n=1000) == storage


@pytest.mark.parametrize("method", ["fourierft", "dct", "circulant", "lora",
                                    "bitfit", "none", "full"])
@pytest.mark.parametrize("arch", ["gpt2-medium", "llama2-7b"])
def test_storage_bytes_every_method(arch, method):
    _both(arch, _storage, method=method, n=1000, lora_r=8)


# ---------------------------------------------------------------------------
# The paper models' forward and paged decode (non-gated GELU, no RoPE, G = 1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PAPER)
def test_forward_matches_jax(arch):
    jmodel, jparams, tmodel, tparams = _pair(arch, seed=1)
    cfg = tmodel.cfg
    assert cfg.n_heads == cfg.n_kv              # G = 1 at reduced size too
    toks = _batch(2)["tokens"]
    jlog = np.asarray(jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
                      [0])
    tlog = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tlog.numpy(), jlog, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("arch", PAPER)
def test_paged_decode_matches_jax(arch):
    """Cold paged primes of two prompts of different lengths, then two
    decode steps through the port's plain paged attention (K3's plain
    version on the CPU): each step's logits equal the JAX forward's last
    position over prompt + the tokens so far."""
    jmodel, jparams, tmodel, tparams = _pair(arch, seed=3)
    ps, pps = 4, 4
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, VOCAB, size=n).astype(np.int32)
               for n in (7, 10)]
    cache = tmodel.init_cache(2, 0, torch.float32, "cpu", paged=True,
                              page_size=ps, n_pages=2 * pps + 2)
    bt = torch.arange(2 * pps, dtype=torch.int32).reshape(2, pps)
    scratch = torch.tensor([2 * pps, 2 * pps + 1], dtype=torch.int32)
    nxt = []
    for slot, p in enumerate(prompts):
        tok, cache = tmodel.prefill_paged(tparams, cache, {
            "tokens": torch.from_numpy(p)[None], "block_table": bt[slot:slot + 1],
            "slot": slot, "scratch_page": int(scratch[slot])})
        nxt.append(int(tok[0]))
    seqs = [list(p) + [t] for p, t in zip(prompts, nxt)]
    for _ in range(2):
        logits, cache = tmodel.decode_logits(tparams, cache, {
            "tokens": torch.tensor([[s[-1]] for s in seqs],
                                   dtype=torch.int32),
            "block_table": bt, "scratch_pages": scratch})
        for b, s in enumerate(seqs):
            ref = np.asarray(jmodel.forward(jparams, {"tokens": jnp.asarray(
                np.array(s, np.int32))[None]})[0])[0, -1]
            np.testing.assert_allclose(logits[b, 0].numpy(), ref,
                                       atol=1e-5, rtol=1e-4)
        for b, s in enumerate(seqs):
            s.append(int(logits[b, 0].argmax()))


# ---------------------------------------------------------------------------
# The `full` (FF) baseline
# ---------------------------------------------------------------------------

def test_full_is_registered_without_site_params():
    assert "full" in adapter_api.registered_methods()
    assert "full" not in adapter_api.registered_methods(site_params_only=True)
    assert "none" not in adapter_api.registered_methods(site_params_only=True)
    m = adapter_api.resolve("full")
    assert m.trains_base and not m.has_site_params


@pytest.mark.parametrize("arch", ["yi-6b", "gpt2-medium", "llama2-7b"])
def test_full_trainable_params_match_jax(arch):
    """Counted from the base's shapes (at full size: nothing is made)."""
    cfg = configs.get(arch)
    mine = build(cfg, PEFTConfig(method="full")).trainable_params()
    theirs = jax_build(jax_configs.get(arch),
                       JaxPEFT(method="full")).trainable_params()
    assert mine == theirs > 10 ** 8


def test_full_split_and_join():
    _, _, tmodel, tparams = _pair("gpt2-medium", method="full")
    assert tparams["peft"] == {}
    trainable, frozen = ts.split_params(tmodel, tparams)
    assert trainable == {"base": tparams["base"]}
    assert frozen == {"base": {}, "peft": {}}
    joined = ts.join_params(tmodel, trainable, frozen)
    assert joined["peft"] == {} and joined["base"] is tparams["base"]
    assert tmodel.trainable_params() == sum(
        t.numel() for t in tree_leaves(tparams["base"]))


@pytest.mark.parametrize("arch", ["yi-6b", "gpt2-medium"])
def test_full_step_matches_jax(arch):
    """One `full` step as tests/test_train.py::test_full_ft_trains_base
    takes it (TrainConfig(total_steps=1)), on both packages: the gradient
    of every base leaf, the loss, and every updated base leaf at atol
    1e-5."""
    jmodel, jparams, tmodel, tparams = _pair(arch, method="full")
    batch = _batch(5)
    jtr, jfr = jax_step.split_params(jmodel, jparams)
    _, jgrads = jax.value_and_grad(
        lambda tr: jmodel.loss({"base": tr["base"], "peft": {}},
                               _j(batch)))(jtr)
    trainable, frozen = ts.split_params(tmodel, tparams)
    _, grads = ts._value_and_grad(ts._loss_for(tmodel), trainable, frozen,
                                  _t(batch))
    for a, b in zip(tree_leaves(grads["base"]), _np(jgrads["base"])):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5)
    # init_state draws the params _pair drew (the same key)
    jstate, jfr = jax_step.init_state(jmodel, JaxTrain(total_steps=1),
                                      jax.random.PRNGKey(0))
    assert set(jstate["trainable"]) == {"base"}
    jstate, jm = jax_step.make_train_step(jmodel, JaxTrain(total_steps=1))(
        jstate, jfr, _j(batch))
    state, frozen = ts.state_from_params(tmodel, tparams)
    assert set(state["trainable"]) == {"base"}
    state, m = ts.make_train_step(tmodel, TrainConfig(total_steps=1))(
        state, frozen, _t(batch))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
    mine = tree_leaves(state["trainable"]["base"])
    theirs = _np(jstate["trainable"]["base"])
    assert len(mine) == len(theirs)
    moved = 0
    for a, b, a0 in zip(mine, theirs, tree_leaves(tparams["base"])):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5)
        moved += not torch.equal(a, a0)
    assert moved == len(mine)          # every base leaf trains


def test_full_train_state_saves_and_restores(tmp_path):
    _, _, tmodel, tparams = _pair("gpt2-medium", method="full")
    state, frozen = ts.state_from_params(tmodel, tparams)
    state, _ = ts.make_train_step(tmodel, TrainConfig(total_steps=2))(
        state, frozen, _t(_batch(6)))
    ckpt.save_sync(str(tmp_path), 1, state)
    back, at = ckpt.restore(str(tmp_path))
    assert at == 1

    def same(x, y):
        if isinstance(y, dict):
            assert set(x) == set(y)
            for k in y:
                same(x[k], y[k])
        else:
            assert x.dtype == y.dtype and torch.equal(x, y)
    same(back, state)
    assert set(back["trainable"]) == {"base"}


def test_full_and_none_serve_with_nothing_to_merge():
    for method in ("full", "none"):
        _, _, tmodel, tparams = _pair("gpt2-medium", method=method)
        engine = Engine(tmodel, tparams, batch_slots=2, max_len=32,
                        device="cpu")
        for a, b in zip(tree_leaves(engine.params["base"]),
                        tree_leaves(tparams["base"])):
            assert torch.equal(a, b)
        reqs = [Request(prompt=torch.arange(3 + i, dtype=torch.int32),
                        max_new=3) for i in range(2)]
        ContinuousScheduler(engine, page_size=8).serve(reqs, [0.0, 1.0])
        assert [len(r.out) for r in reqs] == [3, 3]


@pytest.mark.parametrize("method", ["full", "none"])
def test_bank_refuses_methods_without_site_params(method):
    """The adapter bank takes only registered_methods(site_params_only=
    True), as the JAX package's does."""
    from repro_torch.serve import AdapterBank
    model = build(configs.reduced(configs.get("gpt2-medium")),
                  PEFTConfig(n=N))
    with pytest.raises(ValueError, match="has no adapter state"):
        AdapterBank(model, {method: PEFTConfig(method=method)}, 2,
                    device="cpu")


def test_launcher_full_on_cpu(capsys):
    launch_train.main(["--arch", "yi-6b", "--reduced", "--method", "full",
                       "--steps", "2", "--batch", "2", "--seq", "8",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "method=full" in out and "done: steps=2" in out
    assert "anomalies=0" in out


# ---------------------------------------------------------------------------
# Factored training
# ---------------------------------------------------------------------------

def _jax_loss_and_c_grads(jmodel, jparams, batch):
    jtr, jfr = jax_step.split_params(jmodel, jparams)
    return jax.value_and_grad(
        lambda tr: jmodel.loss_from_parts(tr, jfr["base"], jfr["peft"],
                                          _j(batch)))(jtr)


def _port_loss_and_grads(tmodel, tparams, batch):
    trainable, frozen = ts.split_params(tmodel, tparams)
    return ts._value_and_grad(ts._loss_for(tmodel), trainable, frozen,
                              _t(batch))


@pytest.mark.parametrize("method", ["fourierft", "dct"])
@pytest.mark.parametrize("arch", ["yi-6b", "gpt2-medium"])
def test_factored_step_matches_jax_and_merged(arch, method):
    """The factored strategy's loss and gradient w.r.t. c equal JAX's
    factored step and the port's merged step (atol 1e-5), and one factored
    step through `make_train_step` updates c as JAX's does."""
    jmodel, jparams, tmodel, tparams = _pair(arch, method=method,
                                             strategy="factored")
    merged = build(tmodel.cfg, tmodel.peft.replace(strategy="merged"))
    batch = _batch(7)
    jloss, jgrads = _jax_loss_and_c_grads(jmodel, jparams, batch)
    loss, grads = _port_loss_and_grads(tmodel, tparams, batch)
    mloss, mgrads = _port_loss_and_grads(merged, tparams, batch)
    assert float(loss) == pytest.approx(float(jloss), abs=1e-5)
    assert float(loss) == pytest.approx(float(mloss), abs=1e-5)
    for site in ("layers/wq", "layers/wv"):
        g = grads["peft"][site]["c"].numpy()
        np.testing.assert_allclose(g, np.asarray(jgrads["peft"][site]["c"]),
                                   atol=1e-5)
        np.testing.assert_allclose(g, mgrads["peft"][site]["c"].numpy(),
                                   atol=1e-5)
    tcfg_kw = dict(learning_rate=1e-2, total_steps=3, warmup_steps=1)
    jstate, jfr = jax_step.init_state(jmodel, JaxTrain(**tcfg_kw),
                                      jax.random.PRNGKey(0))
    jstate, jm = jax_step.make_train_step(jmodel, JaxTrain(**tcfg_kw))(
        jstate, jfr, _j(batch))
    state, frozen = ts.state_from_params(tmodel, tparams)
    state, m = ts.make_train_step(tmodel, TrainConfig(**tcfg_kw))(
        state, frozen, _t(batch))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
    for site in ("layers/wq", "layers/wv"):
        np.testing.assert_allclose(
            state["trainable"]["peft"][site]["c"].numpy(),
            np.asarray(jstate["trainable"]["peft"][site]["c"]), atol=1e-5)


def test_launcher_factored_on_cpu(capsys):
    launch_train.main(["--arch", "yi-6b", "--reduced", "--strategy",
                       "factored", "--n", "32", "--steps", "2", "--batch",
                       "2", "--seq", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "factored_apply -> einsum" in out
    assert "done: steps=2" in out and "anomalies=0" in out
