"""The hybrid family (zamba2-7b) in the port against the JAX package, on
the CPU: mamba2 blocks with one shared attention + MLP block applied
before every group, each application with its own factored adapter row.

Every parity case runs at `reduced()` size (4 layers, `shared_every` 2:
two full groups) and at 5 layers, which adds the trailing partial group
that zamba2-7b's 81 = 13·6 + 3 needs. Params come from `repro`'s init and
cross over through `repro_torch.convert.from_jax_params`; inputs are
seeded numpy arrays handed to both sides. Tolerances are the JAX suite's:
f32 logits and loss at atol 1e-5 / rtol 1e-4 (tests/test_models.py), a
train step's loss and coefficient gradients at atol 1e-5
(tests/test_torch_train.py's), merged against unmerged logits at 5e-4 /
1e-3 (tests/test_serve.py), and every greedy stream exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.configs.base import PEFTConfig as JaxPEFT
from repro.core import peft as jax_peft
from repro.models import build as jax_build
from repro.models import zamba2 as jzamba
from repro.serve import AdapterBank as JaxBank
from repro.serve import Engine as JaxEngine
from repro.train import step as jax_step
from repro_torch import configs
from repro_torch.checkpoint import adapters as adapter_ckpt
from repro_torch.configs.base import PEFTConfig
from repro_torch.convert import from_jax_params, from_jax_tenant
from repro_torch.core import peft as tpeft
from repro_torch.launch import api as launch_api
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build, registry, zamba2
from repro_torch.serve import (AdapterBank, ContinuousScheduler, Engine,
                               merge_for_serving)
from repro_torch.train import step as ts

ARCH = "zamba2-7b"
VOCAB = 64
N, ALPHA = 24, 10.0
ALL_SITES = ("wq", "wv", "wx", "wo_ssm")
DEPTHS = [4, 5]          # reduced (two full groups); and a tail of one


def _cfgs(layers):
    kw = dict(vocab=VOCAB, param_dtype="float32", dtype="float32",
              num_layers=layers)
    return (jax_configs.reduced(jax_configs.get(ARCH)).replace(**kw),
            configs.reduced(configs.get(ARCH)).replace(**kw))


def _pair(layers=5, seed=0, bump=0.0, **peft):
    """(jax model, jax params, port model, port params) in f32, the same
    weights on both sides; `bump` is added to every floating adapter leaf
    (LoRA's B and circulant's kernel start at zero)."""
    peft = {"n": N, "alpha": ALPHA, **peft}
    jcfg, tcfg = _cfgs(layers)
    jmodel = jax_build(jcfg, JaxPEFT(**peft))
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    if bump:
        jparams["peft"] = jax.tree.map(
            lambda x: x + bump if jnp.issubdtype(x.dtype, jnp.floating)
            else x, jparams["peft"])
    tmodel = build(tcfg, PEFTConfig(**peft))
    return jmodel, jparams, tmodel, from_jax_params(jax.device_get(jparams),
                                                    "cpu")


def _batch(seed, B=2, S=16):
    toks = np.random.default_rng(seed).integers(
        0, VOCAB, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _close(a, b, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=rtol)


def _port_decode(model, params, toks):
    """Teacher-forced decode over `toks`: (logits (B, S, V), tokens)."""
    cache = model.init_cache(toks.shape[0], toks.shape[1] + 2,
                             torch.float32, "cpu")
    logits = []
    with torch.no_grad():
        for t in range(toks.shape[1]):
            lg, cache = model.decode_logits(
                params, cache, {"tokens": torch.from_numpy(toks[:, t:t + 1])})
            logits.append(lg[:, 0])
    assert cache["pos"] == toks.shape[1]
    lg = torch.stack(logits, dim=1)
    return lg.numpy(), lg.argmax(-1).numpy()


def _jax_decode(model, params, toks):
    cache = model.init_cache(toks.shape[0], toks.shape[1] + 2,
                             dtype=jnp.float32)
    step = jax.jit(model.decode_step)
    outs = []
    for t in range(toks.shape[1]):
        nt, cache = step(params, cache,
                         {"tokens": jnp.asarray(toks[:, t:t + 1])})
        outs.append(np.asarray(nt))
    return np.stack(outs, axis=1)


def _prompts():
    rng = np.random.default_rng(9)
    return [rng.integers(0, VOCAB, size=n).astype(np.int32)
            for n in (5, 9, 3)]


def _streams(outs):
    return [np.asarray(o).tolist() for o in outs]


def _min_margin(engine, prompts, streams):
    """The smallest top-2 logit gap along `streams` (teacher-forced through
    the engine's padded lockstep batch). Exact stream equality across the
    two packages means something only where it is well above their f32
    logit differences (1e-5 here)."""
    toks = torch.zeros((len(prompts), max(len(p) for p in prompts)),
                       dtype=torch.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.from_numpy(p)
    model, params = engine.model, engine.params
    cache = model.init_cache(len(prompts), engine.max_len, torch.float32,
                             "cpu")
    gaps = []
    with torch.no_grad():
        for t in range(toks.shape[1]):
            lg, cache = model.decode_logits(params, cache,
                                            {"tokens": toks[:, t:t + 1]})
        for t in range(len(streams[0])):
            top = lg[:, 0].topk(2).values
            gaps.append(float((top[:, 0] - top[:, 1]).min()))
            nxt = torch.tensor([[s[t]] for s in streams], dtype=torch.int32)
            lg, cache = model.decode_logits(params, cache, {"tokens": nxt})
    return min(gaps)


# ---------------------------------------------------------------------------
# Config, structure, sites
# ---------------------------------------------------------------------------

def test_config_reduced_and_groups_equal_jax():
    for full in (False, True):
        jcfg, tcfg = jax_configs.get(ARCH), configs.get(ARCH)
        if not full:
            jcfg, tcfg = jax_configs.reduced(jcfg), configs.reduced(tcfg)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert zamba2._split(tcfg) == jzamba._split(jcfg)
        assert zamba2.n_apps(tcfg) == jzamba.n_apps(jcfg)
    assert zamba2._split(configs.get(ARCH)) == (13, 3)
    assert zamba2.n_apps(configs.get(ARCH)) == 14
    assert zamba2._split(_cfgs(5)[1]) == (2, 1)


@pytest.mark.parametrize("method", ["fourierft", "lora", "full"])
def test_sites_targets_and_table1_equal_jax(method):
    """At full size: the sites (the shared q/v stacked over the 14
    applications), the default q/v targets, Table 1's trainable count and
    the storage bytes equal JAX's."""
    jm = jax_build(jax_configs.get(ARCH), JaxPEFT(method=method))
    tm = build(configs.get(ARCH), PEFTConfig(method=method))
    assert [dataclasses.astuple(s) for s in tm.sites] == \
        [dataclasses.astuple(s) for s in jm.sites]
    assert tm.sites[0] == registry.AdapterSite("shared/wq", 3584, 3584, 14)
    assert tm.trainable_params() == jm.trainable_params()
    if method == "full":
        return
    assert tm.peft.target_modules == jm.peft.target_modules == ("wq", "wv")
    assert tm.trainable_params() == {"fourierft": 1000 * 14 * 2,
                                     "lora": 8 * 7168 * 14 * 2}[method]
    assert tpeft.storage_bytes(tm.sites, tm.peft) == \
        jax_peft.storage_bytes(jm.sites, jm.peft)


def test_kernel_policy_keeps_the_shared_sites_factored():
    """With all four targets, the mamba sites' ΔW resolves to K1 on the
    card (3584x7168 and 7168x3584, radix 7) and the shared sites' factored
    apply to the plain version (they never merge)."""
    model = build(configs.get(ARCH), PEFTConfig(target_modules=ALL_SITES))
    text = model.kernel_policy("cuda").validate().explain()
    assert "shared/wq (3584x3584) factored_apply -> einsum" in text
    assert "shared/wv (3584x3584) factored_apply -> einsum" in text
    assert "layers/wx (3584x7168) deltaw -> cuda" in text
    assert "layers/wo_ssm (7168x3584) deltaw -> cuda" in text


# ---------------------------------------------------------------------------
# Forward, decode, training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", DEPTHS)
def test_forward_loss_and_decode_match_jax(layers):
    """Forward logits and loss against JAX's; the decode step's logits
    against JAX's forward at the same position and its tokens equal JAX's
    decode stream (the shared block's per-application KV caches, the SSM
    state carry, the tail group)."""
    jmodel, jparams, tmodel, tparams = _pair(layers, seed=1,
                                             target_modules=ALL_SITES)
    batch = _batch(2)
    jlog, _ = jmodel.forward(jparams, _j(batch))
    with torch.no_grad():
        tlog = tmodel.forward(tparams, _t(batch))
        tloss = tmodel.loss(tparams, _t(batch))
    _close(tlog, jlog)
    assert float(tloss) == pytest.approx(
        float(jmodel.loss(jparams, _j(batch))), abs=1e-5, rel=1e-4)
    dlog, dtok = _port_decode(tmodel, tparams, batch["tokens"])
    _close(dlog, jlog, atol=1e-4)
    assert np.array_equal(dtok, _jax_decode(jmodel, jparams,
                                            batch["tokens"]))


@pytest.mark.parametrize("layers", DEPTHS)
def test_decode_matches_prefill(layers):
    """The JAX suite's check on its own inputs (reduced f32, params from
    PRNGKey(1), tokens from `jax.random.randint(PRNGKey(2), ...)`,
    FourierFT n 16, alpha 10): teacher-forced decode reproduces the
    forward's argmax exactly, and so does JAX's."""
    jcfg, tcfg = _cfgs(layers)
    jcfg, tcfg = jcfg.replace(vocab=256), tcfg.replace(vocab=256)
    peft = dict(n=16, alpha=10.0, param_dtype="float32")
    jmodel = jax_build(jcfg, JaxPEFT(**peft))
    jparams = jmodel.init(jax.random.PRNGKey(1))
    toks = np.array(jax.random.randint(jax.random.PRNGKey(2), (2, 16), 0,
                                       jcfg.vocab), np.int32)
    tmodel = build(tcfg, PEFTConfig(**peft))
    tparams = from_jax_params(jax.device_get(jparams), "cpu")
    with torch.no_grad():
        full = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    _, dec = _port_decode(tmodel, tparams, toks)
    assert np.array_equal(dec, full.argmax(-1).numpy())
    assert np.array_equal(dec, _jax_decode(jmodel, jparams, toks))


@pytest.mark.parametrize("method", ["fourierft", "dct", "lora", "circulant"])
def test_shared_sites_factored_apply_matches_jax(method):
    """Each method's factored apply at the shared sites, one row per
    application (the tail's included), against JAX's forward."""
    jmodel, jparams, tmodel, tparams = _pair(5, seed=2, bump=0.05,
                                             method=method, lora_r=2)
    assert tparams["peft"]["shared/wq"][
        tmodel.method.trainable_leaves(tmodel.peft)[0]].shape[0] == 3
    batch = _batch(3)
    jlog, _ = jmodel.forward(jparams, _j(batch))
    with torch.no_grad():
        _close(tmodel.forward(tparams, _t(batch)), jlog)


@pytest.mark.parametrize("method,strategy", [("fourierft", "merged"),
                                             ("fourierft", "factored"),
                                             ("dct", "merged")])
def test_train_step_gradients_match_jax(method, strategy):
    """The loss and the coefficients' gradients of one step at every site
    against JAX's at atol 1e-5: the mamba sites merged (or factored), the
    shared rows always factored."""
    jmodel, jparams, tmodel, tparams = _pair(
        5, seed=3, method=method, strategy=strategy,
        target_modules=ALL_SITES)
    batch = _batch(6)
    jtr, jfr = jax_step.split_params(jmodel, jparams)
    jloss, jgrads = jax.value_and_grad(
        lambda tr: jmodel.loss_from_parts(tr, jfr["base"], jfr["peft"],
                                          _j(batch)))(jtr)
    trainable, frozen = ts.split_params(tmodel, tparams)
    tloss, tgrads = ts._value_and_grad(ts._loss_for(tmodel), trainable,
                                       frozen, _t(batch))
    assert float(tloss) == pytest.approx(float(jloss), abs=1e-5)
    assert set(tgrads["peft"]) == {"shared/wq", "shared/wv", "layers/wx",
                                   "layers/wo_ssm"}
    for site, g in tgrads["peft"].items():
        np.testing.assert_allclose(g["c"].numpy(),
                                   np.asarray(jgrads["peft"][site]["c"]),
                                   atol=1e-5)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_group_remat_gives_equal_gradients(remat):
    """Checkpointing a whole group (shared block and its mamba blocks)
    changes no gradient."""
    _, _, plain, tparams = _pair(5, seed=4, target_modules=ALL_SITES)
    batch = _t(_batch(7))
    trainable, frozen = ts.split_params(plain, tparams)
    loss0, g0 = ts._value_and_grad(ts._loss_for(plain), trainable, frozen,
                                   batch)
    other = build(plain.cfg, plain.peft, remat=remat)
    loss1, g1 = ts._value_and_grad(ts._loss_for(other), trainable, frozen,
                                   batch)
    assert float(loss1) == pytest.approx(float(loss0), abs=1e-6)
    for site in g0["peft"]:
        np.testing.assert_allclose(g1["peft"][site]["c"].numpy(),
                                   g0["peft"][site]["c"].numpy(), atol=1e-7)


# ---------------------------------------------------------------------------
# Merge and serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["fourierft", "lora"])
def test_merge_keeps_shared_leftovers_under_their_method(method):
    """JAX's test_zamba2_leftover_keeps_true_method on the port, with the
    mamba sites targeted too: `layers/*` folds into the base, `shared/*`
    stays in the leftover tree with the method's own leaves, the rebuilt
    model keeps the method, and merged logits equal unmerged at 5e-4 /
    1e-3."""
    _, _, tmodel, tparams = _pair(5, seed=5, bump=0.02, method=method,
                                  lora_r=2, target_modules=ALL_SITES)
    merged_model, merged = merge_for_serving(tmodel, tparams)
    assert merged_model.peft.method == method
    assert set(merged["peft"]) == {"shared/wq", "shared/wv"}
    leaf = {"lora": "lora_a", "fourierft": "c"}[method]
    assert all(leaf in d for d in merged["peft"].values())
    for key in ("wx", "wo_ssm"):
        assert not torch.equal(merged["base"]["layers"][key],
                               tparams["base"]["layers"][key])
    batch = _t(_batch(8, S=12))
    with torch.no_grad():
        _close(merged_model.forward(merged, batch),
               tmodel.forward(tparams, batch), atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("layers", DEPTHS)
def test_lockstep_streams_match_jax(layers):
    """Engine.generate (merge, then the recurrent prefill and decode) gives
    JAX's streams; the engine without the merge gives the same ones (its
    shared rows read frozen tables built once); the continuous scheduler
    and the paged cache refuse the family, as JAX's do."""
    jmodel, jparams, tmodel, tparams = _pair(layers, seed=9, n=100,
                                             alpha=300.0,
                                             target_modules=ALL_SITES)
    prompts = _prompts()
    jouts = JaxEngine(jmodel, jparams, batch_slots=3, max_len=32).generate(
        [jnp.asarray(p) for p in prompts], max_new=7)
    tp = [torch.from_numpy(p) for p in prompts]
    engine = Engine(tmodel, tparams, batch_slots=3, max_len=32,
                    device="cpu")
    assert "cos_t" in engine.params["peft"]["shared/wq"]
    assert _min_margin(engine, prompts, _streams(jouts)) > 1e-4
    assert _streams(engine.generate(tp, max_new=7)) == _streams(jouts)
    unmerged = Engine(tmodel, tparams, batch_slots=3, max_len=32,
                      merge=False, device="cpu")
    assert _streams(unmerged.generate(tp, max_new=7)) == _streams(jouts)
    with pytest.raises(NotImplementedError):
        ContinuousScheduler(engine)
    with pytest.raises(NotImplementedError, match="per-slot cache"):
        tmodel.init_cache(2, 8, torch.float32, "cpu", paged=True, n_pages=4)


def test_bank_matches_jax_and_none_rows_the_bare_base():
    """JAX's test_hybrid_family_bank on the port: the bank rides the mamba
    sites, the tenant's stream equals JAX's bank engine's, and the None
    row's equals the bare base's."""
    jcfg, tcfg = _cfgs(5)
    jmodel = jax_build(jcfg, JaxPEFT(method="none"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build(tcfg, PEFTConfig(method="none"))
    tparams = from_jax_params(jax.device_get(jparams), "cpu")
    prof = dict(method="fourierft", n=8, alpha=25.0, param_dtype="float32",
                target_modules=("wx", "wo_ssm"))
    jbank = JaxBank(jmodel, {"fourierft": JaxPEFT(**prof)}, capacity=2)
    tbank = AdapterBank(tmodel, {"fourierft": PEFTConfig(**prof)},
                        capacity=2, device="cpu")
    tree = jax_peft.init_adapters(jax.random.PRNGKey(3), jmodel.sites,
                                  jbank.profiles["fourierft"])
    tree = jax.tree.map(lambda x: x + 0.05 if jnp.issubdtype(
        x.dtype, jnp.floating) else x, tree)
    assert set(tree) == {"layers/wx", "layers/wo_ssm"}
    jbank.load("hy-tenant", tree, jbank.profiles["fourierft"])
    tbank.load("hy-tenant", from_jax_tenant(jax.device_get(tree), "cpu"),
               PEFTConfig(**prof))
    prompts = _prompts()[:2]
    ids = ["hy-tenant", None]
    jouts = JaxEngine(jmodel, jparams, batch_slots=2, max_len=24,
                      bank=jbank).generate([jnp.asarray(p) for p in prompts],
                                           max_new=4, adapter_ids=ids)
    tp = [torch.from_numpy(p) for p in prompts]
    touts = Engine(tmodel, tparams, batch_slots=2, max_len=24, bank=tbank,
                   device="cpu").generate(tp, max_new=4, adapter_ids=ids)
    bare = Engine(tmodel, tparams, batch_slots=2, max_len=24,
                  device="cpu").generate(tp, max_new=4)
    assert _streams(touts) == _streams(jouts)
    assert touts[1].tolist() == bare[1].tolist()


def test_adapter_checkpoint_roundtrip_is_bitwise(tmp_path):
    """The shared sites' rows export and import with the mamba sites',
    bitwise, the frozen entries regenerated."""
    _, _, tmodel, tparams = _pair(5, seed=7, target_modules=ALL_SITES)
    adapter_ckpt.export_adapter(str(tmp_path), "hybrid", tparams["peft"],
                                tmodel.peft)
    back, peft = adapter_ckpt.import_adapter(str(tmp_path), "hybrid",
                                             sites=tmodel.sites)
    assert peft == tmodel.peft
    assert set(back) == {"shared/wq", "shared/wv", "layers/wx",
                         "layers/wo_ssm"}
    for site, ad in tparams["peft"].items():
        assert set(back[site]) == set(ad)
        for leaf, v in ad.items():
            assert back[site][leaf].dtype == v.dtype
            assert torch.equal(back[site][leaf], v)


def test_launchers(capsys, monkeypatch):
    launch_train.main(["--arch", ARCH, "--reduced", "--steps", "2",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    # the shared q/v rows: 1000 coefficients x 2 applications x 2 sites
    assert "trainable=4,000" in out and "done: steps=2" in out
    assert "shared/wq (64x64) factored_apply -> einsum" in out
    launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--max-new", "5"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("prompt ")]
    assert len(lines) == 2
    monkeypatch.setattr(registry.Model, "init", lambda *a: pytest.fail(
        "weights made before the refusal"))
    with pytest.raises(NotImplementedError, match="per-slot cache"):
        launch_serve.main(["--arch", ARCH, "--reduced", "--continuous",
                           "--device", "cpu"])
    with pytest.raises(SystemExit, match="per-slot cache"):
        launch_api.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--port", "0"])
