"""The pure-SSM family (mamba2-2.7b) in the port against the JAX package, on
the CPU: the mixer's pieces (`conv1d_causal`, `_segsum`, the chunked SSD
scan, a block and a decode step), the SSD scan against its per-token
oracle and its float64 gradient, and the model at `reduced()` size in f32
(forward, loss, decode, train steps, merge, lockstep serving, the adapter
bank, checkpoints and the launchers).

Params come from `repro`'s init and cross over through
`repro_torch.convert.from_jax_params`; inputs are seeded numpy arrays
handed to both sides. Tolerances are the JAX suite's: f32 outputs at
atol 1e-5 / rtol 1e-4 (tests/test_models.py), the scan against its oracle
and across chunk sizes at atol 1e-4 (its `TestSSD`), a train step's loss
and coefficient gradients at atol 1e-5 (tests/test_torch_train.py's),
merged against unmerged logits at 5e-4 / 1e-3 (tests/test_serve.py), and
every greedy stream exactly. The dt softplus is torch's, which is the
identity above 20 where `jax.nn.softplus` is not; the two differ by less
than 3e-9 there, far inside these tolerances."""
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
from repro.models import mamba2 as jmamba
from repro.serve import AdapterBank as JaxBank
from repro.serve import Engine as JaxEngine
from repro.train import step as jax_step
from repro_torch import configs
from repro_torch.checkpoint import adapters as adapter_ckpt
from repro_torch.configs.base import PEFTConfig
from repro_torch.convert import from_jax_params, from_jax_tenant
from repro_torch.launch import api as launch_api
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build, mamba2, registry
from repro_torch.serve import (AdapterBank, ContinuousScheduler, Engine,
                               merge_for_serving)
from repro_torch.train import step as ts

ARCH = "mamba2-2.7b"
VOCAB = 64
N, ALPHA = 24, 10.0


def _cfgs(layers=2):
    kw = dict(vocab=VOCAB, param_dtype="float32", dtype="float32",
              num_layers=layers)
    return (jax_configs.reduced(jax_configs.get(ARCH)).replace(**kw),
            configs.reduced(configs.get(ARCH)).replace(**kw))


def _pair(seed=0, **peft):
    """(jax model, jax params, port model, port params) at reduced size in
    f32, the same weights on both sides."""
    peft = {"n": N, "alpha": ALPHA, **peft}
    jcfg, tcfg = _cfgs()
    jmodel = jax_build(jcfg, JaxPEFT(**peft))
    jparams = jmodel.init(jax.random.PRNGKey(seed))
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


def _ssd_inputs(seed, b, S, H, P, G, N_, zero_d=False, a_scale=0.5):
    """The JAX suite's SSD inputs, drawn with numpy: dt = softplus(z)·0.1,
    A = -exp(a_scale·z), D ones (zeros with `zero_d`)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(b, S, H, P)
    dt = (np.log1p(np.exp(f(b, S, H))) * 0.1).astype(np.float32)
    A = -np.exp(f(H) * a_scale).astype(np.float32)
    B, C = f(b, S, G, N_), f(b, S, G, N_)
    D = np.zeros(H, np.float32) if zero_d else np.ones(H, np.float32)
    return x, dt, A, B, C, D


def _tt(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# The mixer's pieces
# ---------------------------------------------------------------------------

def test_config_and_reduced_equal_jax():
    for full in (False, True):
        jcfg, tcfg = jax_configs.get(ARCH), configs.get(ARCH)
        if not full:
            jcfg, tcfg = jax_configs.reduced(jcfg), configs.reduced(tcfg)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert ARCH in configs.ARCHS


def test_conv1d_causal_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 20)).astype(np.float32)
    w = rng.standard_normal((20, 4)).astype(np.float32)
    b = rng.standard_normal(20).astype(np.float32)
    out = mamba2.conv1d_causal(*_tt(x, w, b))
    _close(out, jmamba.conv1d_causal(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b)))
    # the taps accumulate in f32 and the result comes back in x's dtype
    assert mamba2.conv1d_causal(torch.from_numpy(x).bfloat16(),
                                *_tt(w, b)).dtype == torch.bfloat16


def test_segsum_matches_jax():
    dta = -np.abs(np.random.default_rng(1).standard_normal(
        (2, 3, 8))).astype(np.float32)
    out = mamba2._segsum(torch.from_numpy(dta))
    ref = np.asarray(jmamba._segsum(jnp.asarray(dta)))
    assert np.array_equal(np.isneginf(out.numpy()), np.isneginf(ref))
    _close(out, ref)


def test_ssd_chunked_matches_jax():
    x, dt, A, B, C, D = _ssd_inputs(2, 2, 32, 4, 8, 2, 16)
    y, final = mamba2.ssd_chunked(*_tt(x, dt, A, B, C, D), chunk=16)
    jy, jfinal = jmamba.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C, D)),
                                    chunk=16)
    _close(y, jy)
    _close(final, jfinal)


def test_ssd_chunked_matches_its_oracle():
    """JAX's TestSSD.test_chunked_matches_recurrence on the port."""
    args = _tt(*_ssd_inputs(0, 2, 64, 4, 8, 2, 16))
    y1, f1 = mamba2.ssd_chunked(*args, chunk=16)
    y2, f2 = mamba2.ssd_recurrent_oracle(*args)
    _close(y1, y2, atol=1e-4, rtol=0)
    _close(f1, f2, atol=1e-4, rtol=0)


@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
def test_ssd_chunk_size_invariance(chunk):
    """JAX's TestSSD.test_chunk_size_invariance: every chunk size gives the
    oracle's output within 1e-4."""
    args = _tt(*_ssd_inputs(1, 1, 64, 2, 4, 1, 8, zero_d=True, a_scale=1.0))
    y, final = mamba2.ssd_chunked(*args, chunk=chunk)
    y_ref, f_ref = mamba2.ssd_recurrent_oracle(*args)
    _close(y, y_ref, atol=1e-4, rtol=0)
    _close(final, f_ref, atol=1e-4, rtol=0)


def test_ssd_gradient_matches_float64():
    """The chunked scan's f32 gradient (every input, through the masked
    exp(-inf) entries of the segment sums) against float64 autograd of the
    same scan, and that against the float64 oracle's: no NaN, each
    gradient within 1e-4 of its largest |value|."""
    x, dt, A, B, C, D = _ssd_inputs(3, 2, 32, 4, 8, 2, 16)
    rng = np.random.default_rng(4)
    cot = rng.standard_normal(x.shape)
    cot_s = rng.standard_normal((2, 4, 8, 16))

    def grads(fn, dtype, **kw):
        xs = [torch.from_numpy(a).to(dtype).requires_grad_(True)
              for a in (x, dt, A, B, C, D)]
        y, final = fn(*xs, **kw)
        loss = (y * torch.from_numpy(cot).to(dtype)).sum() \
            + (final * torch.from_numpy(cot_s).to(dtype)).sum()
        return [g.double() for g in torch.autograd.grad(loss, xs)]

    g32 = grads(mamba2.ssd_chunked, torch.float32, chunk=8)
    g64 = grads(mamba2.ssd_chunked, torch.float64, chunk=8)
    oracle = grads(mamba2.ssd_recurrent_oracle, torch.float64)
    for a, b, c in zip(g32, g64, oracle):
        assert torch.isfinite(a).all()
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale
        assert float((b - c).abs().max()) <= 1e-10 * scale


def _block_params(seed):
    jcfg, _ = _cfgs()
    jp = jmamba.init_mamba_params(jax.random.PRNGKey(seed), jcfg, 0,
                                  jnp.float32)
    return jcfg, jp, from_jax_params(jax.device_get(jp), "cpu")


def test_mamba_block_matches_jax():
    cfg, jp, tp = _block_params(5)
    x = np.random.default_rng(5).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    _close(mamba2.mamba_block(tp, torch.from_numpy(x), cfg),
           jmamba.mamba_block(jp, jnp.asarray(x), cfg))


def test_mamba_decode_step_matches_jax():
    """One token from a non-zero cache: output, conv history and state."""
    cfg, jp, tp = _block_params(6)
    rng = np.random.default_rng(6)
    jc = jmamba.init_mamba_cache(cfg, 1, 2, jnp.float32)
    cache = {k: (rng.standard_normal(v.shape[1:]) * 0.5).astype(np.float32)
             for k, v in jc.items()}
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    out, new = mamba2.mamba_decode_step(
        tp, {k: torch.from_numpy(v) for k, v in cache.items()},
        torch.from_numpy(x), cfg)
    jout, jnew = jmamba.mamba_decode_step(
        jp, {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(x),
        cfg)
    _close(out, jout)
    for k in ("conv", "ssm"):
        _close(new[k], jnew[k])


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

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


def test_forward_loss_and_decode_match_jax():
    """Forward logits and loss against JAX's; the decode step's logits
    against JAX's forward at the same position (the stepwise recurrence and
    the chunked scan differ by f32 rounding) and its tokens equal JAX's
    decode stream."""
    jmodel, jparams, tmodel, tparams = _pair(seed=1)
    batch = _batch(2)
    jlog, jaux = jmodel.forward(jparams, _j(batch))
    with torch.no_grad():
        tlog = tmodel.forward(tparams, _t(batch))
        tloss = tmodel.loss(tparams, _t(batch))
    assert tuple(tlog.shape) == (2, 16, VOCAB) and float(jaux) == 0.0
    _close(tlog, jlog)
    assert float(tloss) == pytest.approx(
        float(jmodel.loss(jparams, _j(batch))), abs=1e-5, rel=1e-4)
    dlog, dtok = _port_decode(tmodel, tparams, batch["tokens"])
    _close(dlog, jlog)
    assert np.array_equal(dtok, _jax_decode(jmodel, jparams,
                                            batch["tokens"]))


def test_decode_matches_prefill():
    """The JAX suite's check on its own inputs (tests/test_models.py: the
    reduced f32 config, params from PRNGKey(1), tokens from
    `jax.random.randint(PRNGKey(2), ...)`, FourierFT n 16, alpha 10):
    teacher-forced decode reproduces the forward's argmax exactly, and so
    does JAX's."""
    cfg = jax_configs.reduced(jax_configs.get(ARCH)).replace(
        param_dtype="float32", dtype="float32")
    peft = dict(n=16, alpha=10.0, param_dtype="float32")
    jmodel = jax_build(cfg, JaxPEFT(**peft))
    jparams = jmodel.init(jax.random.PRNGKey(1))
    toks = np.array(jax.random.randint(jax.random.PRNGKey(2), (2, 16), 0,
                                       cfg.vocab), np.int32)
    tmodel = build(configs.reduced(configs.get(ARCH)).replace(
        param_dtype="float32", dtype="float32"), PEFTConfig(**peft))
    tparams = from_jax_params(jax.device_get(jparams), "cpu")
    with torch.no_grad():
        full = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    _, dec = _port_decode(tmodel, tparams, toks)
    assert np.array_equal(dec, full.argmax(-1).numpy())
    assert np.array_equal(dec, _jax_decode(jmodel, jparams, toks))


@pytest.mark.parametrize("method", ["fourierft", "lora", "full"])
def test_sites_targets_and_table1_equal_jax(method):
    """At full size: the sites, the default targets (the generic q/v
    resolve to wx/wo_ssm), Table 1's trainable count and the storage
    bytes equal JAX's; on the card K1 takes both sites."""
    jm = jax_build(jax_configs.get(ARCH), JaxPEFT(method=method))
    tm = build(configs.get(ARCH), PEFTConfig(method=method))
    assert [dataclasses.astuple(s) for s in tm.sites] == \
        [dataclasses.astuple(s) for s in jm.sites]
    assert registry.default_targets(tm.cfg) == ("wx", "wo_ssm")
    assert tm.trainable_params() == jm.trainable_params()
    if method == "full":
        return
    assert tm.peft.target_modules == jm.peft.target_modules \
        == ("wx", "wo_ssm")
    assert tm.trainable_params() == {"fourierft": 1000 * 64 * 2,
                                     "lora": 8 * 7680 * 64 * 2}[method]
    from repro_torch.core import peft as tpeft
    assert tpeft.storage_bytes(tm.sites, tm.peft) == \
        jax_peft.storage_bytes(jm.sites, jm.peft)
    if method == "fourierft":
        text = tm.kernel_policy("cuda").validate().explain()
        assert "layers/wx (2560x5120) deltaw -> cuda" in text
        assert "layers/wo_ssm (5120x2560) deltaw -> cuda" in text


@pytest.mark.parametrize("method,strategy", [("fourierft", "merged"),
                                             ("fourierft", "factored"),
                                             ("dct", "merged")])
def test_train_step_gradients_match_jax(method, strategy):
    """The loss and the coefficients' gradients of one step against JAX's
    at atol 1e-5, merged (ΔW folded before the layer loop) and factored."""
    jmodel, jparams, tmodel, tparams = _pair(seed=3, method=method,
                                             strategy=strategy)
    batch = _batch(6)
    jtr, jfr = jax_step.split_params(jmodel, jparams)
    jloss, jgrads = jax.value_and_grad(
        lambda tr: jmodel.loss_from_parts(tr, jfr["base"], jfr["peft"],
                                          _j(batch)))(jtr)
    trainable, frozen = ts.split_params(tmodel, tparams)
    tloss, tgrads = ts._value_and_grad(ts._loss_for(tmodel), trainable,
                                       frozen, _t(batch))
    assert float(tloss) == pytest.approx(float(jloss), abs=1e-5)
    for site in ("layers/wx", "layers/wo_ssm"):
        np.testing.assert_allclose(tgrads["peft"][site]["c"].numpy(),
                                   np.asarray(jgrads["peft"][site]["c"]),
                                   atol=1e-5)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_modes_give_equal_gradients(remat):
    _, _, plain, tparams = _pair(seed=4)
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


def _prompts():
    rng = np.random.default_rng(9)
    return [rng.integers(0, VOCAB, size=n).astype(np.int32)
            for n in (5, 9, 3)]


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


def test_merge_and_lockstep_streams_match_jax():
    """merge_for_serving folds both sites (nothing left over, method
    `none`); merged logits equal unmerged at 5e-4 / 1e-3; Engine.generate
    through the recurrent prefill gives JAX's streams; the paged cache
    refuses the family, as JAX's does."""
    jmodel, jparams, tmodel, tparams = _pair(seed=5, n=100, alpha=300.0)
    merged_model, merged = merge_for_serving(tmodel, tparams)
    assert not merged["peft"] and merged_model.peft.method == "none"
    batch = _t(_batch(8))
    with torch.no_grad():
        _close(merged_model.forward(merged, batch),
               tmodel.forward(tparams, batch), atol=5e-4, rtol=1e-3)
    prompts = _prompts()
    jouts = JaxEngine(jmodel, jparams, batch_slots=3, max_len=32).generate(
        [jnp.asarray(p) for p in prompts], max_new=7)
    engine = Engine(tmodel, tparams, batch_slots=3, max_len=32,
                    device="cpu")
    touts = engine.generate([torch.from_numpy(p) for p in prompts],
                            max_new=7)
    jstreams = [np.asarray(j).tolist() for j in jouts]
    assert _min_margin(engine, prompts, jstreams) > 1e-4
    assert [t.tolist() for t in touts] == jstreams
    with pytest.raises(NotImplementedError, match="per-slot cache"):
        tmodel.init_cache(2, 8, torch.float32, "cpu", paged=True, n_pages=4)


def test_continuous_scheduler_refuses_the_family():
    """JAX's tests/test_serve_scheduler.py::test_unsupported_family_raises
    on the port: an engine over a reduced mamba2 builds, the scheduler
    raises NotImplementedError (the model reports no per-slot cache)."""
    cfg = configs.reduced(configs.get(ARCH)).replace(
        vocab=64, param_dtype="float32", dtype="float32")
    model = build(cfg, PEFTConfig(method="none"))
    engine = Engine(model, model.init(0, "cpu"), batch_slots=2, max_len=32,
                    device="cpu")
    with pytest.raises(NotImplementedError):
        ContinuousScheduler(engine)


def test_bank_matches_jax_and_none_rows_the_bare_base():
    """JAX's test_ssm_family_bank on the port: the profile's generic q/v
    targets resolve to wx/wo_ssm, the tenant's stream equals JAX's bank
    engine's, and the None row's equals the bare base's."""
    jcfg, tcfg = _cfgs()
    jmodel = jax_build(jcfg, JaxPEFT(method="none"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build(tcfg, PEFTConfig(method="none"))
    tparams = from_jax_params(jax.device_get(jparams), "cpu")
    prof = {"fourierft": dict(method="fourierft", n=8, alpha=25.0,
                              param_dtype="float32")}
    jbank = JaxBank(jmodel, {k: JaxPEFT(**v) for k, v in prof.items()},
                    capacity=2)
    tbank = AdapterBank(tmodel, {k: PEFTConfig(**v) for k, v in prof.items()},
                        capacity=2, device="cpu")
    assert tbank.profiles["fourierft"].target_modules == ("wx", "wo_ssm")
    tree = jax_peft.init_adapters(jax.random.PRNGKey(3), jmodel.sites,
                                  jbank.profiles["fourierft"])
    tree = jax.tree.map(lambda x: x + 0.05 if jnp.issubdtype(
        x.dtype, jnp.floating) else x, tree)
    jbank.load("ssm-tenant", tree, jbank.profiles["fourierft"])
    tbank.load("ssm-tenant", from_jax_tenant(jax.device_get(tree), "cpu"),
               PEFTConfig(**prof["fourierft"]))
    prompts = _prompts()[:2]
    ids = ["ssm-tenant", None]
    jouts = JaxEngine(jmodel, jparams, batch_slots=2, max_len=24,
                      bank=jbank).generate([jnp.asarray(p) for p in prompts],
                                           max_new=4, adapter_ids=ids)
    touts = Engine(tmodel, tparams, batch_slots=2, max_len=24, bank=tbank,
                   device="cpu").generate(
        [torch.from_numpy(p) for p in prompts], max_new=4, adapter_ids=ids)
    bare = Engine(tmodel, tparams, batch_slots=2, max_len=24,
                  device="cpu").generate(
        [torch.from_numpy(p) for p in prompts], max_new=4)
    assert [t.tolist() for t in touts] == \
        [np.asarray(j).tolist() for j in jouts]
    assert touts[1].tolist() == bare[1].tolist()


def test_adapter_checkpoint_roundtrip_is_bitwise(tmp_path):
    _, _, tmodel, tparams = _pair(seed=6)
    adapter_ckpt.export_adapter(str(tmp_path), "ssm", tparams["peft"],
                                tmodel.peft)
    back, peft = adapter_ckpt.import_adapter(str(tmp_path), "ssm",
                                             sites=tmodel.sites)
    assert peft == tmodel.peft and set(back) == set(tparams["peft"])
    for site, ad in tparams["peft"].items():
        assert set(back[site]) == set(ad)
        for leaf, v in ad.items():
            assert back[site][leaf].dtype == v.dtype
            assert torch.equal(back[site][leaf], v)


@pytest.mark.parametrize("arch", [ARCH, "olmoe-1b-7b"])
def test_converter_keeps_jax_f32_leaves_f32(arch):
    """dt_bias, A_log, Dp (mamba) and the MoE router arrive f32 under a
    casting `dtype=`, as JAX keeps them whatever param_dtype is; every
    other floating leaf takes the cast."""
    cfg = jax_configs.reduced(jax_configs.get(arch))
    jparams = jax.device_get(jax_build(cfg, JaxPEFT(n=N)).init(
        jax.random.PRNGKey(0)))
    tparams = from_jax_params(jparams, "cpu", dtype=torch.float16)
    layers = tparams["base"]["layers"]
    keep = [k for k in ("router", "dt_bias", "A_log", "Dp") if k in layers]
    assert keep
    for k, v in layers.items():
        want = torch.float32 if k in keep else torch.float16
        assert v.dtype == want, k
        if k in keep:
            assert torch.equal(v, torch.from_numpy(np.array(
                jparams["base"]["layers"][k])))


def test_launchers(capsys, monkeypatch):
    launch_train.main(["--arch", ARCH, "--reduced", "--steps", "2",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "trainable=4,000" in out and "done: steps=2" in out
    assert "layers/wx (64x128) deltaw -> einsum" in out
    launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--max-new", "5"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("prompt ")]
    assert len(lines) == 2
    # refused before any weight is made
    monkeypatch.setattr(registry.Model, "init", lambda *a: pytest.fail(
        "weights made before the refusal"))
    with pytest.raises(NotImplementedError, match="per-slot cache"):
        launch_serve.main(["--arch", ARCH, "--reduced", "--continuous",
                           "--device", "cpu"])
    with pytest.raises(SystemExit, match="per-slot cache"):
        launch_api.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--port", "0"])
