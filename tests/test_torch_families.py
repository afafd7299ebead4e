"""The transformer's other families in the port against the JAX package, on
the CPU: moe (olmoe-1b-7b, phi3.5-moe), audio with codebooks
(musicgen-medium) and vlm with embedding inputs and M-RoPE (qwen2-vl-72b),
at `reduced()` size in f32.

Params come from `repro`'s `Model.init` and cross over through
`repro_torch.convert.from_jax_params`; batches are seeded numpy arrays
handed to both sides. Tolerances are the JAX suite's: logits and loss at
atol 1e-5 / rtol 1e-4 (tests/test_models.py), a train step's coefficient
gradients at atol 1e-5 (tests/test_torch_train.py's), M-RoPE at 1e-5; the
MoE routing (expert ids, slots, drops) and every greedy stream exactly."""
import ast
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.configs.base import MoEConfig as JaxMoE
from repro.configs.base import PEFTConfig as JaxPEFT
from repro.models import build as jax_build
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.serve import Engine as JaxEngine
from repro.train import step as jax_step
from repro_torch import configs
from repro_torch.configs.base import MoEConfig, PEFTConfig, TrainConfig
from repro_torch.convert import from_jax_params
from repro_torch.kernels import api as kernel_api
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build, moe, transformer
from repro_torch.models import common as tcommon
from repro_torch.models.registry import adapter_sites
from repro_torch.serve import ContinuousScheduler, Engine, Request
from repro_torch.train import step as ts

FAMILY_ARCHS = ("olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "musicgen-medium",
                "qwen2-vl-72b")
VOCAB = 64
N, ALPHA = 24, 10.0


def _cfgs(arch):
    kw = dict(vocab=VOCAB, param_dtype="float32", dtype="float32")
    return (jax_configs.reduced(jax_configs.get(arch)).replace(**kw),
            configs.reduced(configs.get(arch)).replace(**kw))


def _pair(arch, seed=0, n=N, alpha=ALPHA):
    """(jax model, jax params, port model, port params) of `arch` at
    reduced size in f32, the same weights on both sides."""
    jcfg, tcfg = _cfgs(arch)
    jmodel = jax_build(jcfg, JaxPEFT(n=n, alpha=alpha))
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tmodel = build(tcfg, PEFTConfig(n=n, alpha=alpha))
    return jmodel, jparams, tmodel, from_jax_params(jax.device_get(jparams),
                                                    "cpu")


def _batch(cfg, seed, B=2, S=12):
    """A seeded training batch in the family's layout: tokens (B, S) or
    (B, S, CB); for vlm, embeds (B, S, d) and (3, B, S) M-RoPE positions
    whose three streams differ."""
    rng = np.random.default_rng(seed)
    lbl = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    labels = rng.integers(0, cfg.vocab, size=lbl).astype(np.int32)
    if not cfg.embed_inputs:
        t = np.arange(S, dtype=np.int32)
        pos = np.stack([t, t // 2, t % 3])[:, None, :].repeat(B, axis=1)
        return {"embeds": (rng.standard_normal((B, S, cfg.d_model))
                           * 0.5).astype(np.float32),
                "positions": np.ascontiguousarray(pos), "labels": labels}
    toks = rng.integers(0, cfg.vocab, size=lbl).astype(np.int32)
    return {"tokens": toks, "labels": labels}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _stream(tokens):
    return np.asarray(tokens).tolist()


# ---------------------------------------------------------------------------
# Configs and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_config_and_reduced_equal_jax(arch):
    for full in (False, True):
        jcfg = jax_configs.get(arch)
        tcfg = configs.get(arch)
        if not full:
            jcfg, tcfg = jax_configs.reduced(jcfg), configs.reduced(tcfg)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert arch in configs.ARCHS


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-2.7b"])
def test_ssm_and_hybrid_archs_still_refused(arch):
    """The recurrent families are ported (tests/test_torch_ssm.py and
    tests/test_torch_hybrid.py hold them to JAX): their configs equal
    JAX's and their models build and serve lockstep. What both packages
    still refuse them is the per-slot cache, so the continuous scheduler
    raises, as JAX's does."""
    assert dataclasses.asdict(configs.get(arch)) == dataclasses.asdict(
        jax_configs.get(arch))
    jcfg, tcfg = _cfgs(arch)
    model = build(tcfg)
    assert not model.supports_slot_cache
    assert not jax_build(jcfg).supports_slot_cache
    engine = Engine(model, model.init(0, "cpu"), batch_slots=2, max_len=16,
                    device="cpu")
    assert len(engine.generate([torch.arange(3, dtype=torch.int32)],
                               max_new=2)[0]) == 2
    with pytest.raises(NotImplementedError):
        ContinuousScheduler(engine)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_converter_carries_every_family_leaf(arch):
    """Every leaf of a JAX params tree lands at its key path with its shape
    and dtype: the f32 router, the (L, E, d, f) experts, the (CB, V, d)
    embedding and (CB, d, V) head, no embedding for vlm."""
    cfg = jax_configs.reduced(jax_configs.get(arch))       # bf16 params
    jparams = jax.device_get(jax_build(cfg, JaxPEFT(n=N)).init(
        jax.random.PRNGKey(0)))
    tparams = from_jax_params(jparams, "cpu")
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat) == sum(1 for _ in _leaves(tparams))
    for path, leaf in flat:
        node = tparams
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
    layers = tparams["base"]["layers"]
    if cfg.moe is not None:
        assert layers["router"].dtype == torch.float32
        assert layers["we_i"].shape == (cfg.num_layers, cfg.moe.num_experts,
                                        cfg.d_model, cfg.moe.d_ff_expert)
        assert "wi" not in layers
    if cfg.n_codebooks:
        assert tparams["base"]["embed"].shape == (cfg.n_codebooks, cfg.vocab,
                                                  cfg.d_model)
        assert tparams["base"]["lm_head"].shape == (cfg.n_codebooks,
                                                    cfg.d_model, cfg.vocab)
    assert ("embed" in tparams["base"]) == cfg.embed_inputs
    # the port's own init makes the same tree
    mine = build(configs.reduced(configs.get(arch)),
                 PEFTConfig(n=N)).init(0, "cpu")
    assert {k: tuple(v.shape) for k, v in _leaves(mine)} == \
        {k: tuple(v.shape) for k, v in _leaves(tparams)}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


# ---------------------------------------------------------------------------
# Forward, loss, M-RoPE and the MoE layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_and_loss_match_jax(arch):
    jmodel, jparams, tmodel, tparams = _pair(arch, seed=1)
    cfg = tmodel.cfg
    batch = _batch(cfg, 2)
    jlog, jaux = jmodel.forward(jparams, _j(batch))
    tlog, taux = transformer.forward(tparams["base"], tparams["peft"],
                                     _t(batch), cfg, tmodel.peft,
                                     tmodel.sites)
    shape = (2, 12) + ((cfg.n_codebooks,) if cfg.n_codebooks else ()) \
        + (VOCAB,)
    assert tuple(tlog.shape) == shape
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5,
                               rtol=1e-4)
    if cfg.moe is not None:
        assert float(taux) > 0.5                  # E·Σ f·P ≈ 1 when balanced
    np.testing.assert_allclose(float(tmodel.loss(tparams, _t(batch))),
                               float(jmodel.loss(jparams, _j(batch))),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("gated", [True, False])
def test_moe_ffn_with_drops_matches_jax(gated):
    """At capacity factor 0.25 an expert takes 8 of the ~16 (token, k)
    choices routed to it: ids, slots and the keep mask equal JAX's exactly,
    and the output and aux loss agree at 1e-5."""
    B, S, d, E, k, f = 2, 64, 32, 8, 2, 48
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    p = {"router": rng.standard_normal((d, E)).astype(np.float32),
         "we_i": (rng.standard_normal((E, d, f)) * 0.1).astype(np.float32),
         "we_g": (rng.standard_normal((E, d, f)) * 0.1).astype(np.float32),
         "we_o": (rng.standard_normal((E, f, d)) * 0.1).astype(np.float32)}
    tcfg = MoEConfig(num_experts=E, top_k=k, d_ff_expert=f,
                     capacity_factor=0.25)
    jcfg = JaxMoE(num_experts=E, top_k=k, d_ff_expert=f,
                  capacity_factor=0.25)
    cap = moe.capacity(S, tcfg)
    assert cap == jmoe.capacity(S, jcfg) == 8
    logits = np.einsum("bsd,de->bse", x, p["router"])
    jg, jids, jaux = jmoe.route(jnp.asarray(logits), jcfg)
    tg, tids, taux = moe.route(torch.from_numpy(logits), tcfg)
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    jslots, jkeep = jax.vmap(lambda i: jmoe.assign_slots(i, E, cap))(jids)
    tslots, tkeep = moe.assign_slots(tids, E, cap)
    assert np.array_equal(tslots.numpy(), np.asarray(jslots))
    assert np.array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert not tkeep.all()                      # tokens were dropped
    jy, jaux2 = jmoe.moe_ffn(jnp.asarray(x),
                             {n: jnp.asarray(a) for n, a in p.items()},
                             jcfg, gated=gated)
    ty, taux2 = moe.moe_ffn(torch.from_numpy(x),
                            {n: torch.from_numpy(a) for n, a in p.items()},
                            tcfg, gated=gated)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(float(taux2), float(jaux2), atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6)


def test_mrope_matches_jax():
    assert tcommon.mrope_sections(128) == jcommon.mrope_sections(128) \
        == (16, 24, 24)
    assert tcommon.mrope_sections(16) == jcommon.mrope_sections(16)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 4, 128)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(3, 2, 8)).astype(np.int32)
    ref = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                             mrope=True)
    out = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             1e6, mrope=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    # equal streams give plain RoPE
    same = np.broadcast_to(pos[0], (3, 2, 8))
    np.testing.assert_allclose(
        tcommon.apply_rope(torch.from_numpy(x),
                           torch.from_numpy(np.ascontiguousarray(same)),
                           1e6, mrope=True).numpy(),
        tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]),
                           1e6).numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# Decode and training
# ---------------------------------------------------------------------------

def _decode_all(model, params, tokens, decode):
    """Teacher-forced decode of (B, S[, CB]) tokens, one position a step:
    (B, S[, CB]) greedy tokens."""
    B, S = tokens.shape[:2]
    cache = model.init_cache(B, S + 2, **decode)
    outs = []
    for t in range(S):
        nt, cache = model.decode_step(params, cache,
                                      {"tokens": tokens[:, t:t + 1]})
        outs.append(np.asarray(nt))
    return np.stack(outs, axis=1)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "musicgen-medium"])
def test_decode_matches_prefill(arch):
    """The JAX suite's check on its own inputs (tests/test_models.py: the
    reduced f32 config, params from PRNGKey(1), tokens from
    `jax.random.randint(PRNGKey(2), ...)`, FourierFT n 16, alpha 10):
    teacher-forced decode reproduces the full forward's argmax exactly,
    (B,) tokens a step, or (B, CB) for codebooks; and so does JAX's."""
    cfg = jax_configs.reduced(jax_configs.get(arch)).replace(
        param_dtype="float32", dtype="float32")
    jmodel = jax_build(cfg, JaxPEFT(n=16, alpha=10.0))
    jparams = jmodel.init(jax.random.PRNGKey(1))
    shape = (2, 16) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    toks = np.array(jax.random.randint(jax.random.PRNGKey(2), shape, 0,
                                         cfg.vocab), np.int32)
    tmodel = build(configs.reduced(configs.get(arch)).replace(
        param_dtype="float32", dtype="float32"), PEFTConfig(n=16, alpha=10.0))
    tparams = from_jax_params(jax.device_get(jparams), "cpu")
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        full = tmodel.forward(tparams, {"tokens": tt}).argmax(dim=-1)
        dec = _decode_all(tmodel, tparams, tt,
                          dict(dtype=torch.float32, device="cpu"))
    assert np.array_equal(dec, full.numpy())
    jdec = _decode_all(jmodel, jparams, jnp.asarray(toks),
                       dict(dtype=jnp.float32))
    assert np.array_equal(dec, jdec)


def test_moe_decode_follows_jax_where_the_forward_drops(monkeypatch):
    """Where the full forward drops expert choices past capacity (a decode
    step, one token a sequence, never does), decode and prefill part in
    JAX too; the port's decode stream and forward argmax each equal JAX's
    exactly."""
    jmodel, jparams, tmodel, tparams = _pair("olmoe-1b-7b", seed=1)
    toks = _batch(tmodel.cfg, 2, B=2, S=16)["tokens"]
    tt = torch.from_numpy(toks)
    dropped, assign = [], moe.assign_slots

    def counting(ids, num_experts, cap):
        slots, keep = assign(ids, num_experts, cap)
        dropped.append(int((~keep).sum()))
        return slots, keep

    monkeypatch.setattr(moe, "assign_slots", counting)
    with torch.no_grad():
        full = tmodel.forward(tparams, {"tokens": tt}).argmax(dim=-1)
        assert sum(dropped) > 0
        dec = _decode_all(tmodel, tparams, tt,
                          dict(dtype=torch.float32, device="cpu"))
    jlogits, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    jdec = _decode_all(jmodel, jparams, jnp.asarray(toks),
                       dict(dtype=jnp.float32))
    assert np.array_equal(full.numpy(), np.asarray(jlogits.argmax(-1)))
    assert np.array_equal(dec, jdec)
    assert not np.array_equal(dec, full.numpy())     # the drops show


def test_vlm_decode_step_matches_jax():
    """qwen2-vl decodes from an embeds batch with (3, B, 1) positions; the
    next tokens after a prefill and one decode step equal JAX's."""
    jmodel, jparams, tmodel, tparams = _pair("qwen2-vl-72b", seed=2)
    cfg = tmodel.cfg
    batch = _batch(cfg, 4, B=2, S=6)
    batch.pop("labels")
    jcache = jmodel.init_cache(2, 8, dtype=jnp.float32)
    tcache = tmodel.init_cache(2, 8, torch.float32, "cpu")
    jnt, jcache = jmodel.prefill(jparams, jcache, _j(batch))
    with torch.no_grad():
        tnt, tcache = tmodel.prefill(tparams, tcache, _t(batch))
    assert _stream(tnt) == _stream(jnt)
    step = {"embeds": batch["embeds"][:, -1:] * 0.5,
            "positions": np.full((3, 2, 1), 6, np.int32)}
    jnt, _ = jmodel.decode_step(jparams, jcache, _j(step))
    with torch.no_grad():
        tnt, tcache = tmodel.decode_step(tparams, tcache, _t(step))
    assert _stream(tnt) == _stream(jnt) and tcache["pos"] == 7
    with pytest.raises(NotImplementedError, match="per-slot cache"):
        tmodel.init_cache(2, 8, torch.float32, "cpu", paged=True,
                          n_pages=4)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_step_gradients_match_jax(arch):
    """The loss (MoE aux included) and the FourierFT coefficients'
    gradients of one step against JAX's at atol 1e-5."""
    jmodel, jparams, tmodel, tparams = _pair(arch, seed=3)
    batch = _batch(tmodel.cfg, 6)
    jtr, jfr = jax_step.split_params(jmodel, jparams)
    jloss, jgrads = jax.value_and_grad(
        lambda tr: jmodel.loss_from_parts(tr, jfr["base"], jfr["peft"],
                                          _j(batch)))(jtr)
    trainable, frozen = ts.split_params(tmodel, tparams)
    tloss, tgrads = ts._value_and_grad(ts._loss_for(tmodel), trainable,
                                       frozen, _t(batch))
    assert float(tloss) == pytest.approx(float(jloss), abs=1e-5)
    for site in ("layers/wq", "layers/wv"):
        np.testing.assert_allclose(tgrads["peft"][site]["c"].numpy(),
                                   np.asarray(jgrads["peft"][site]["c"]),
                                   atol=1e-5)


def test_vlm_microbatches_split_positions_along_the_batch():
    """Microbatch 2 splits the (3, B, S) positions along B: the step's loss
    and update equal one full-batch step's."""
    _, _, tmodel, tparams = _pair("qwen2-vl-72b", seed=4)
    batch = _t(_batch(tmodel.cfg, 7, B=4, S=8))
    batch["positions"][:, 2:] += 5                # halves differ
    outs = []
    for mb in (0, 2):
        state, frozen = ts.state_from_params(tmodel, tparams)
        step = ts.make_train_step(tmodel, TrainConfig(
            total_steps=2, warmup_steps=1, microbatch=mb))
        state, metrics = step(state, frozen, batch)
        outs.append((float(metrics["loss"]),
                     state["trainable"]["peft"]["layers/wq"]["c"]))
    assert outs[0][0] == pytest.approx(outs[1][0], abs=1e-6)
    torch.testing.assert_close(outs[0][1], outs[1][1], atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _prompts(page):
    rng = np.random.default_rng(0)
    shared = rng.integers(0, VOCAB, size=2 * page)
    return [np.concatenate([shared, rng.integers(0, VOCAB, size=5)]),
            rng.integers(0, VOCAB, size=7),
            np.concatenate([shared, rng.integers(0, VOCAB, size=3)]),
            rng.integers(0, VOCAB, size=12),
            shared.copy(),
            rng.integers(0, VOCAB, size=3)]


def test_olmoe_continuous_paged_streams_match_jax_serial():
    """The port's continuous scheduler over the paged cache (prefix reuse
    and a COW clone included) gives JAX's serial `Engine.generate` streams
    (the reference its own suite holds its scheduler to)."""
    jmodel, jparams, tmodel, tparams = _pair("olmoe-1b-7b", n=100,
                                             alpha=300.0)
    page, max_new = 8, [6, 3, 9, 1, 5, 8]
    prompts = _prompts(page)
    jeng = JaxEngine(jmodel, jparams, batch_slots=3, max_len=64)
    teng = Engine(tmodel, tparams, batch_slots=3, max_len=64, device="cpu")
    reqs = [Request(prompt=torch.from_numpy(p.astype(np.int32)), max_new=m)
            for p, m in zip(prompts, max_new)]
    sched = ContinuousScheduler(teng, page_size=page)
    sched.serve(reqs, [0.0, 0.0, 3.0, 4.0, 7.0, 9.0])
    jax_serial = [_stream(jeng.generate([jnp.asarray(p, jnp.int32)],
                                        max_new=m)[0])
                  for p, m in zip(prompts, max_new)]
    assert [r.out for r in reqs] == jax_serial
    sched.pager.assert_no_leaks()


def test_musicgen_lockstep_streams_match_jax():
    """Lockstep `Engine.generate` of (S, CB) prompts gives (T, CB) streams
    equal to JAX's; the continuous scheduler refuses codebooks."""
    jmodel, jparams, tmodel, tparams = _pair("musicgen-medium", n=100,
                                             alpha=300.0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, VOCAB, size=(n, 4)).astype(np.int32)
               for n in (5, 9, 3)]
    jeng = JaxEngine(jmodel, jparams, batch_slots=3, max_len=32)
    teng = Engine(tmodel, tparams, batch_slots=3, max_len=32, device="cpu")
    jouts = jeng.generate([jnp.asarray(p) for p in prompts], max_new=7)
    touts = teng.generate([torch.from_numpy(p) for p in prompts], max_new=7)
    assert [tuple(t.shape) for t in touts] == [(7, 4)] * 3
    assert [_stream(t) for t in touts] == [_stream(j) for j in jouts]
    with pytest.raises(NotImplementedError, match="per-slot cache"):
        ContinuousScheduler(teng)


# ---------------------------------------------------------------------------
# Kernel sites and the launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_qv_sites_resolve_to_the_cuda_kernels(arch):
    """Every new q/v shape is within K1/K2's limits (resolution needs no
    card); qwen2-vl's 29568-wide MLP is beyond MAX_D2 and refused, naming
    the limit."""
    cfg = configs.get(arch)
    for site in adapter_sites(cfg):
        peft = PEFTConfig(n=1000)
        name = site.name.split("/")[-1]
        if name in ("wq", "wv"):
            assert kernel_api.resolve_op("deltaw", "fourierft", peft,
                                         site.d_in, site.d_out,
                                         device="cuda").backend == "cuda"
        elif name == "wi" and cfg.d_ff > 29056:
            with pytest.raises(kernel_api.KernelUnavailableError,
                               match="29056"):
                kernel_api.resolve_op("deltaw", "fourierft", peft,
                                      site.d_in, site.d_out, device="cuda")


def test_launchers_on_the_families(capsys):
    launch_train.main(["--arch", "olmoe-1b-7b", "--reduced", "--steps", "2",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "trainable=4,000" in out and "done: steps=2" in out
    launch_serve.main(["--arch", "olmoe-1b-7b", "--reduced", "--continuous",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "continuous: 12 requests" in out
    launch_serve.main(["--arch", "musicgen-medium", "--reduced", "--device",
                       "cpu", "--max-new", "5"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("prompt ")]
    assert len(lines) == 2
    for ln in lines:
        stream = ast.literal_eval(ln.split(": ", 1)[1])
        assert np.asarray(stream).shape == (5, 4)
    with pytest.raises(NotImplementedError, match="per-slot cache"):
        launch_serve.main(["--arch", "musicgen-medium", "--reduced",
                           "--continuous", "--device", "cpu"])
    for main in (launch_train.main, launch_serve.main):
        with pytest.raises(SystemExit, match="embeddings"):
            main(["--arch", "qwen2-vl-72b", "--reduced", "--device", "cpu"])
