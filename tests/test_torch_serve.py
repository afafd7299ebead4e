"""The port's serving slice against the JAX package, end to end, in f32.

Params come from `repro`'s `Model.init` and cross over through
`repro_torch.convert.from_jax_params`. Then: the merged weights equal JAX
`merge_for_serving`'s (atol 2e-4); prefill and decode-step next tokens are
identical and their logits agree (atol 1e-4); `Engine.generate` streams are
identical; and the port's paged `ContinuousScheduler` replays a staggered
trace — mixed `max_new`, two prompts sharing a page-aligned prefix, one
prompt that IS a cached prefix (copy-on-write) — with token streams
identical to the JAX continuous scheduler's and to JAX's serial
`Engine.generate`. The JAX side runs its default CPU backend (the einsum
references its own suite holds against the interpret kernels)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.configs.base import PEFTConfig as JaxPEFT
from repro.models import build as jax_build
from repro.serve import ContinuousScheduler as JaxScheduler
from repro.serve import Engine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import merge_for_serving as jax_merge
from repro_torch import configs
from repro_torch.configs.base import PEFTConfig
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build
from repro_torch.serve import ContinuousScheduler, Engine, Request
from repro_torch.serve import merge_for_serving

N, ALPHA = 100, 300.0
PAGE = 8
MAX_LEN = 64


def _cfgs(arch="yi-6b"):
    kw = dict(vocab=64, param_dtype="float32", dtype="float32")
    return (jax_configs.reduced(jax_configs.get(arch)).replace(**kw),
            configs.reduced(configs.get(arch)).replace(**kw))


def _pair(arch="yi-6b", seed=0):
    """(jax model, jax params, port model, port params) — same weights."""
    jcfg, tcfg = _cfgs(arch)
    jmodel = jax_build(jcfg, JaxPEFT(n=N, alpha=ALPHA))
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tmodel = build(tcfg, PEFTConfig(n=N, alpha=ALPHA))
    tparams = from_jax_params(jax.device_get(jparams), "cpu")
    return jmodel, jparams, tmodel, tparams


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _prompts():
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 64, size=2 * PAGE)          # two full pages
    return [
        np.concatenate([shared, rng.integers(0, 64, size=5)]),
        rng.integers(0, 64, size=7),
        np.concatenate([shared, rng.integers(0, 64, size=3)]),
        rng.integers(0, 64, size=12),
        shared.copy(),                     # exactly a cached prefix: COW
        rng.integers(0, 64, size=3),
        np.concatenate([shared[:PAGE], rng.integers(0, 64, size=9)]),
    ]


TRACE_MAX_NEW = [6, 3, 9, 1, 5, 8, 4]
TRACE_ARRIVALS = [0.0, 0.0, 3.0, 4.0, 7.0, 9.0, 9.0]


def _stream(tokens):
    return [int(t) for t in np.asarray(tokens).reshape(-1)]


def test_converter_keeps_key_paths_and_values(pair):
    jmodel, jparams, _, tparams = pair
    flat_j = jax.tree_util.tree_leaves_with_path(jax.device_get(jparams))
    assert len(flat_j) == sum(1 for _ in _leaves(tparams))
    for path, leaf in flat_j:
        node = tparams
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert tparams["peft"]["layers/wq"]["entries"].dtype == torch.int32


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_bf16_leaves_cross_exactly():
    a = jnp.asarray(np.random.default_rng(1).normal(size=(5, 7)),
                    jnp.bfloat16)
    t = from_jax_params({"w": jax.device_get(a)}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))


def test_merged_weights_match_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    jm, jp = jax_merge(jmodel, jparams)
    tm, tp = merge_for_serving(tmodel, tparams)
    assert tm.peft.method == jm.peft.method == "none"
    assert tp["peft"] == {} and not jp["peft"]
    for key in ("wq", "wk", "wv", "wo"):
        np.testing.assert_allclose(tp["base"]["layers"][key].numpy(),
                                   np.asarray(jp["base"]["layers"][key]),
                                   atol=2e-4)


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-4b", "qwen2.5-32b"])
def test_prefill_and_decode_step_match_jax(arch):
    """Forward logits over the prompt, prefill's next token, and one decode
    step's logits and token (vs the JAX forward over prompt + token)."""
    jmodel, jparams, tmodel, tparams = _pair(arch, seed=1)
    prompt = np.random.default_rng(2).integers(0, 64, size=(2, 9)).astype(
        np.int32)
    jlogits = np.asarray(jmodel.forward(jparams, {"tokens": jnp.asarray(
        prompt)})[0])
    tlogits = tmodel.forward(tparams, {"tokens": torch.from_numpy(prompt)})
    np.testing.assert_allclose(tlogits.numpy(), jlogits, atol=1e-4)

    jcache = jmodel.init_cache(2, 16, dtype=jnp.float32)
    jnext, jcache = jmodel.prefill(jparams, jcache,
                                   {"tokens": jnp.asarray(prompt)})
    tcache = tmodel.init_cache(2, 16, torch.float32, "cpu")
    tnext, tcache = tmodel.prefill(tparams, tcache,
                                   {"tokens": torch.from_numpy(prompt)})
    assert _stream(tnext) == _stream(jnext)

    jdec, _ = jmodel.decode_step(jparams, jcache,
                                 {"tokens": jnp.asarray(jnext)[:, None]})
    tlog, _ = tmodel.decode_logits(tparams, tcache, {"tokens": tnext[:, None]})
    full = np.concatenate([prompt, np.asarray(jnext)[:, None]], axis=1)
    jref = np.asarray(jmodel.forward(jparams, {"tokens": jnp.asarray(full)})[0])
    np.testing.assert_allclose(tlog[:, 0].numpy(), jref[:, -1], atol=1e-4)
    assert _stream(tlog[:, 0].argmax(-1)) == _stream(jdec)


def test_trainable_count_and_cross_entropy_match_jax(pair):
    from repro.models.common import cross_entropy as jax_cross_entropy
    from repro_torch.models.common import cross_entropy
    jmodel, _, tmodel, _ = pair
    assert tmodel.trainable_params() == jmodel.trainable_params() == 4 * N
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(2, 5)).astype(np.int32)
    mine = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                         z_loss=1e-4)
    theirs = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                               z_loss=1e-4)
    assert float(mine) == pytest.approx(float(theirs), rel=1e-6)


def test_per_slot_dense_decode_equals_lockstep(pair):
    """The per-slot dense-cache branch ((B,) positions, ragged kv_len)
    gives the lockstep branch's logits when every slot sits at the same
    position."""
    _, _, tmodel, tparams = pair
    model, params = merge_for_serving(tmodel, tparams)
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, 64, size=(3, 6)).astype(np.int32))
    outs = []
    for per_slot in (False, True):
        cache = model.init_cache(3, 16, torch.float32, "cpu",
                                 per_slot=per_slot)
        nxt, cache = model.prefill(params, cache, {"tokens": prompt})
        logits, cache = model.decode_logits(params, cache,
                                            {"tokens": nxt[:, None]})
        outs.append(logits)
    assert torch.is_tensor(cache["pos"]) and cache["pos"].tolist() == [7] * 3
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), atol=1e-6)


def test_engine_generate_matches_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    prompts = _prompts()[:3]
    jeng = JaxEngine(jmodel, jparams, batch_slots=3, max_len=MAX_LEN)
    teng = Engine(tmodel, tparams, batch_slots=3, max_len=MAX_LEN,
                  device="cpu")
    jouts = jeng.generate([jnp.asarray(p, jnp.int32) for p in prompts],
                          max_new=7)
    touts = teng.generate([torch.from_numpy(p.astype(np.int32))
                           for p in prompts], max_new=7)
    assert [_stream(t) for t in touts] == [_stream(j) for j in jouts]


@pytest.mark.parametrize("eos_id", [None, 6])
def test_continuous_paged_streams_match_jax(pair, eos_id):
    """Port continuous (paged) == JAX continuous (paged) == JAX serial."""
    jmodel, jparams, tmodel, tparams = pair
    prompts = _prompts()
    jeng = JaxEngine(jmodel, jparams, batch_slots=3, max_len=MAX_LEN)
    teng = Engine(tmodel, tparams, batch_slots=3, max_len=MAX_LEN,
                  device="cpu")
    jreqs = [JaxRequest(prompt=jnp.asarray(p, jnp.int32), max_new=m)
             for p, m in zip(prompts, TRACE_MAX_NEW)]
    treqs = [Request(prompt=torch.from_numpy(p.astype(np.int32)), max_new=m)
             for p, m in zip(prompts, TRACE_MAX_NEW)]
    jsched = JaxScheduler(jeng, eos_id=eos_id, page_size=PAGE)
    tsched = ContinuousScheduler(teng, eos_id=eos_id, page_size=PAGE)
    clones = []
    copy_page = tsched.model.copy_page
    tsched.model.copy_page = lambda c, src, dst: (
        clones.append((src, dst)), copy_page(c, src, dst))[1]
    jsched.serve(jreqs, TRACE_ARRIVALS)
    tsched.serve(treqs, TRACE_ARRIVALS)
    ported = [r.out for r in treqs]
    assert ported == [r.out for r in jreqs]
    if eos_id is None:
        serial = [_stream(jeng.generate([r.prompt], max_new=r.max_new)[0])
                  for r in jreqs]
        assert ported == serial
        assert [len(o) for o in ported] == TRACE_MAX_NEW
    else:
        assert any(len(o) < m for o, m in zip(ported, TRACE_MAX_NEW))
    # the exact-prefix prompt reused the cached pages through a COW clone
    assert len(clones) == 1
    tsched.pager.assert_no_leaks()
    assert tsched.metrics.summary()["n_requests"] == len(prompts)


def test_launcher_runs_on_cpu(capsys):
    launch_serve.main(["--arch", "yi-6b", "--reduced", "--continuous",
                       "--device", "cpu", "--trace-n", "4", "--n", "64"])
    out = capsys.readouterr().out
    assert "continuous: 4 requests" in out
    assert "-> einsum" in out
