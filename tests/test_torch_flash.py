"""Long-sequence attention in the port against the JAX package, on the CPU.

`flash_attention` (the recomputing backward), `chunked_attention`,
`_tri_pairs` and `attention`'s switch, held against `repro.models.attention`
on the same seeded numpy inputs at the JAX suite's tolerances
(tests/test_flash_attention.py, tests/test_models.py::TestAttention):
forward f32 atol 3e-6, bf16 atol 3e-2, gradients atol 5e-5, chunked atol
2e-5; bf16 gradients per tensor against their own size; and a reduced model's loss and coefficient gradients at S 1536, where
both packages' training forward goes through flash."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.configs.base import PEFTConfig as JaxPEFT
from repro.models import attention as jattn
from repro.models import build as jax_build
from repro.train import step as jax_step
from repro_torch import configs
from repro_torch.configs.base import PEFTConfig
from repro_torch.convert import from_jax_params
from repro_torch.models import attention as tattn
from repro_torch.models import build
from repro_torch.train import step as ts


def _qkv(B=2, S=512, H=4, K=2, dh=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, dh), dtype=np.float32),
            rng.standard_normal((B, S, K, dh), dtype=np.float32),
            rng.standard_normal((B, S, K, dh), dtype=np.float32))


def _j(*xs, dtype=jnp.float32):
    return [jnp.asarray(x).astype(dtype) for x in xs]


def _t(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


@pytest.mark.parametrize("nq", [1, 2, 5, 8])
def test_tri_pairs_cover_causal_blocks_exactly_once(nq):
    iqs, jks = tattn._tri_pairs(nq)
    order = list(zip(iqs.tolist(), jks.tolist()))
    assert len(set(order)) == nq * (nq + 1) // 2 == len(order)
    assert all(j <= i for i, j in order)
    assert order == sorted(order)
    jiq, jjk = jattn._tri_pairs(nq)
    assert order == list(zip(np.asarray(jiq).tolist(),
                             np.asarray(jjk).tolist()))


@pytest.mark.parametrize("K", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_matches_jax(causal, chunk, K):
    q, k, v = _qkv(K=K)
    ref = np.asarray(jattn.flash_attention(*_j(q, k, v), causal, chunk))
    out = tattn.flash_attention(*_t(q, k, v), causal, chunk)
    assert out.shape == q.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-6)
    direct = tattn.direct_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), direct.numpy(), atol=3e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_matches_jax(causal):
    q, k, v = _qkv()
    ref = jattn.flash_attention(*_j(q, k, v, dtype=jnp.bfloat16), causal,
                                128)
    out = tattn.flash_attention(*_t(q, k, v, dtype=torch.bfloat16), causal,
                                128)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=3e-2)


@pytest.mark.parametrize("K", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_gradients_match_jax(causal, K):
    """The recomputing backward against JAX's custom VJP and against the
    port's direct path under autograd, for the loss the JAX suite uses."""
    q, k, v = _qkv(K=K)
    tgt = np.random.default_rng(9).standard_normal(q.shape,
                                                   dtype=np.float32)

    def jloss(q, k, v):
        return jnp.sum((jattn.flash_attention(q, k, v, causal, 128)
                        - tgt) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*_j(q, k, v))

    def tgrads(fn):
        xs = [x.requires_grad_(True) for x in _t(q, k, v)]
        loss = torch.sum((fn(*xs) - torch.from_numpy(tgt)) ** 2)
        return torch.autograd.grad(loss, xs)

    flash = tgrads(lambda q, k, v: tattn.flash_attention(q, k, v, causal,
                                                         128))
    direct = tgrads(lambda q, k, v: tattn.direct_attention(q, k, v,
                                                           causal=causal))
    for a, b, d, name in zip(flash, jg, direct, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5,
                                   err_msg=f"d{name} vs JAX")
        np.testing.assert_allclose(a.numpy(), d.numpy(), atol=5e-5,
                                   err_msg=f"d{name} vs direct")


def _rel(a, b):
    """(max |a - b| / max |b|, ||a - b|| / ||b||) in float64."""
    a, b = a.double(), b.double()
    return (float((a - b).abs().max() / b.abs().max()),
            float((a - b).norm() / b.norm()))


@pytest.mark.parametrize("K", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_gradients_match_jax(causal, K):
    """bf16 gradients, each tensor against its own size: against JAX's
    custom VJP on the same bf16 inputs and cotangent (the two differ by f32
    ordering before the bf16 cast: ||diff|| / ||g|| <= 5e-4, max |diff| /
    max |g| <= 5e-3), and against float64 direct attention on them at the
    limits chip_smoke's phase 18a holds on the card (2.5e-3 and 2e-2; the
    sound reading is about 1.8e-3 in norm, bf16 rounding of the outputs and
    of `out` before D, and the same gradients against the f32 problem
    before the inputs' rounding read 3e-3 to 4e-3)."""
    q, k, v = _qkv(K=K)
    cot = np.random.default_rng(9).standard_normal(q.shape,
                                                   dtype=np.float32)

    def jloss(q, k, v):
        return jnp.sum(jattn.flash_attention(q, k, v, causal, 128)
                       .astype(jnp.float32) * cot)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*_j(q, k, v, dtype=jnp.bfloat16))

    def tgrads(fn, dtype):
        xs = [x.to(dtype).requires_grad_(True)
              for x in _t(q, k, v, dtype=torch.bfloat16)]
        c = torch.from_numpy(cot).to(torch.bfloat16).to(dtype)
        return torch.autograd.grad((fn(*xs).to(dtype) * c).sum(), xs)

    flash = tgrads(lambda q, k, v: tattn.flash_attention(q, k, v, causal,
                                                         128),
                   torch.bfloat16)
    exact = tgrads(lambda q, k, v: tattn.direct_attention(q, k, v,
                                                          causal=causal),
                   torch.float64)
    for a, b, e, name in zip(flash, jg, exact, "qkv"):
        assert a.dtype == torch.bfloat16
        vs_jax = _rel(a, torch.from_numpy(np.asarray(b, np.float32)))
        vs_exact = _rel(a, e)
        assert vs_jax[0] <= 5e-3 and vs_jax[1] <= 5e-4, (name, vs_jax)
        assert vs_exact[0] <= 2e-2 and vs_exact[1] <= 2.5e-3, (name,
                                                               vs_exact)


def test_flash_bf16_gradients_have_input_dtypes():
    q, k, v = _t(*_qkv(S=256), dtype=torch.bfloat16)
    xs = [x.requires_grad_(True) for x in (q, k, v)]
    grads = torch.autograd.grad(
        tattn.flash_attention(*xs, True, 64).float().sum(), xs)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert all(torch.isfinite(g.float()).all() for g in grads)


def test_flash_gradients_are_causal():
    """dk/dv past the first q block get nothing from it."""
    q, k, v = _t(*_qkv(B=1, S=256, H=2, K=2))
    k.requires_grad_(True)
    v.requires_grad_(True)
    out = tattn.flash_attention(q, k, v, True, 64)
    dk, dv = torch.autograd.grad(torch.sum(out[:, :64] ** 2), (k, v))
    assert float(dk[:, 64:].abs().max()) == 0.0
    assert float(dv[:, 64:].abs().max()) == 0.0


def test_flash_rejects_a_ragged_length():
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tattn.flash_attention(*_t(*_qkv(S=200)), True, 64)


@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_matches_jax_and_direct(causal, chunk):
    q, k, v = _qkv(S=1024, H=8, K=2, dh=32)
    ref = np.asarray(jattn.chunked_attention(*_j(q, k, v), causal=causal,
                                             chunk_q=chunk))
    out = tattn.chunked_attention(*_t(q, k, v), causal=causal,
                                  chunk_q=chunk)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)
    direct = tattn.direct_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), direct.numpy(), atol=2e-5)


def test_chunked_is_causal_and_falls_back_to_direct():
    q, k, v = _t(*_qkv(B=1, S=256, H=2, K=2))
    o1 = tattn.chunked_attention(q, k, v, chunk_q=64)
    k2, v2 = k.clone(), v.clone()
    k2[:, 200:] = 7.0
    v2[:, 200:] = -3.0
    o2 = tattn.chunked_attention(q, k2, v2, chunk_q=64)
    np.testing.assert_allclose(o1[:, :200].numpy(), o2[:, :200].numpy(),
                               atol=1e-5)
    q, k, v = _t(*_qkv(S=200))
    assert torch.equal(tattn.chunked_attention(q, k, v, chunk_q=64),
                       tattn.direct_attention(q, k, v))
    with pytest.raises(ValueError, match="equal chunks"):
        tattn.chunked_attention(q, k, v, chunk_q=64, chunk_kv=32)


def _record(monkeypatch, mod, names, seen):
    for name in names:
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            seen.append(_name)
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)


BRANCHES = ("direct_attention", "flash_attention", "chunked_attention")


@pytest.mark.parametrize("S,branch", [
    (1024, ["direct_attention"]),
    (1536, ["flash_attention"]),
    (1100, ["chunked_attention", "direct_attention"]),
])
def test_attention_switch_takes_the_reference_branch(monkeypatch, S, branch):
    """Direct up to 1024 rows, flash when S % 512 == 0, else chunked (which
    falls back to direct for such S), in both packages, at narrow widths
    (H 4, dh 16); the outputs agree at the branch's tolerance."""
    q, k, v = _qkv(B=1, S=S, H=4, K=2, dh=16)
    jseen, tseen = [], []
    _record(monkeypatch, jattn, BRANCHES, jseen)
    _record(monkeypatch, tattn, BRANCHES, tseen)
    ref = np.asarray(jattn.attention(*_j(q, k, v), causal=True))
    out = tattn.attention(*_t(q, k, v), causal=True)
    assert jseen == branch and tseen == branch
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-6)


def test_training_at_1536_goes_through_flash_and_matches_jax(monkeypatch):
    """A reduced yi-6b's loss and FourierFT coefficient gradients at
    S 1536 (flash in both packages' training forward) at atol 1e-5, the
    tolerance of tests/test_torch_train.py."""
    kw = dict(vocab=64, param_dtype="float32", dtype="float32")
    jcfg = jax_configs.reduced(jax_configs.get("yi-6b")).replace(**kw)
    tcfg = configs.reduced(configs.get("yi-6b")).replace(**kw)
    jmodel = jax_build(jcfg, JaxPEFT(n=32, alpha=10.0))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build(tcfg, PEFTConfig(n=32, alpha=10.0))
    tparams = from_jax_params(jax.device_get(jparams), "cpu")
    toks = np.random.default_rng(1).integers(
        0, 64, size=(1, 1537)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jtr, jfr = jax_step.split_params(jmodel, jparams)
    jloss, jgrads = jax.value_and_grad(
        lambda tr: jmodel.loss_from_parts(
            tr, jfr["base"], jfr["peft"],
            {k_: jnp.asarray(v_) for k_, v_ in batch.items()}))(jtr)
    seen = []
    _record(monkeypatch, tattn, BRANCHES, seen)
    trainable, frozen = ts.split_params(tmodel, tparams)
    tloss, tgrads = ts._value_and_grad(
        ts._loss_for(tmodel), trainable, frozen,
        {k_: torch.from_numpy(v_) for k_, v_ in batch.items()})
    assert seen == ["flash_attention"] * tcfg.num_layers
    assert float(tloss) == pytest.approx(float(jloss), abs=1e-5)
    for site in ("layers/wq", "layers/wv"):
        np.testing.assert_allclose(tgrads["peft"][site]["c"].numpy(),
                                   np.asarray(jgrads["peft"][site]["c"]),
                                   atol=1e-5)
