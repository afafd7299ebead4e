"""The port's factored forms against the JAX package: every method's
`factored_apply` and `bank_apply` (fourierft, dct, circulant, lora,
bitfit), circulant's `torch.fft` apply, the frozen tables built once, the
registry's resolution of the new ops, and the factored strategy through
the model.

Inputs are seeded numpy arrays given to both packages. Tolerances are the
JAX suite's: the ops against JAX's at atol 2e-5 / rtol 1e-4
(tests/test_kernel_registry.py); factored against x @ ΔW at atol 1e-6 /
rtol 5e-4 (tests/test_adapter_api.py); logits at atol 1e-5 / rtol 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.configs.base import PEFTConfig as JaxPEFT
from repro.core import adapter as jax_adapter
from repro.core import peft as jax_peft
from repro.kernels import ops as jax_ops
from repro.models import build as jax_build
from repro.serve import Engine as JaxEngine
from repro_torch import configs
from repro_torch.configs.base import PEFTConfig
from repro_torch.convert import from_jax_params
from repro_torch.core import adapter as adapter_api
from repro_torch.core import peft as peft_mod
from repro_torch.core.adapter import AdapterSite
from repro_torch.kernels import api
from repro_torch.kernels import ops as kops
from repro_torch.models import build
from repro_torch.serve import Engine

METHODS = ("fourierft", "dct", "circulant", "lora", "bitfit")
# a tall, a wide and a square site (circulant pads x when d2 > d1)
SITES = (AdapterSite("layers/wq", 48, 32, 3),
         AdapterSite("layers/wv", 32, 48, 2),
         AdapterSite("layers/wo", 40, 40, 1))


def _peft_kw(method):
    return dict(method=method, n=12, alpha=20.0, lora_r=2,
                param_dtype="float32")


def _site_inputs(method, site, seed=0):
    """(port adapter dict, jax adapter dict, port peft, jax peft): the
    frozen leaves from the port's init_site (the entries are numpy's draw
    in both packages), every trainable leaf seeded numpy noise."""
    peft = PEFTConfig(**_peft_kw(method))
    m = adapter_api.resolve(method)
    gen = torch.Generator()
    gen.manual_seed(0)
    ad = m.init_site(gen, site, peft, "cpu")
    rng = np.random.default_rng(seed)
    for leaf in m.trainable_leaves(peft):
        ad[leaf] = torch.from_numpy(
            rng.normal(size=tuple(ad[leaf].shape)).astype(np.float32))
    jad = {k: jnp.asarray(v.numpy()) for k, v in ad.items()}
    return ad, jad, peft, JaxPEFT(**_peft_kw(method))


def _split(method, ad, peft):
    names = set(adapter_api.resolve(method).trainable_leaves(peft))
    return ({k: v for k, v in ad.items() if k in names},
            {k: v for k, v in ad.items() if k not in names})


def _x(shape, seed=7):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(a, b, atol, rtol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("site", SITES, ids=lambda s: f"{s.d_in}x{s.d_out}")
@pytest.mark.parametrize("method", METHODS)
def test_factored_apply_matches_jax(method, site):
    ad, jad, peft, jpeft = _site_inputs(method, site)
    tr, aux = _split(method, {k: v[0] if k not in ("entries",) else v
                              for k, v in ad.items()}, peft)
    jtr, jaux = _split(method, {k: v[0] if k not in ("entries",) else v
                                for k, v in jad.items()}, peft)
    x = _x((5, site.d_in))
    y = adapter_api.resolve(method).factored_apply(
        torch.from_numpy(x), tr, aux, site.d_in, site.d_out, peft)
    jy = jax_adapter.resolve(method).factored_apply(
        jnp.asarray(x), jtr, jaux, site.d_in, site.d_out, jpeft)
    assert y.dtype == torch.float32 and tuple(y.shape) == (5, site.d_out)
    _close(y.numpy(), jy, 2e-5, 1e-4)


@pytest.mark.parametrize("site", SITES, ids=lambda s: f"{s.d_in}x{s.d_out}")
@pytest.mark.parametrize("method", METHODS)
def test_bank_apply_matches_jax(method, site):
    """Row-batched: row b of x meets row b of every trainable leaf (here
    the site's layers stand in for three tenants' rows)."""
    ad, jad, peft, jpeft = _site_inputs(method, site)
    tr, aux = _split(method, ad, peft)
    jtr, jaux = _split(method, jad, peft)
    B = site.stack
    x = _x((B, 4, site.d_in))
    y = adapter_api.resolve(method).bank_apply(
        torch.from_numpy(x), tr, aux, site.d_in, site.d_out, peft)
    jy = jax_adapter.resolve(method).bank_apply(
        jnp.asarray(x), jtr, jaux, site.d_in, site.d_out, jpeft)
    assert tuple(y.shape) == (B, 4, site.d_out)
    _close(y.numpy(), jy, 2e-5, 1e-4)


@pytest.mark.parametrize("method", METHODS)
def test_factored_equals_x_at_delta(method):
    """factored_apply == x @ site_delta for the linear-delta methods;
    BitFit's bias shift is its broadcast delta_b (it has no ΔW)."""
    site = SITES[0]
    ad, _, peft, _ = _site_inputs(method, site)
    m = adapter_api.resolve(method)
    tr, aux = _split(method, ad, peft)
    x = torch.from_numpy(_x((5, site.d_in)))
    y = m.factored_apply(x, {k: v[0] for k, v in tr.items()}, aux,
                         site.d_in, site.d_out, peft)
    if m.linear_delta:
        one = AdapterSite(site.name, site.d_in, site.d_out, 1)
        dw = m.site_delta({**{k: v[:1] for k, v in tr.items()}, **aux}, one,
                          peft)[0]
        _close(y.numpy(), (x @ dw).numpy(), 1e-6, 5e-4)
    else:
        with pytest.raises(NotImplementedError):
            m.site_delta(ad, site, peft)
        assert torch.equal(y, tr["delta_b"][0].expand(5, site.d_out))


@pytest.mark.parametrize("method", METHODS)
def test_bank_rows_match_per_row_factored_and_zero_row_is_zero(method):
    site = SITES[0]
    ad, _, peft, _ = _site_inputs(method, site)
    m = adapter_api.resolve(method)
    tr, aux = _split(method, ad, peft)
    x = torch.from_numpy(_x((site.stack, 4, site.d_in)))
    y = m.bank_apply(x, tr, aux, site.d_in, site.d_out, peft)
    for b in range(site.stack):
        yb = m.factored_apply(x[b], {k: v[b] for k, v in tr.items()}, aux,
                              site.d_in, site.d_out, peft)
        _close(y[b].numpy(), yb.numpy(), 2e-5, 1e-5)
    zero = {k: torch.zeros_like(v) for k, v in tr.items()}
    assert not m.bank_apply(x, zero, aux, site.d_in, site.d_out,
                            peft).any()


def test_per_row_fallback_for_a_method_without_bank_op():
    """The base class runs factored_apply row by row when a method
    registers no bank op (the JAX package vmaps it)."""
    class RowOnly(adapter_api.AdapterMethod):
        name = "row-only-test"

        def trainable_leaves(self, peft):
            return ("g",)

        def kernel_ops(self):
            return (api.KernelOp("factored_apply", self.name, "einsum",
                                 lambda x, tr, aux, d1, d2, peft:
                                 x * tr["g"]),)

    m = RowOnly()
    x = torch.from_numpy(_x((3, 4, 6)))
    g = torch.from_numpy(_x((3, 6), seed=3))
    y = m.bank_apply(x, {"g": g}, {}, 6, 6, None)
    assert torch.equal(y, x * g[:, None, :])


@pytest.mark.parametrize("d1,d2", [(48, 32), (32, 48), (40, 40)])
def test_circulant_fft_matches_jax(d1, d2):
    """The `torch.fft` apply (the circulant method's cuda-key op) against
    JAX's circulant_apply_fft and the einsum gather; a zero kernel gives
    exactly zero."""
    m = max(d1, d2)
    x = _x((3, 4, d1))
    g = np.random.default_rng(1).normal(size=(3, 1, m)).astype(np.float32)
    y = kops.circulant_apply_fft(torch.from_numpy(x), torch.from_numpy(g),
                                 d1, d2, 20.0)
    jy = jax_ops.circulant_apply_fft(jnp.asarray(x), jnp.asarray(g), d1, d2,
                                     20.0)
    _close(y.numpy(), jy, 2e-5, 1e-4)
    peft = PEFTConfig(**_peft_kw("circulant"))
    op = api.resolve_op("bank_apply", "circulant", peft, d1, d2,
                        device="cuda")
    assert op.backend == "cuda" and "torch.fft" in op.note \
        and "not a hand-written kernel" in op.note
    tr = {"kernel": torch.from_numpy(g[:, 0])}
    yo = op.fn(torch.from_numpy(x), tr, {}, d1, d2, peft)
    ye = api.resolve_op("bank_apply", "circulant", peft, d1, d2,
                        device="cpu").fn(torch.from_numpy(x), tr, {}, d1,
                                         d2, peft)
    _close(yo.numpy(), ye.numpy(), 2e-5, 1e-4)
    zero = op.fn(torch.from_numpy(x), {"kernel": torch.zeros(3, m)}, {}, d1,
                 d2, peft)
    assert not zero.any()


@pytest.mark.parametrize("method", ["fourierft", "dct"])
def test_frozen_tables_give_the_same_numbers(method):
    """The tables built once (what the bank and factored engines keep)
    give bitwise the numbers the ops build for themselves."""
    site = SITES[0]
    ad, _, peft, _ = _site_inputs(method, site)
    m = adapter_api.resolve(method)
    tr, aux = _split(method, ad, peft)
    tables = m.frozen_tables(aux, site.d_in, site.d_out)
    assert tables and all(t.dtype == torch.float32 for t in tables.values())
    x = torch.from_numpy(_x((site.stack, 2, site.d_in)))
    for fn in (m.bank_apply,):
        assert torch.equal(fn(x, tr, aux, site.d_in, site.d_out, peft),
                           fn(x, tr, {**aux, **tables}, site.d_in,
                              site.d_out, peft))
    one = {k: v[0] for k, v in tr.items()}
    assert torch.equal(
        m.factored_apply(x[0], one, aux, site.d_in, site.d_out, peft),
        m.factored_apply(x[0], one, {**aux, **tables}, site.d_in,
                         site.d_out, peft))
    with_t = peft_mod.with_frozen_tables({site.name: ad}, SITES, peft)
    assert set(with_t[site.name]) == set(ad) | set(tables)


def test_einsum_only_ops_resolve_to_einsum_on_cuda():
    """An op registered only as `einsum` resolves to it for CUDA tensors
    too (its only implementation, as in JAX); the bank groups' ops join
    the model's kernel policy."""
    for method in ("fourierft", "dct", "lora", "bitfit"):
        peft = PEFTConfig(**_peft_kw(method))
        for op in ("factored_apply", "bank_apply"):
            assert api.resolve_op(op, method, peft, 4096, 4096,
                                  device="cuda").backend == "einsum"
    cfg = configs.reduced(configs.get("yi-6b"))
    profiles = {m: PEFTConfig(**_peft_kw(m)) for m in METHODS}
    policy = build(cfg, PEFTConfig(method="none"), ).kernel_policy("cpu")
    assert policy.resolutions == ()
    import dataclasses
    bmodel = dataclasses.replace(build(cfg, PEFTConfig(method="none")),
                                 bank_profiles=profiles)
    pol = bmodel.kernel_policy("cuda").validate()
    assert {(r.bank, r.site) for r in pol.resolutions} == {
        (m, s) for m in METHODS for s in ("layers/wq", "layers/wv")}
    assert pol.backend_for("layers/wq", "bank_apply", bank="circulant") \
        == "cuda"
    assert pol.backend_for("layers/wv", "bank_apply", bank="lora") \
        == "einsum"
    assert "[bank dct]" in pol.explain()


@pytest.mark.parametrize("method", METHODS)
def test_counts_and_init_shapes_match_jax(method):
    cfg = configs.reduced(configs.get("yi-6b"))
    jcfg = jax_configs.reduced(jax_configs.get("yi-6b"))
    model = build(cfg, PEFTConfig(**_peft_kw(method)))
    jmodel = jax_build(jcfg, JaxPEFT(**_peft_kw(method)))
    assert model.trainable_params() == peft_mod.count_trainable(
        model.sites, model.peft) == jax_peft.count_trainable(
            jmodel.sites, jmodel.peft)
    gen = torch.Generator()
    gen.manual_seed(0)
    tree = peft_mod.init_adapters(gen, model.sites, model.peft, "cpu")
    jtree = jax.device_get(jax_peft.init_adapters(jax.random.PRNGKey(0),
                                                  jmodel.sites, jmodel.peft))
    assert set(tree) == set(jtree)
    for site in tree:
        assert {k: tuple(v.shape) for k, v in tree[site].items()} == \
            {k: tuple(v.shape) for k, v in jtree[site].items()}


def _cfgs():
    kw = dict(vocab=64, param_dtype="float32", dtype="float32")
    return (jax_configs.reduced(jax_configs.get("yi-6b")).replace(**kw),
            configs.reduced(configs.get("yi-6b")).replace(**kw))


def _noised(jparams, seed):
    """JAX params with every adapter leaf moved by seeded noise, so zero-
    initialised methods (circulant, bitfit, LoRA's B) do something."""
    rng = np.random.default_rng(seed)
    params = jax.device_get(jparams)
    for site, ad in params["peft"].items():
        for leaf, v in ad.items():
            if np.issubdtype(v.dtype, np.floating):
                ad[leaf] = (v + 0.5 * rng.normal(size=v.shape)).astype(
                    v.dtype)
    return params


@pytest.mark.parametrize("method", METHODS)
def test_factored_strategy_logits_match_jax(method):
    """The whole model with strategy="factored": the port's logits against
    JAX's on the same params and tokens."""
    jcfg, tcfg = _cfgs()
    kw = {**_peft_kw(method), "strategy": "factored"}
    jmodel = jax_build(jcfg, JaxPEFT(**kw))
    params = _noised(jmodel.init(jax.random.PRNGKey(0)), 1)
    tmodel = build(tcfg, PEFTConfig(**kw))
    toks = np.random.default_rng(2).integers(0, 64, size=(2, 9)).astype(
        np.int32)
    jl, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks)})
    tl = tmodel.forward(from_jax_params(params, "cpu"),
                        {"tokens": torch.from_numpy(toks)})
    _close(tl.numpy(), jl, 1e-5, 1e-4)


@pytest.mark.parametrize("method", ["fourierft", "lora", "bitfit"])
def test_unmerged_engine_streams_match_jax(method):
    """Engine(merge=False) over a factored adapter keeps it factored (its
    tables built once) and decodes JAX's tokens."""
    jcfg, tcfg = _cfgs()
    kw = {**_peft_kw(method), "strategy": "factored"}
    jmodel = jax_build(jcfg, JaxPEFT(**kw))
    params = _noised(jmodel.init(jax.random.PRNGKey(0)), 3)
    prompts = [np.array([1, 2, 3, 4], np.int32), np.array([5, 6, 7], np.int32)]
    jouts = JaxEngine(jmodel, params, batch_slots=2, max_len=24,
                      merge=False).generate([jnp.asarray(p) for p in prompts],
                                            max_new=5)
    eng = Engine(build(tcfg, PEFTConfig(**kw)), from_jax_params(params, "cpu"),
                 batch_slots=2, max_len=24, merge=False, device="cpu")
    if method == "fourierft":
        assert "cos_t" in eng.params["peft"]["layers/wq"]
    outs = eng.generate([torch.from_numpy(p) for p in prompts], max_new=5)
    assert [o.tolist() for o in outs] == \
        [np.asarray(o).tolist() for o in jouts]


def test_bitfit_merge_adds_to_the_bias():
    """BitFit merges into (or creates) the site's `__b` bias: the merged
    model's logits equal the factored model's."""
    _, tcfg = _cfgs()
    kw = _peft_kw("bitfit")
    jmodel = jax_build(_cfgs()[0], JaxPEFT(**kw))
    params = from_jax_params(_noised(jmodel.init(jax.random.PRNGKey(0)), 4),
                             "cpu")
    toks = torch.tensor([[1, 2, 3, 4, 5]], dtype=torch.int32)
    merged = build(tcfg, PEFTConfig(**kw)).forward(params, {"tokens": toks})
    fact = build(tcfg, PEFTConfig(**kw, strategy="factored")).forward(
        params, {"tokens": toks})
    _close(merged.numpy(), fact.numpy(), 1e-5, 1e-4)
