"""The Table-6 random and orthogonal bases in the port against the JAX
package, on the CPU.

The bases are never stored: both packages regenerate them from the entry
seed, so the port reproduces JAX's draw (`core/prng.py`, threefry2x32 in
numpy): the keys and raw bits exactly, the normals and the bases after QR
within 1e-5. Then the basis math (ΔW, the factored and bank applies,
`site_delta`) at the JAX suite's registry tolerance, atol 2e-5 / rtol 1e-4
(tests/test_kernel_registry.py); the route a CUDA basis site resolves to,
by resolution alone; `shared_storage_numbers` per method; adapters that
cross between the packages; and the merged model's forward and gradient
with a basis adapter (atol 1e-5)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.checkpoint import adapters as jax_adapters
from repro.configs.base import PEFTConfig as JaxPEFT
from repro.core import adapter as jax_adapter
from repro.core import basis as jax_basis
from repro.core import peft as jax_peft
from repro.models import build as jax_build
from repro.train import step as jax_step
from repro_torch import configs
from repro_torch.checkpoint import adapters
from repro_torch.configs.base import PEFTConfig
from repro_torch.convert import from_jax_params
from repro_torch.core import adapter as adapter_api
from repro_torch.core import basis, prng
from repro_torch.core import peft as peft_mod
from repro_torch.core.adapter import AdapterSite
from repro_torch.kernels import api
from repro_torch.models import build
from repro_torch.serve import AdapterBank
from repro_torch.train import step as ts

KINDS = ("random", "orthogonal")
SITES = (AdapterSite("layers/wq", 48, 32, 3),
         AdapterSite("layers/wv", 32, 48, 2),
         AdapterSite("layers/wo", 40, 40, 1))
N, ALPHA = 12, 20.0


def _close(a, b, atol=2e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


# ---------------------------------------------------------------------------
# The draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 2024, 7, 2 ** 31 - 1])
def test_keys_fold_in_and_split_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.prng_key(seed), np.asarray(key))
    for data in (0, 1, 768 * 131071 + 768, 4096 * 131071 + 4096, 2 ** 32 - 1):
        jf = jax.random.fold_in(key, data)
        mine = prng.fold_in(prng.prng_key(seed), data)
        np.testing.assert_array_equal(mine, np.asarray(jf))
        for num in (2, 3):
            np.testing.assert_array_equal(prng.split(mine, num),
                                          np.asarray(jax.random.split(jf,
                                                                      num)))


@pytest.mark.parametrize("shape", [(1,), (7,), (37, 11), (4, 5, 6),
                                   (768, 100)])
def test_raw_bits_equal_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 99)
    bits = jax.random.bits(key, shape, jnp.uint32)
    np.testing.assert_array_equal(prng.random_bits(np.asarray(key), shape),
                                  np.asarray(bits))
    np.testing.assert_array_equal(prng.uniform(np.asarray(key), shape),
                                  np.asarray(jax.random.uniform(key, shape)))


@pytest.mark.parametrize("shape", [(300, 64), (64, 1000)])
def test_normals_match_jax(shape):
    key = jax.random.split(jax.random.PRNGKey(2024))[1]
    mine = prng.normal(np.asarray(key), shape)
    theirs = np.asarray(jax.random.normal(key, shape))
    assert mine.dtype == np.float32
    np.testing.assert_allclose(mine, theirs, atol=1e-5, rtol=0)
    assert np.mean(mine == theirs) > 0.9         # mostly bit for bit


@pytest.mark.parametrize("d1,d2,n", [(48, 32, 12), (64, 64, 64),
                                     (96, 40, 40), (768, 768, 300)])
@pytest.mark.parametrize("kind", KINDS)
def test_site_bases_match_jax(kind, d1, d2, n):
    """The bases a (d1, d2) site gets, as JAX's FourierFT.init_site keys
    them, after QR for the orthogonal kind (sign convention included)."""
    jkey = jax.random.fold_in(jax.random.PRNGKey(2024), d1 * 131071 + d2)
    j1, j2 = jax_basis.make_basis(jkey, kind, d1, d2, n)
    b1, b2 = basis.site_basis(2024, kind, d1, d2, n)
    assert b1.shape == (d1, n) and b2.shape == (d2, n)
    np.testing.assert_allclose(b1, np.asarray(j1), atol=1e-5, rtol=0)
    np.testing.assert_allclose(b2, np.asarray(j2), atol=1e-5, rtol=0)
    if kind == "orthogonal":
        np.testing.assert_allclose(b1.T @ b1, np.eye(n), atol=1e-5)


def test_orthogonal_needs_n_at_most_min_dim():
    with pytest.raises(ValueError, match="orthogonal"):
        basis.make_basis(prng.prng_key(0), "orthogonal", 16, 8, 9)
    site = AdapterSite("layers/wq", 16, 8, 1)
    with pytest.raises(ValueError, match="n <= min"):
        adapter_api.resolve("fourierft").init_site(
            torch.Generator(), site, PEFTConfig(basis="orthogonal", n=9),
            "cpu")
    with pytest.raises(ValueError, match="unknown basis"):
        basis.make_basis(prng.prng_key(0), "hadamard", 16, 8, 4)


# ---------------------------------------------------------------------------
# The basis math
# ---------------------------------------------------------------------------

def _site_inputs(kind, site, seed=0):
    """(port adapter, jax adapter, port peft, jax peft): the port's
    init_site (bases drawn as JAX draws them), c seeded numpy noise."""
    kw = dict(method="fourierft", n=N, alpha=ALPHA, basis=kind,
              param_dtype="float32")
    peft = PEFTConfig(**kw)
    gen = torch.Generator()
    gen.manual_seed(0)
    ad = adapter_api.resolve("fourierft").init_site(gen, site, peft, "cpu")
    assert set(ad) == {"c", "b1", "b2"}
    ad["c"] = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(site.stack, N)).astype(np.float32))
    jad = {k: jnp.asarray(v.numpy()) for k, v in ad.items()}
    return ad, jad, peft, JaxPEFT(**kw)


@pytest.mark.parametrize("site", SITES, ids=lambda s: f"{s.d_in}x{s.d_out}")
@pytest.mark.parametrize("kind", KINDS)
def test_init_site_bases_equal_jax_init(kind, site):
    kw = dict(method="fourierft", n=N, basis=kind)
    jad = jax_adapter.resolve("fourierft").init_site(
        jax.random.PRNGKey(0), site, JaxPEFT(**kw))
    ad = adapter_api.resolve("fourierft").init_site(
        torch.Generator(), site, PEFTConfig(**kw), "cpu")
    for leaf in ("b1", "b2"):
        assert ad[leaf].dtype == torch.float32
        np.testing.assert_allclose(ad[leaf].numpy(), np.asarray(jad[leaf]),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("site", SITES, ids=lambda s: f"{s.d_in}x{s.d_out}")
@pytest.mark.parametrize("kind", KINDS)
def test_materialize_and_site_delta_match_jax(kind, site):
    ad, jad, peft, jpeft = _site_inputs(kind, site)
    dw = basis.materialize_delta_basis(ad["c"], ad["b1"], ad["b2"], kind,
                                       ALPHA)
    jdw = jax_basis.materialize_delta_basis(jad["c"], jad["b1"], jad["b2"],
                                            kind, ALPHA)
    assert tuple(dw.shape) == (site.stack, site.d_in, site.d_out)
    _close(dw.numpy(), jdw)
    one = basis.materialize_delta_basis(ad["c"][0], ad["b1"], ad["b2"],
                                        kind, ALPHA)
    _close(one.numpy(), np.asarray(jdw)[0])
    sd = peft_mod.site_delta(ad, site, peft)
    jsd = jax_peft.site_delta(jad, site, jpeft, jnp.float32)
    _close(sd.numpy(), jsd)
    # the CUDA route's product (run here on CPU tensors) is the same ΔW
    op = api.resolve_op("deltaw", "fourierft", peft, site.d_in, site.d_out,
                        device="cuda")
    tr, aux = adapter_api.resolve("fourierft").split_adapter(ad, peft)
    _close(op.fn(tr, aux, site.d_in, site.d_out, peft).numpy(), jsd)


@pytest.mark.parametrize("site", SITES, ids=lambda s: f"{s.d_in}x{s.d_out}")
@pytest.mark.parametrize("kind", KINDS)
def test_factored_and_bank_apply_match_jax(kind, site):
    ad, jad, peft, jpeft = _site_inputs(kind, site)
    m, jm = adapter_api.resolve("fourierft"), jax_adapter.resolve("fourierft")
    tr, aux = m.split_adapter(ad, peft)
    jtr, jaux = jm.split_adapter(jad, jpeft)
    assert m.frozen_tables(aux, site.d_in, site.d_out) == {}
    x = np.random.default_rng(7).normal(
        size=(site.stack, 4, site.d_in)).astype(np.float32)
    y = m.factored_apply(torch.from_numpy(x[0]), {"c": tr["c"][0]}, aux,
                         site.d_in, site.d_out, peft)
    jy = jm.factored_apply(jnp.asarray(x[0]), {"c": jtr["c"][0]}, jaux,
                           site.d_in, site.d_out, jpeft)
    _close(y.numpy(), jy)
    yb = m.bank_apply(torch.from_numpy(x), tr, aux, site.d_in, site.d_out,
                      peft)
    jyb = jm.bank_apply(jnp.asarray(x), jtr, jaux, site.d_in, site.d_out,
                        jpeft)
    assert tuple(yb.shape) == (site.stack, 4, site.d_out)
    _close(yb.numpy(), jyb)
    # factored == x @ ΔW (tests/test_adapter_api.py's tolerance)
    dw = m.site_delta(ad, site, peft)
    _close(y.numpy(), (torch.from_numpy(x[0]) @ dw[0]).numpy(), 1e-6, 5e-4)


# ---------------------------------------------------------------------------
# Resolution: the basis route on the card, K1's limits kept
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_cuda_basis_site_resolves_to_the_matmul_route(kind):
    """By resolution alone (no launch): a basis site on CUDA tensors takes
    the torch.matmul route, whose note says it is a library product; it
    never falls through to einsum. On CPU tensors: the plain version."""
    peft = PEFTConfig(basis=kind, n=1000)
    op = api.resolve_op("deltaw", "fourierft", peft, 768, 768,
                        device="cuda")
    assert op.backend == "cuda" and op.fn is adapter_api._basis_deltaw_matmul
    assert "torch.matmul" in op.note and "library product" in op.note
    assert api.resolve_op("deltaw", "fourierft", peft, 768, 768,
                          device="cpu").backend == "einsum"
    sites = [AdapterSite("layers/wq", 768, 768, 12),
             AdapterSite("layers/wv", 768, 768, 12)]
    policy = api.KernelPolicy.build("fourierft", sites, peft, "cuda")
    assert policy.validate().backend_for("layers/wq", "deltaw") == "cuda"
    assert ("layers/wv (768x768) deltaw -> cuda (torch.matmul"
            in policy.explain())
    # a basis site needs no FFT plan: K1's shape limits do not apply
    api.resolve_op("deltaw", "fourierft", peft, 768, 8198, device="cuda")


def test_fourier_site_keeps_k1_and_its_limits():
    peft = PEFTConfig(n=1000)
    op = api.resolve_op("deltaw", "fourierft", peft, 4096, 4096,
                        device="cuda")
    assert op.fn is adapter_api._fourier_deltaw_cuda and "K1" in op.note
    # d2 = 2 x 4099: an odd prime factor beyond the FFT plan's
    with pytest.raises(api.KernelUnavailableError, match="4099"):
        api.resolve_op("deltaw", "fourierft", peft, 4096, 8198,
                       device="cuda")
    sites = [AdapterSite("layers/wq", 4096, 8198, 2)]
    with pytest.raises(api.KernelUnavailableError, match="4099"):
        api.KernelPolicy.build("fourierft", sites, peft, "cuda")


def test_a_key_takes_a_second_route_only_behind_predicates():
    def fn(*a):
        return None
    api.ensure_method("fourierft")
    assert len(api._OPS[("deltaw", "fourierft", "cuda")]) == 2
    with pytest.raises(ValueError, match="already registered"):
        api.register_kernel_op(api.KernelOp("deltaw", "fourierft", "einsum",
                                            fn))
    # a predicated route registered again (the same fn, or the same note)
    routes = api._OPS[("deltaw", "fourierft", "cuda")]
    for again in (routes[1], dataclasses.replace(routes[1], fn=fn)):
        with pytest.raises(ValueError, match="already registered"):
            api.register_kernel_op(again)
    assert api._OPS[("deltaw", "fourierft", "cuda")] == routes


# ---------------------------------------------------------------------------
# Accounting and adapters across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("basis_kind", ["fourier", "random", "orthogonal"])
@pytest.mark.parametrize("method", ["fourierft", "dct", "circulant", "lora",
                                    "bitfit", "none", "full"])
def test_shared_storage_numbers_match_jax(method, basis_kind):
    sites = list(SITES) + [AdapterSite("layers/wk", 48, 32, 3)]
    kw = dict(method=method, n=N, basis=basis_kind)
    mine = adapter_api.resolve(method).shared_storage_numbers(
        sites, PEFTConfig(**kw))
    theirs = jax_adapter.resolve(method).shared_storage_numbers(
        sites, JaxPEFT(**kw))
    assert mine == theirs
    if method in ("fourierft", "dct") and (basis_kind == "fourier"
                                           or method == "dct"):
        assert mine == 2 * N * 3           # three distinct site shapes
    else:
        assert mine == 0                   # bases regenerate from the seed


def _pair(kind):
    kw = dict(vocab=64, param_dtype="float32", dtype="float32")
    jcfg = jax_configs.reduced(jax_configs.get("gpt2-medium")).replace(**kw)
    tcfg = configs.reduced(configs.get("gpt2-medium")).replace(**kw)
    pk = dict(n=N, alpha=ALPHA, basis=kind)
    jmodel = jax_build(jcfg, JaxPEFT(**pk))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return (jmodel, jparams, build(tcfg, PEFTConfig(**pk)),
            from_jax_params(jax.device_get(jparams), "cpu"))


def _deltas(model, adapters, site_delta):
    by_name = {s.name: s for s in model.sites}
    return {name: np.asarray(site_delta(ad, by_name[name], model.peft))
            for name, ad in adapters.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_basis_tenants_cross_between_packages(tmp_path, kind):
    """A JAX export (c only; the bases regenerate at import) imports into
    the port with the same ΔW, and the reverse."""
    jmodel, jparams, tmodel, tparams = _pair(kind)
    jax_adapters.export_adapter(str(tmp_path), "from-jax", jparams["peft"],
                                jmodel.peft)
    mine, peft = adapters.import_adapter(str(tmp_path), "from-jax",
                                         sites=tmodel.sites)
    assert peft == tmodel.peft and set(mine["layers/wq"]) == {"c", "b1",
                                                              "b2"}
    theirs = _deltas(jmodel, jparams["peft"], jmodel.method.site_delta)
    for name, dw in _deltas(tmodel, mine, tmodel.method.site_delta).items():
        _close(dw, theirs[name])
    trained = {site: {**ad, "c": ad["c"] * 1.5}
               for site, ad in tparams["peft"].items()}
    adapters.export_adapter(str(tmp_path), "from-port", trained, tmodel.peft)
    back, jpeft = jax_adapters.import_adapter(str(tmp_path), "from-port",
                                              sites=jmodel.sites)
    assert jpeft == jmodel.peft
    theirs = _deltas(jmodel, back, jmodel.method.site_delta)
    for name, dw in _deltas(tmodel, trained,
                            tmodel.method.site_delta).items():
        _close(theirs[name], dw)
    # a bank group of the basis takes the tenant (its regenerated bases
    # are the group's shared aux)
    bank = AdapterBank(tmodel, {"fourierft": tmodel.peft}, capacity=2,
                       checkpoint_dir=str(tmp_path), device="cpu")
    assert bank.load_from_checkpoint("from-jax") == 0
    assert bank.table_bytes == 0


@pytest.mark.parametrize("kind", KINDS)
def test_merged_model_forward_and_gradient_match_jax(kind):
    jmodel, jparams, tmodel, tparams = _pair(kind)
    toks = np.random.default_rng(3).integers(0, 64, size=(2, 10)).astype(
        np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jlog = np.asarray(jmodel.forward(jparams, {"tokens": jnp.asarray(
        batch["tokens"])})[0])
    tlog = tmodel.forward(tparams, {"tokens": torch.from_numpy(
        batch["tokens"])})
    np.testing.assert_allclose(tlog.numpy(), jlog, atol=1e-5, rtol=1e-4)
    jtr, jfr = jax_step.split_params(jmodel, jparams)
    jloss, jg = jax.value_and_grad(lambda tr: jmodel.loss_from_parts(
        tr, jfr["base"], jfr["peft"],
        {k: jnp.asarray(v) for k, v in batch.items()}))(jtr)
    trainable, frozen = ts.split_params(tmodel, tparams)
    assert set(frozen["peft"]["layers/wq"]) == {"b1", "b2"}
    loss, g = ts._value_and_grad(
        ts._loss_for(tmodel), trainable, frozen,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(jloss), abs=1e-5)
    for site in ("layers/wq", "layers/wv"):
        np.testing.assert_allclose(g["peft"][site]["c"].numpy(),
                                   np.asarray(jg["peft"][site]["c"]),
                                   atol=1e-5)
