"""The port's `dct` method (the LoCA-style cosine basis) against the JAX
package, on the CPU.

Same inputs (numpy seeds) through both packages, on a reduced, ragged site
(96×160, L = 2, n = 37: a multiple of neither the port's chunk of 16 nor
the TPU kernel's lane of 128):

- the entries of a site equal JAX's;
- the plain ΔW (`dct_deltaw.deltaw`, and `DCTDeltaW` on CPU tensors)
  equals JAX's `dct_deltaw_harness` in interpret mode and its
  `_dct_deltaw_einsum` at atol 2e-5 / rtol 1e-5, the site_delta tolerance
  of tests/test_kernel_registry.py;
- the plain dc and `DCTDeltaW`'s gradient equal `jax.grad` through the
  interpret harness at atol 1e-4 / rtol 1e-3, that file's gradient
  tolerance;
- a merged dct model's prefill and decode logits equal `repro`'s;
- `launch.train --method dct` then `launch.serve --method dct --adapters`
  run on the CPU and serve what an in-process scheduler serves from the
  restored params;
- the kernel policy picks the CUDA kernel for CUDA tensors, and
  `interpret` raises.

The train-step, checkpoint, adapter and token-stream parity of the dct
method are the `method` cases of tests/test_torch_{train,serve}.py; the
CUDA kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py."""
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.configs.base import PEFTConfig as JaxPEFT
from repro.core import adapter as jax_adapter
from repro.kernels import ops as jax_ops
from repro.models import build as jax_build
from repro.serve import merge_for_serving as jax_merge
from repro_torch import configs
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import PEFTConfig
from repro_torch.convert import from_jax_params
from repro_torch.core import adapter as adapter_api
from repro_torch.kernels import api as kernel_api
from repro_torch.kernels import dct_deltaw as ddk
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build
from repro_torch.serve import ContinuousScheduler, Engine
from repro_torch.serve import merge_for_serving
from repro_torch.train.step import join_params, split_params

D1, D2, L, N = 96, 160, 2, 37        # tests/test_kernel_registry.py's site
ALPHA = 25.0
ATOL_DW, RTOL_DW = 2e-5, 1e-5        # tests/test_kernel_registry.py:70
ATOL_G, RTOL_G = 1e-4, 1e-3          # tests/test_kernel_registry.py:136


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _entries(d1=D1, d2=D2, n=N):
    site = adapter_api.AdapterSite("layers/wq", d1, d2, L)
    peft = PEFTConfig(method="dct", n=n)
    return adapter_api.resolve("dct").init_site(
        torch.Generator().manual_seed(0), site, peft, "cpu")["entries"]


def _padded(E, n):
    npad = -(-n // ddk.NC) * ddk.NC
    e = torch.zeros((2, npad), dtype=torch.int32)
    e[:, :n] = torch.as_tensor(np.asarray(E), dtype=torch.int32)
    return e[0].contiguous(), e[1].contiguous()


@pytest.mark.parametrize("d1,d2,n", [(D1, D2, N), (4096, 512, 1000)])
def test_site_entries_match_jax(d1, d2, n):
    site = adapter_api.AdapterSite("layers/wv", d1, d2, L)
    jsite = jax_adapter.AdapterSite("layers/wv", d1, d2, L)
    mine = adapter_api.resolve("dct").init_site(
        torch.Generator().manual_seed(0), site,
        PEFTConfig(method="dct", n=n), "cpu")
    theirs = jax_adapter.resolve("dct").init_site(
        jax.random.PRNGKey(0), jsite, JaxPEFT(method="dct", n=n))
    assert mine["entries"].dtype == torch.int32
    np.testing.assert_array_equal(mine["entries"].numpy(),
                                  np.asarray(theirs["entries"]))
    assert mine["c"].shape == theirs["c"].shape == (L, n)
    assert adapter_api.resolve("dct").count_trainable(
        site, PEFTConfig(method="dct", n=n)) == n * L


@pytest.mark.parametrize("d1,d2,n,stacked", [(D1, D2, N, False),
                                             (D1, D2, N, True),
                                             (300, 520, 100, True)])
def test_plain_deltaw_matches_jax_interpret_harness(d1, d2, n, stacked):
    E = _entries(d1, d2, n)
    c = _normal(1, L, n) if stacked else _normal(1, n)
    jE = jnp.asarray(E.numpy())
    jax_kernel = np.asarray(jax_ops.dct_deltaw_harness(
        jnp.asarray(c), jE, d1, d2, ALPHA, interpret=True))
    jax_einsum = np.asarray(jax_adapter._dct_deltaw_einsum(
        {"c": jnp.asarray(c)}, {"entries": jE}, d1, d2,
        JaxPEFT(method="dct", alpha=ALPHA)))
    mine = ops.dct_deltaw_forward(torch.from_numpy(c), E, d1, d2, ALPHA)
    assert mine.shape == c.shape[:-1] + (d1, d2)
    for theirs in (jax_kernel, jax_einsum):
        np.testing.assert_allclose(mine.numpy(), theirs, atol=ATOL_DW,
                                   rtol=RTOL_DW)
    u, v = _padded(E, n)
    c2 = torch.from_numpy(c).reshape(-1, n)
    cp = torch.zeros((c2.shape[0], u.shape[0]))
    cp[:, :n] = c2
    direct = ddk.deltaw(cp, u, v, d1, d2, ALPHA)
    np.testing.assert_allclose(direct.numpy().reshape(mine.shape),
                               jax_kernel, atol=ATOL_DW, rtol=RTOL_DW)


@pytest.mark.parametrize("stacked", [False, True])
def test_plain_dc_and_function_gradient_match_jax_grad(stacked):
    E = _entries()
    shape = (L, N) if stacked else (N,)
    c = _normal(2, *shape)
    g = _normal(3, *shape[:-1], D1, D2)
    jE = jnp.asarray(E.numpy())
    jax_vjp = np.asarray(jax.grad(lambda cc: jnp.vdot(
        jnp.asarray(g), jax_ops.dct_deltaw_harness(
            cc, jE, D1, D2, ALPHA, interpret=True)))(jnp.asarray(c)))
    u, v = _padded(E, N)
    g3 = torch.from_numpy(g).reshape(-1, D1, D2).contiguous()
    plain = ddk.dc(g3, u, v, D1, D2, ALPHA)[:, :N].reshape(shape)
    np.testing.assert_allclose(plain.numpy(), jax_vjp, atol=ATOL_G,
                               rtol=RTOL_G)
    ct = torch.from_numpy(c).requires_grad_(True)
    before = (ddk.launches, ddk.dc_launches)
    torch.sum(ops.DCTDeltaW.apply(ct, E, D1, D2, ALPHA)
              * torch.from_numpy(g)).backward()
    assert (ddk.launches, ddk.dc_launches) == before   # plain on the CPU
    assert ct.grad.shape == shape and ct.grad.dtype == torch.float32
    np.testing.assert_allclose(ct.grad.numpy(), jax_vjp, atol=ATOL_G,
                               rtol=RTOL_G)


def test_bases_reduce_the_phase_exactly():
    """At yi-6b's 4096 (and above) the product (2j+1)·u passes 2^24. The
    port reduces it modulo 4d in int64 and stays within f32 rounding of a
    float64 basis; the JAX package's float32 product (ROADMAP queue 3) is
    off by more than 1e-4 there."""
    d = 8192
    E = torch.tensor([[d - 1, d // 3, 7, 4095], [1, d - 2, 5000, 3]],
                     dtype=torch.int32)
    j = np.arange(d, dtype=np.float64)[:, None]
    exact = [np.cos(np.pi * (2 * j + 1) * E[i].numpy().astype(np.float64)
                    / (2 * d)) for i in (0, 1)]
    c1, c2 = adapter_api.dct_bases(E, d, d)
    np.testing.assert_allclose(c1.numpy(), exact[0], atol=1e-6)
    np.testing.assert_allclose(c2.numpy(), exact[1], atol=1e-6)
    jax_c1, _ = jax_adapter._dct_bases(jnp.asarray(E.numpy()), d, d)
    assert np.abs(np.asarray(jax_c1) - exact[0]).max() > 1e-4


def test_wrapper_checks_and_entries_modulo_4d():
    """The kernels reduce entries modulo 4d (the cosine's period in the
    integer phase) instead of checking them on the host; the plain
    versions' int64 phase does the same. The wrappers reject what the
    kernels do not take."""
    E = _entries()
    u, v = _padded(E, N)
    c = torch.from_numpy(_normal(4, L, u.shape[0]))
    g = torch.from_numpy(_normal(5, L, D1, D2))
    shifted = ((u - 4 * D1).contiguous(), (v + 8 * D2).contiguous())
    np.testing.assert_allclose(ddk.deltaw(c, *shifted, D1, D2, 5.0).numpy(),
                               ddk.deltaw(c, u, v, D1, D2, 5.0).numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(ddk.dc(g, *shifted, D1, D2, 5.0).numpy(),
                               ddk.dc(g, u, v, D1, D2, 5.0).numpy(),
                               atol=1e-5)
    with pytest.raises(ValueError, match="multiple"):
        ddk.deltaw(c[:, :N].contiguous(), E[0].contiguous(),
                   E[1].contiguous(), D1, D2, 5.0)
    with pytest.raises(ValueError, match="f32"):
        ddk.dc(g.double(), u, v, D1, D2, 5.0)


def _model_pair(n=24):
    kw = dict(vocab=64, param_dtype="float32", dtype="float32")
    jcfg = jax_configs.reduced(jax_configs.get("yi-6b")).replace(**kw)
    tcfg = configs.reduced(configs.get("yi-6b")).replace(**kw)
    jmodel = jax_build(jcfg, JaxPEFT(method="dct", n=n, alpha=ALPHA))
    jparams = jmodel.init(jax.random.PRNGKey(3))
    tmodel = build(tcfg, PEFTConfig(method="dct", n=n, alpha=ALPHA))
    return jmodel, jparams, tmodel, from_jax_params(
        jax.device_get(jparams), "cpu")


def test_merged_dct_prefill_and_decode_match_jax():
    """Merged dct weights, then the prefill's next token and one decode
    step's logits against JAX's merged forward, at 1e-4 (tighter than the
    5e-4 / 1e-3 tests/test_kernel_registry.py:252 holds the JAX paths to)."""
    jmodel, jparams, tmodel, tparams = _model_pair()
    jm, jp = jax_merge(jmodel, jparams)
    tm, tp = merge_for_serving(tmodel, tparams)
    for key in ("wq", "wv"):
        np.testing.assert_allclose(tp["base"]["layers"][key].numpy(),
                                   np.asarray(jp["base"]["layers"][key]),
                                   atol=ATOL_DW, rtol=RTOL_DW)
    prompt = np.random.default_rng(6).integers(0, 64, size=(2, 9)).astype(
        np.int32)
    jcache = jm.init_cache(2, 16, dtype=jnp.float32)
    jnext, jcache = jm.prefill(jp, jcache, {"tokens": jnp.asarray(prompt)})
    tcache = tm.init_cache(2, 16, torch.float32, "cpu")
    tnext, tcache = tm.prefill(tp, tcache, {"tokens": torch.from_numpy(prompt)})
    assert tnext.tolist() == np.asarray(jnext).reshape(-1).tolist()
    tlog, _ = tm.decode_logits(tp, tcache, {"tokens": tnext[:, None]})
    full = np.concatenate([prompt, np.asarray(jnext)[:, None]], axis=1)
    jref = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(full)})[0])
    np.testing.assert_allclose(tlog[:, 0].numpy(), jref[:, -1], atol=1e-4)
    # and the unmerged forward, where the train step materializes ΔW
    jlogits = np.asarray(jmodel.forward(jparams, {"tokens": jnp.asarray(
        prompt)})[0])
    tlogits = tmodel.forward(tparams, {"tokens": torch.from_numpy(prompt)})
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits, atol=1e-4)


def _served(out: str):
    return [json.loads(m) for m in re.findall(r"^request \d+ .*?: (\[.*\])$", out,
                                        flags=re.M)]


def test_launchers_train_then_serve_a_dct_checkpoint(capsys, tmp_path):
    ck = str(tmp_path / "dct")
    launch_train.main(["--arch", "yi-6b", "--reduced", "--method", "dct",
                       "--steps", "2", "--n", "64", "--batch", "2", "--seq",
                       "16", "--device", "cpu", "--ckpt-dir", ck,
                       "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "method=dct" in out and "done: steps=2" in out
    assert "layers/wq (64x64) deltaw -> einsum" in out
    launch_serve.main(["--arch", "yi-6b", "--reduced", "--method", "dct",
                       "--n", "64", "--adapters", ck, "--continuous",
                       "--device", "cpu", "--trace-n", "4"])
    out = capsys.readouterr().out
    assert "loaded adapters from step 2" in out
    assert "continuous: 4 requests" in out
    served = _served(out)
    assert len(served) == 4
    # the same trace served in-process from the restored params
    cfg = configs.get("yi-6b")
    cfg = configs.reduced(cfg).replace(vocab=min(cfg.vocab, 512))
    model = build(cfg, PEFTConfig(method="dct", n=64, alpha=300.0))
    fresh = model.init(0, "cpu")
    state, at = ckpt.restore(ck)
    assert at == 2
    params = join_params(model, state["trainable"], split_params(model,
                                                                 fresh)[1])
    assert not torch.equal(params["peft"]["layers/wq"]["c"],
                           fresh["peft"]["layers/wq"]["c"])
    engine = Engine(model, params, batch_slots=2, max_len=128, device="cpu")
    sched = ContinuousScheduler(engine, page_size=16)
    reqs, arrivals = launch_serve.demo_trace(
        launch_serve.demo_prompts(cfg, 2), 4, 16, 2.0)
    sched.serve(reqs, arrivals)
    assert [r.out for r in reqs] == served


def test_kernel_policy_picks_the_cuda_kernel_for_cuda_tensors():
    sites = [adapter_api.AdapterSite("layers/wq", 4096, 4096, 2),
             adapter_api.AdapterSite("layers/wk", 4096, 512, 2),
             adapter_api.AdapterSite("layers/wv", 4096, 512, 2)]
    peft = PEFTConfig(method="dct")
    policy = kernel_api.KernelPolicy.build("dct", sites, peft, "cuda")
    assert policy.validate().backend_for("layers/wq", "deltaw") == "cuda"
    assert policy.backend_for("layers/wk", "deltaw") is None
    text = policy.explain()
    assert "method=dct" in text
    assert "layers/wv (4096x512) deltaw -> cuda" in text
    cpu = kernel_api.KernelPolicy.build("dct", sites, peft, "cpu")
    assert cpu.backend_for("layers/wq", "deltaw") == "einsum"
    einsum = kernel_api.KernelPolicy.build(
        "dct", sites, peft.replace(kernel_backend="einsum"), "cuda")
    assert einsum.backend_for("layers/wq", "deltaw") == "einsum"
    with pytest.raises(ValueError, match="interpret"):
        kernel_api.KernelPolicy.build(
            "dct", sites, peft.replace(kernel_backend="interpret"), "cuda")
    with pytest.raises(ValueError, match="interpret"):
        build(configs.reduced(configs.get("yi-6b")),
              PEFTConfig(method="dct", kernel_backend="interpret"))
