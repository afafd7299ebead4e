"""The port's dc (K2) module and the ΔW autograd Function against the JAX
package, on the CPU.

Same inputs (numpy seeds) through both packages: the plain version of the
dc kernel matches JAX's `ref.dc_ref` (the fft2 oracle) and `jax.grad`
through the JAX Pallas kernel pair in interpret mode, at the shapes and
tolerance of `tests/test_kernels.py` (atol 2e-3, rtol 1e-4). The port's
`FourierDeltaW` Function — forward K1, backward K2, plain versions on CPU
tensors — gives the same ΔW and gradient as autograd through
`materialize_delta`, single and stacked, with n not a multiple of the
kernels' chunk. The CUDA kernel itself is held against the plain version
on the card by tests/test_torch_cuda_kernels.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fourierft as jax_fourierft
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.configs.base import PEFTConfig
from repro_torch.core import adapter as adapter_api
from repro_torch.core import fourierft
from repro_torch.kernels import fourier_deltaw as fdk
from repro_torch.kernels import ops, ref

SHAPES = [                       # tests/test_kernels.py, the dc cases
    (128, 128, 16),
    (256, 512, 100),
    (300, 520, 64),
    (768, 768, 1000),
]
ATOL, RTOL = 2e-3, 1e-4


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _padded(E, n):
    npad = -(-n // fdk.NC) * fdk.NC
    e = torch.zeros((2, npad), dtype=torch.int32)
    e[:, :n] = torch.from_numpy(np.asarray(E, np.int32))
    return e[0].contiguous(), e[1].contiguous()


@pytest.mark.parametrize("d1,d2,n", SHAPES)
def test_plain_dc_matches_jax_oracle_and_interpret_vjp(d1, d2, n):
    E = np.array(jax_fourierft.sample_entries(d1, d2, n, seed=7))
    c = _normal(1, n)
    g = _normal(2, d1, d2)
    jax_oracle = np.asarray(jax_ref.dc_ref(jnp.asarray(g), jnp.asarray(E),
                                           300.0))
    f = lambda cc: jnp.vdot(jnp.asarray(g), jax_ops.fourier_deltaw(
        cc, jnp.asarray(E), d1, d2, 300.0, backend="interpret"))
    jax_vjp = np.asarray(jax.grad(f)(jnp.asarray(c)))
    u, v = _padded(E, n)
    mine = fdk.dc(torch.from_numpy(g)[None].contiguous(), u, v, d1, d2,
                  300.0)[0, :n].numpy()
    np.testing.assert_allclose(mine, jax_oracle, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(mine, jax_vjp, atol=ATOL, rtol=RTOL)
    oracle = ref.dc_ref(torch.from_numpy(g), torch.from_numpy(E),
                        300.0).numpy()
    np.testing.assert_allclose(oracle, jax_oracle, atol=ATOL, rtol=RTOL)


def test_plain_dc_stacked_matches_per_layer_oracle():
    d1, d2, n, L = 300, 520, 37, 3
    E = fourierft.sample_entries(d1, d2, n, seed=7)
    g = torch.from_numpy(_normal(3, L, d1, d2))
    u, v = _padded(E, n)
    mine = fdk.dc(g, u, v, d1, d2, 300.0)
    assert mine.shape == (L, u.shape[0])
    oracle = ref.dc_ref(g, E, 300.0)
    assert oracle.shape == (L, n)
    np.testing.assert_allclose(mine[:, :n].numpy(), oracle.numpy(),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("stacked", [False, True])
def test_function_gradient_equals_autograd_through_materialize(stacked):
    """n = 37 pads to 48 inside the Function; the gradient comes back at
    c's shape, equal to autograd through the plain einsum path."""
    d1, d2, n = 96, 40, 37
    E = fourierft.sample_entries(d1, d2, n, seed=5)
    shape = (3, n) if stacked else (n,)
    c0 = torch.from_numpy(_normal(6, *shape))
    g = torch.from_numpy(_normal(7, *shape[:-1], d1, d2))
    c = c0.clone().requires_grad_(True)
    out = ops.FourierDeltaW.apply(c, E, d1, d2, 300.0)
    torch.sum(out * g).backward()
    c_ref = c0.clone().requires_grad_(True)
    plain = fourierft.materialize_delta(c_ref, E, d1, d2, 300.0)
    torch.sum(plain * g).backward()
    assert out.shape == plain.shape == shape[:-1] + (d1, d2)
    np.testing.assert_allclose(out.detach().numpy(), plain.detach().numpy(),
                               atol=1e-6)
    assert c.grad.shape == c0.shape and c.grad.dtype == torch.float32
    np.testing.assert_allclose(c.grad.numpy(), c_ref.grad.numpy(),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        c.grad.numpy(), ref.dc_ref(g, E, 300.0).numpy(), atol=ATOL, rtol=RTOL)


def test_cuda_site_delta_carries_a_gradient_on_cpu_tensors():
    """The registry's `cuda` op is the Function, so a merge through it is
    differentiable; on CPU tensors its halves are the plain versions, and
    no kernel launches."""
    site = adapter_api.AdapterSite("layers/wq", 64, 48, 2)
    peft = PEFTConfig(n=20)
    method = adapter_api.resolve("fourierft")
    gen = torch.Generator().manual_seed(0)
    ad = method.init_site(gen, site, peft, "cpu")
    c = ad["c"].clone().requires_grad_(True)
    op = method.kernel_ops()[1]
    assert op.backend == "cuda"
    before = (fdk.launches, fdk.dc_launches)
    dw = op.fn({"c": c}, {"entries": ad["entries"]}, 64, 48, peft)
    g = torch.from_numpy(_normal(8, 2, 64, 48))
    torch.sum(dw * g).backward()
    assert (fdk.launches, fdk.dc_launches) == before
    c_ref = ad["c"].clone().requires_grad_(True)
    plain = method.site_delta({"c": c_ref, "entries": ad["entries"]}, site,
                              peft.replace(kernel_backend="einsum"))
    torch.sum(plain * g).backward()
    np.testing.assert_allclose(c.grad.numpy(), c_ref.grad.numpy(),
                               atol=ATOL, rtol=RTOL)


def test_dc_wrapper_rejects_what_the_kernel_does_not_take():
    d1, d2, n = 32, 24, 16
    E = fourierft.sample_entries(d1, d2, n, seed=3)
    u, v = E[0].contiguous(), E[1].contiguous()
    g = torch.zeros((1, d1, d2))
    with pytest.raises(ValueError, match="f32"):
        fdk.dc(g.double(), u, v, d1, d2, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        fdk.dc(torch.zeros((1, d2, d1)).transpose(1, 2), u, v, d1, d2, 1.0)
    with pytest.raises(ValueError, match="multiple"):
        fdk.dc(g, u[:10].contiguous(), v[:10].contiguous(), d1, d2, 1.0)
    with pytest.raises(ValueError, match="int32"):
        fdk.dc(g, u.long(), v, d1, d2, 1.0)


def test_entries_off_the_grid_give_the_same_phases():
    """The kernels reduce entries modulo the grid instead of checking them
    on the host; the plain versions' int64 phase does the same."""
    d1, d2, n = 40, 24, 16
    E = fourierft.sample_entries(d1, d2, n, seed=4)
    u, v = E[0].contiguous(), E[1].contiguous()
    c = torch.from_numpy(_normal(9, 2, n))
    g = torch.from_numpy(_normal(10, 2, d1, d2))
    shifted = ((u - 3 * d1).contiguous(), (v + d2).contiguous())
    np.testing.assert_allclose(
        fdk.deltaw(c, *shifted, d1, d2, 5.0).numpy(),
        fdk.deltaw(c, u, v, d1, d2, 5.0).numpy(), atol=1e-6)
    np.testing.assert_allclose(
        fdk.dc(g, *shifted, d1, d2, 5.0).numpy(),
        fdk.dc(g, u, v, d1, d2, 5.0).numpy(), atol=1e-6)
