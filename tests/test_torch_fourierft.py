"""The port's FourierFT math and ΔW kernel module against the JAX package.

Same inputs (numpy seeds) through both packages: entry sampling and the
per-shape entry seed are identical; the port's plain ΔW version matches the
JAX Pallas kernel in interpret mode and both packages' ifft2 oracles at
atol 2e-4 (the tolerance `tests/test_kernels.py` holds the TPU kernel to),
single and stacked (L, n); the registry maps the JAX backend names onto
the port's. The CUDA kernel itself is held against the plain version on
the card by tests/test_torch_cuda_kernels.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adapter as jax_adapter
from repro.core import fourierft as jax_fourierft
from repro.configs.base import PEFTConfig as JaxPEFT
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.configs.base import PEFTConfig
from repro_torch.core import adapter as adapter_api
from repro_torch.core import fourierft
from repro_torch.kernels import api as kernel_api
from repro_torch.kernels import fourier_deltaw as fdk
from repro_torch.kernels import ops, ref

SHAPES = [                       # tests/test_kernels.py
    (128, 128, 16),
    (256, 512, 100),
    (300, 520, 64),
    (768, 768, 1000),
    (512, 96, 37),
    (64, 2048, 128),
]


def _coeffs(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("d1,d2,n,kw", [
    (128, 128, 16, {}),
    (4096, 512, 1000, {}),
    (300, 520, 64, {"freq_bias": True, "fc": 10.0}),
    (64, 16, 1000, {}),
])
def test_sample_entries_identical(d1, d2, n, kw):
    mine = fourierft.sample_entries(d1, d2, n, seed=2024 + d2, **kw)
    theirs = np.asarray(jax_fourierft.sample_entries(d1, d2, n,
                                                     seed=2024 + d2, **kw))
    assert mine.dtype == torch.int32
    np.testing.assert_array_equal(mine.numpy(), theirs)


@pytest.mark.parametrize("d_in,d_out", [(4096, 4096), (4096, 512), (64, 16)])
def test_entry_seed_for_identical(d_in, d_out):
    mine = adapter_api.entry_seed_for(
        PEFTConfig(), adapter_api.AdapterSite("layers/wq", d_in, d_out, 2))
    theirs = jax_adapter.entry_seed_for(
        JaxPEFT(), jax_adapter.AdapterSite("layers/wq", d_in, d_out, 2))
    assert mine == theirs


@pytest.mark.parametrize("d1,d2,n", SHAPES)
def test_plain_deltaw_matches_jax_interpret_kernel(d1, d2, n):
    E = np.array(jax_fourierft.sample_entries(d1, d2, n, seed=7))
    c = _coeffs(1, n)
    jax_kernel = np.asarray(jax_ops.fourier_deltaw(
        jnp.asarray(c), jnp.asarray(E), d1, d2, 300.0, backend="interpret"))
    jax_oracle = np.asarray(jax_ref.deltaw_ref(jnp.asarray(c),
                                               jnp.asarray(E), d1, d2, 300.0))
    mine = ops.fourier_deltaw(torch.from_numpy(c), torch.from_numpy(E),
                              d1, d2, 300.0).numpy()
    np.testing.assert_allclose(mine, jax_kernel, atol=2e-4)
    np.testing.assert_allclose(mine, jax_oracle, atol=2e-4)
    oracle = ref.deltaw_ref(torch.from_numpy(c), torch.from_numpy(E),
                            d1, d2, 300.0).numpy()
    np.testing.assert_allclose(oracle, jax_oracle, atol=2e-4)


@pytest.mark.parametrize("d1,d2,n,L", [(300, 520, 100, 4), (512, 96, 37, 3)])
def test_plain_deltaw_stacked_matches_jax(d1, d2, n, L):
    E = np.array(jax_fourierft.sample_entries(d1, d2, n, seed=7))
    c = _coeffs(2, L, n)
    jax_kernel = np.asarray(jax_ops.fourier_deltaw(
        jnp.asarray(c), jnp.asarray(E), d1, d2, 300.0, backend="interpret"))
    jax_einsum = np.asarray(jax_fourierft.materialize_delta(
        jnp.asarray(c), jnp.asarray(E), d1, d2, 300.0))
    mine = ops.fourier_deltaw_forward(torch.from_numpy(c),
                                      torch.from_numpy(E), d1, d2, 300.0)
    assert mine.shape == (L, d1, d2)
    np.testing.assert_allclose(mine.numpy(), jax_kernel, atol=2e-4)
    np.testing.assert_allclose(mine.numpy(), jax_einsum, atol=2e-4)


def test_wrapper_pads_n_with_zero_entries():
    """n = 37 pads to the kernel's chunk; the wrapper's input checks reject
    an unpadded n and a non-f32 c."""
    d1, d2, n = 64, 48, 37
    E = fourierft.sample_entries(d1, d2, n, seed=3)
    c = torch.from_numpy(_coeffs(4, 2, n))
    padded = ops.fourier_deltaw_forward(c, E, d1, d2, 10.0)
    plain = fourierft.materialize_delta(c, E, d1, d2, 10.0)
    np.testing.assert_allclose(padded.numpy(), plain.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        fdk.deltaw(c.contiguous(), E[0].contiguous(), E[1].contiguous(),
                   d1, d2, 10.0)
    with pytest.raises(ValueError, match="f32"):
        fdk.deltaw(c.double(), E[0], E[1], d1, d2, 10.0)


def test_factored_apply_equals_dense_delta():
    d1, d2, n = 96, 40, 50
    E = fourierft.sample_entries(d1, d2, n, seed=5)
    c = torch.from_numpy(_coeffs(6, n))
    x = torch.from_numpy(_coeffs(7, 3, d1))
    dw = fourierft.materialize_delta(c, E, d1, d2, 300.0)
    np.testing.assert_allclose(
        fourierft.factored_apply(x, c, E, d1, d2, 300.0).numpy(),
        (x @ dw).numpy(), atol=1e-5)
    jax_norm = float(jax_fourierft.delta_norm(jnp.asarray(c.numpy()),
                                              jnp.asarray(E.numpy()), d1, d2,
                                              300.0))
    assert float(fourierft.delta_norm(c, E, d1, d2, 300.0)) == \
        pytest.approx(float(torch.linalg.norm(dw)), rel=1e-4)
    assert float(fourierft.delta_norm(c, E, d1, d2, 300.0)) == \
        pytest.approx(jax_norm, rel=1e-5)


class TestRegistry:
    def test_backend_names_map_onto_the_port(self):
        for backend in ("auto", "pallas", "einsum"):
            op = kernel_api.resolve_op(
                "deltaw", "fourierft", PEFTConfig(kernel_backend=backend),
                64, 64, device="cpu")
            assert op.backend == "einsum"     # the kernel runs on CUDA only
        op = kernel_api.resolve_op("deltaw", "fourierft", PEFTConfig(),
                                   4096, 4096, device="cuda")
        assert op.backend == "cuda"
        op = kernel_api.resolve_op(
            "deltaw", "fourierft", PEFTConfig(kernel_backend="einsum"),
            4096, 4096, device="cuda")
        assert op.backend == "einsum"

    def test_interpret_has_no_meaning_here(self):
        with pytest.raises(ValueError, match="interpret"):
            kernel_api.resolve_op(
                "deltaw", "fourierft", PEFTConfig(kernel_backend="interpret"),
                64, 64, device="cpu")

    def test_unsupported_cuda_site_raises_instead_of_degrading(self):
        # d2 = 2 x 4099: beyond K1's FFT plan (odd prime factors <= 63)
        peft = PEFTConfig()
        with pytest.raises(kernel_api.KernelUnavailableError):
            kernel_api.resolve_op("deltaw", "fourierft", peft, 64, 8198,
                                  device="cuda")
        op = kernel_api.resolve_op("deltaw", "fourierft", peft, 64, 8198,
                                   device="cpu")
        assert op.backend == "einsum"

    def test_policy_explains_each_site(self):
        sites = [adapter_api.AdapterSite("layers/wq", 4096, 4096, 2),
                 adapter_api.AdapterSite("layers/wk", 4096, 512, 2),
                 adapter_api.AdapterSite("layers/wv", 4096, 512, 2)]
        policy = kernel_api.KernelPolicy.build("fourierft", sites,
                                               PEFTConfig(), "cuda")
        assert policy.validate().backend_for("layers/wq", "deltaw") == "cuda"
        assert policy.backend_for("layers/wk", "deltaw") is None
        assert "layers/wv (4096x512) deltaw -> cuda" in policy.explain()

