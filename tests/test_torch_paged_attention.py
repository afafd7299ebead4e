"""The port's paged decode attention against the JAX package's Pallas kernel.

Inputs are built as `tests/test_paged_attention.py` builds them, from numpy
seeds, and fed to both packages: the port's plain version (block-table
gather + dense ragged attention) against `paged_attention_pallas` in
interpret mode at atol/rtol 1e-5 in f32 and 2e-2 in bf16, over seeds 0-3,
MHA (G = 1) and the kv_len edges (1, the full window, one page). The CUDA
kernel is held against the plain version on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jax_pa
from repro_torch.configs.base import PEFTConfig
from repro_torch.kernels import api as kernel_api
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import attention as attn_mod


def _case(seed, B=3, H=8, K=2, dh=16, n_pages=14, ps=4, pps=6, W=1):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, W, H, dh)).astype(np.float32)
    kp = rng.normal(size=(n_pages, ps, K, dh)).astype(np.float32)
    vp = rng.normal(size=(n_pages, ps, K, dh)).astype(np.float32)
    bt = rng.integers(0, n_pages, size=(B, pps)).astype(np.int32)
    kv_len = rng.integers(1, pps * ps - W + 2, size=(B,)).astype(np.int32)
    return q, kp, vp, bt, kv_len


def _both(q, kp, vp, bt, kv_len, dtype=np.float32):
    """(port plain version, JAX interpret kernel) on the same inputs."""
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    mine = pa.paged_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
        torch.from_numpy(vp).to(tdt), torch.from_numpy(bt),
        torch.from_numpy(kv_len))
    theirs = jax_pa.paged_attention_pallas(
        jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(bt), jnp.asarray(kv_len), interpret=True)
    return (mine.to(torch.float32).numpy(),
            np.asarray(theirs.astype(jnp.float32)))


@pytest.mark.parametrize("seed", range(4))
def test_plain_matches_jax_interpret_kernel(seed):
    mine, theirs = _both(*_case(seed))
    np.testing.assert_allclose(mine, theirs, atol=1e-5, rtol=1e-5)


def test_mha_no_gqa_groups():
    mine, theirs = _both(*_case(7, H=4, K=4))
    np.testing.assert_allclose(mine, theirs, atol=1e-5, rtol=1e-5)


def test_kv_len_edges():
    """kv_len = 1 (a freshly reset slot), the full window, and one page."""
    q, kp, vp, bt, _ = _case(11)
    pps, ps = bt.shape[1], kp.shape[1]
    kv_len = np.asarray([1, pps * ps, ps], np.int32)
    mine, theirs = _both(q, kp, vp, bt, kv_len)
    np.testing.assert_allclose(mine, theirs, atol=1e-5, rtol=1e-5)
    assert not np.isnan(mine).any()


@pytest.mark.parametrize("seed", range(2))
def test_bf16_matches_jax_interpret_kernel(seed):
    mine, theirs = _both(*_case(seed, dh=32, ps=8), dtype="bfloat16")
    np.testing.assert_allclose(mine, theirs, atol=2e-2, rtol=2e-2)


def test_plain_equals_dense_ragged_attention():
    """Identity block table over a pool that IS the dense cache laid out
    page by page: paged == direct_attention bit for bit (f32)."""
    rng = np.random.default_rng(3)
    B, H, K, dh, ps, pps = 2, 4, 2, 8, 4, 5
    max_len = pps * ps
    ck = torch.from_numpy(rng.normal(size=(B, max_len, K, dh)).astype(np.float32))
    cv = torch.from_numpy(rng.normal(size=(B, max_len, K, dh)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(B, 1, H, dh)).astype(np.float32))
    kv_len = torch.tensor([7, 18], dtype=torch.int32)
    bt = torch.arange(B * pps, dtype=torch.int32).reshape(B, pps)
    dense = attn_mod.direct_attention(q, ck, cv, causal=False, kv_len=kv_len)
    paged = pa.paged_attention(q, ck.reshape(B * pps, ps, K, dh),
                               cv.reshape(B * pps, ps, K, dh), bt, kv_len)
    assert torch.equal(dense, paged)


def test_registry_routes_by_device():
    peft = PEFTConfig()
    assert kernel_api.resolve_op("paged_attention", pa.OWNER, peft, 16, 128,
                                 device="cpu").backend == "einsum"
    assert kernel_api.resolve_op("paged_attention", pa.OWNER, peft, 16, 128,
                                 device="cuda").backend == "cuda"
    assert kernel_api.resolve_op(
        "paged_attention", pa.OWNER, PEFTConfig(kernel_backend="einsum"),
        16, 128, device="cuda").backend == "einsum"


def test_wrapper_rejects_bad_inputs():
    q, kp, vp, bt, kv_len = (torch.from_numpy(a) for a in _case(0))
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention(q, kp, vp, bt.long(), kv_len)
    with pytest.raises(ValueError, match="group"):
        pa.paged_attention(q[:, :, :3], kp, vp, bt, kv_len)

