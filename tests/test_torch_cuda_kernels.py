"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card: it carries the `cuda` marker and
skips, from the `cuda_device` fixture, where there is none. The module
imports neither JAX nor the JAX package, so on the machine with the card it
runs without them:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_kernels.py

(`--noconftest` because tests/conftest.py imports JAX.)"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import PEFTConfig
from repro_torch.core import fourierft
from repro_torch.core.adapter import dct_delta
from repro_torch.kernels import dct_deltaw as ddk
from repro_torch.kernels import fourier_deltaw as fdk
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import build
from repro_torch.serve import ContinuousScheduler, Engine, Request

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("d1,d2,n,L", [(4096, 512, 1000, 2), (300, 520, 37, 1),
                                       (512, 96, 64, 3), (130, 7, 5, 1)])
def test_deltaw_kernel_matches_plain(cuda_device, d1, d2, n, L):
    E = fourierft.sample_entries(d1, d2, n, seed=7).to(cuda_device)
    c = torch.from_numpy(np.random.default_rng(8).normal(
        size=(L, n)).astype(np.float32)).to(cuda_device)
    before = fdk.launches
    out = ops.fourier_deltaw_forward(c, E, d1, d2, 300.0)
    assert fdk.launches == before + 1
    plain = fourierft.materialize_delta(c, E, d1, d2, 300.0)
    np.testing.assert_allclose(out.cpu().numpy(), plain.cpu().numpy(),
                               atol=2e-4)


@pytest.mark.parametrize("d1,d2,n,L", [(4096, 512, 1000, 2), (300, 520, 37, 1),
                                       (512, 96, 64, 3), (130, 7, 5, 1)])
def test_dc_kernel_matches_plain(cuda_device, d1, d2, n, L):
    """K2 against its plain version at atol 2e-3 / rtol 1e-4 (the JAX
    suite's dc tolerance), bit-identical on a second launch (fixed-order
    reduction), and the Function's backward launches it once."""
    E = fourierft.sample_entries(d1, d2, n, seed=7).to(cuda_device)
    rng = np.random.default_rng(9)
    g = torch.from_numpy(rng.normal(size=(L, d1, d2)).astype(
        np.float32)).to(cuda_device)
    npad = -(-n // fdk.NC) * fdk.NC
    e = torch.zeros((2, npad), dtype=torch.int32, device=cuda_device)
    e[:, :n] = E
    u, v = e[0].contiguous(), e[1].contiguous()
    before = fdk.dc_launches
    out = fdk.dc(g, u, v, d1, d2, 300.0)
    assert fdk.dc_launches == before + 1
    plain = fdk.dc_reference(g, u, v, d1, d2, 300.0)
    np.testing.assert_allclose(out.cpu().numpy(), plain.cpu().numpy(),
                               atol=2e-3, rtol=1e-4)
    assert torch.equal(fdk.dc(g, u, v, d1, d2, 300.0), out)
    c = torch.from_numpy(rng.normal(size=(L, n)).astype(
        np.float32)).to(cuda_device).requires_grad_(True)
    before = fdk.dc_launches
    torch.sum(ops.FourierDeltaW.apply(c, E, d1, d2, 300.0) * g).backward()
    assert fdk.dc_launches == before + 1
    np.testing.assert_allclose(c.grad.cpu().numpy(),
                               plain[:, :n].cpu().numpy(), atol=2e-3,
                               rtol=1e-4)


@pytest.mark.parametrize("d1,d2,n,L", [(4096, 512, 1000, 2), (300, 520, 37, 1),
                                       (512, 96, 64, 3), (130, 7, 5, 1)])
def test_dct_deltaw_kernel_matches_plain(cuda_device, d1, d2, n, L):
    """K4 against its plain version at atol 2e-5 / rtol 1e-5 (the JAX
    suite's site_delta tolerance), through the padding harness."""
    E = fourierft.sample_entries(d1, d2, n, seed=7).to(cuda_device)
    c = torch.from_numpy(np.random.default_rng(8).normal(
        size=(L, n)).astype(np.float32)).to(cuda_device)
    before = ddk.launches
    out = ops.dct_deltaw_forward(c, E, d1, d2, 300.0)
    assert ddk.launches == before + 1
    plain = dct_delta(c, E, d1, d2, 300.0)
    np.testing.assert_allclose(out.cpu().numpy(), plain.cpu().numpy(),
                               atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("d1,d2,n,L", [(4096, 512, 1000, 2), (300, 520, 37, 1),
                                       (512, 96, 64, 3), (130, 7, 5, 1)])
def test_dct_dc_kernel_matches_plain(cuda_device, d1, d2, n, L):
    """K5 against its plain version at atol 1e-4 / rtol 1e-3 (the JAX
    suite's gradient tolerance), bit-identical on a second launch, and
    `DCTDeltaW`'s backward launches it once with c.grad equal to autograd
    through the plain version."""
    E = fourierft.sample_entries(d1, d2, n, seed=7).to(cuda_device)
    rng = np.random.default_rng(9)
    g = torch.from_numpy(rng.normal(size=(L, d1, d2)).astype(
        np.float32)).to(cuda_device)
    npad = -(-n // ddk.NC) * ddk.NC
    e = torch.zeros((2, npad), dtype=torch.int32, device=cuda_device)
    e[:, :n] = E
    u, v = e[0].contiguous(), e[1].contiguous()
    before = ddk.dc_launches
    out = ddk.dc(g, u, v, d1, d2, 300.0)
    assert ddk.dc_launches == before + 1
    plain = ddk.dc_reference(g, u, v, d1, d2, 300.0)
    np.testing.assert_allclose(out.cpu().numpy(), plain.cpu().numpy(),
                               atol=1e-4, rtol=1e-3)
    assert torch.equal(ddk.dc(g, u, v, d1, d2, 300.0), out)
    c0 = torch.from_numpy(rng.normal(size=(L, n)).astype(
        np.float32)).to(cuda_device)
    c = c0.clone().requires_grad_(True)
    before = ddk.dc_launches
    torch.sum(ops.DCTDeltaW.apply(c, E, d1, d2, 300.0) * g).backward()
    assert ddk.dc_launches == before + 1
    c_ref = c0.clone().requires_grad_(True)
    torch.sum(dct_delta(c_ref, E, d1, d2, 300.0) * g).backward()
    np.testing.assert_allclose(c.grad.cpu().numpy(), c_ref.grad.cpu().numpy(),
                               atol=1e-4, rtol=1e-3)


def test_train_steps_run_both_kernels(cuda_device):
    """A reduced yi-6b (head_dim 128) trained on the card: every step
    launches K1 and K2 once per site and microbatch, and the losses track
    the plain (einsum) run's."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.train import step as ts
    cfg = configs.reduced(configs.get("yi-6b"), width=512).replace(
        vocab=64, param_dtype="float32", dtype="float32")
    tcfg = TrainConfig(learning_rate=1e-2, total_steps=3, warmup_steps=1,
                       microbatch=2)
    data = SyntheticLM(vocab=64, batch=4, seq=16)
    losses = {}
    for backend in ("auto", "einsum"):
        model = build(cfg, PEFTConfig(n=64, kernel_backend=backend))
        state, frozen = ts.init_state(model, tcfg, 0, cuda_device)
        step = ts.make_train_step(model, tcfg)
        fdk.launches = fdk.dc_launches = 0
        losses[backend] = []
        for i in range(3):
            state, m = step(state, frozen, {
                k: v.to(cuda_device) for k, v in data.batch_at(i).items()})
            losses[backend].append(float(m["loss"]))
        expected = 3 * 2 * 2 if backend == "auto" else 0
        assert fdk.launches == fdk.dc_launches == expected
        assert int(state["anomalies"]) == 0
    np.testing.assert_allclose(losses["auto"], losses["einsum"], atol=1e-4)


def _pages(seed, device, dtype, B=4, H=32, K=4, dh=128, ps=16, n_pages=40,
           pps=8):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device=device, dtype=dtype)

    bt = torch.from_numpy(rng.permutation(n_pages)[:B * pps].reshape(
        B, pps).astype(np.int32)).to(device)
    kv_len = torch.from_numpy(rng.integers(1, pps * ps + 1, size=(B,)).astype(
        np.int32)).to(device)
    return t(B, 1, H, dh), t(n_pages, ps, K, dh), t(n_pages, ps, K, dh), \
        bt, kv_len


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("dh", [64, 128])
def test_paged_attention_kernel_matches_plain(cuda_device, dtype, tol, dh):
    q, kp, vp, bt, kv_len = _pages(5, cuda_device, dtype, dh=dh)
    kv_len[0] = 1
    kv_len[1] = bt.shape[1] * kp.shape[1]
    before = pa.launches
    out = pa.paged_attention(q, kp, vp, bt, kv_len)
    assert pa.launches == before + 1 and out.dtype == dtype
    ref = pa.paged_attention_reference(q, kp, vp, bt, kv_len)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=tol, rtol=tol)


def test_paged_attention_fully_masked_row_is_zero(cuda_device):
    q, kp, vp, bt, kv_len = _pages(6, cuda_device, torch.float32)
    kv_len[2] = 0
    out = pa.paged_attention(q, kp, vp, bt, kv_len)
    assert torch.isfinite(out).all()
    assert bool((out[2] == 0).all())


def test_served_slice_runs_both_kernels(cuda_device):
    """A reduced yi-6b (head_dim 128) served through the scheduler: the
    merge launches the ΔW kernel, every decode layer the attention kernel,
    and the streams equal the plain versions' (f32)."""
    cfg = configs.reduced(configs.get("yi-6b"), width=512).replace(
        vocab=64, param_dtype="float32", dtype="float32")
    peft = PEFTConfig(n=64)
    params = build(cfg, peft).init(0, cuda_device)
    prompts = [torch.arange(5 + i, dtype=torch.int32) % 64 for i in range(4)]
    outs = {}
    for backend in ("auto", "einsum"):
        fdk.launches = pa.launches = 0
        engine = Engine(build(cfg, peft.replace(kernel_backend=backend)),
                        params, batch_slots=2, max_len=32, device=cuda_device)
        sched = ContinuousScheduler(engine, page_size=8)
        reqs = [Request(prompt=p, max_new=3 + i) for i, p in enumerate(prompts)]
        sched.serve(reqs, [0.0, 1.0, 2.0, 3.0])
        outs[backend] = [r.out for r in reqs]
        if backend == "auto":
            assert fdk.launches == 2
            assert pa.launches == sched.metrics.steps * cfg.num_layers
        else:
            assert fdk.launches == pa.launches == 0
    assert outs["auto"] == outs["einsum"]


def test_eos_flag_reads_back_asynchronously(cuda_device):
    from repro_torch.serve.scheduler.runtime import _HostFlag
    flag = torch.zeros(4, dtype=torch.bool, device=cuda_device)
    assert not _HostFlag(flag).ready_any()
    flag[2] = True
    assert _HostFlag(flag).ready_any()
