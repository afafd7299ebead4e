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
from repro_torch.kernels import fft_plan as fp
from repro_torch.kernels import fourier_deltaw as fdk
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import build
from repro_torch.serve import (ContinuousScheduler, Engine, NGramDrafter,
                               Request, SelfDrafter)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# K1/K2 and K4/K5 shapes: the slices' yi-6b wv and wq, small ragged ones,
# qwen3-4b wq (2560x4096), qwen2.5-32b wv (5120x1024) and wq (5120x5120,
# radix 5), yi-6b's MLP (4096x11008, radix 43) and the largest site,
# qwen2.5-32b's MLP (5120x27648, one unpadded row per block)
FOURIER_SHAPES = [(4096, 512, 1000, 2), (300, 520, 37, 1), (512, 96, 64, 3),
                  (130, 7, 5, 1), (4096, 4096, 1000, 2),
                  (2560, 4096, 1000, 2), (5120, 1024, 1000, 2),
                  (5120, 5120, 1000, 1), (4096, 11008, 1000, 1),
                  (5120, 27648, 1000, 1)]


@pytest.mark.parametrize("d1,d2,n,L", FOURIER_SHAPES)
def test_deltaw_kernel_matches_plain(cuda_device, d1, d2, n, L):
    """K1 against its plain version at atol 2e-4, one launch through the
    Function, and the same bits on a second launch (entries summed in the
    stable sort's order, no float atomics)."""
    E = fourierft.sample_entries(d1, d2, n, seed=7).to(cuda_device)
    c = torch.from_numpy(np.random.default_rng(8).normal(
        size=(L, n)).astype(np.float32)).to(cuda_device)
    before = fdk.launches
    out = ops.fourier_deltaw_forward(c, E, d1, d2, 300.0)
    assert fdk.launches == before + 1
    assert torch.equal(ops.fourier_deltaw_forward(c, E, d1, d2, 300.0), out)
    plain = fourierft.materialize_delta(c, E, d1, d2, 300.0)
    np.testing.assert_allclose(out.cpu().numpy(), plain.cpu().numpy(),
                               atol=2e-4)


@pytest.mark.parametrize("d1,d2,n", [(64, 58114, 16), (64, 29057, 16),
                                     (64, 67 * 8, 16), (65536, 64, 16)])
def test_fourier_kernels_raise_beyond_their_limits(cuda_device, d1, d2, n):
    """A shape the FFT-structured kernels cannot take (d2 > 58112, an odd
    d2 past one block's 29056 columns, an odd prime factor above 63,
    d1 > 65535) raises naming the limit; nothing falls back to the plain
    version on the card."""
    u = torch.zeros((n,), dtype=torch.int32, device=cuda_device)
    c = torch.zeros((1, n), dtype=torch.float32, device=cuda_device)
    before = (fdk.launches, fdk.dc_launches)
    with pytest.raises(ValueError, match="58112|even|63|65535"):
        fdk.deltaw(c, u, u, d1, d2, 1.0)
    if d1 * d2 <= 2 ** 22:
        g = torch.zeros((1, d1, d2), dtype=torch.float32, device=cuda_device)
        with pytest.raises(ValueError, match="58112|even|63|65535"):
            fdk.dc(g, u, u, d1, d2, 1.0)
    assert (fdk.launches, fdk.dc_launches) == before


@pytest.mark.parametrize("d1,d2,n,L", FOURIER_SHAPES)
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


@pytest.mark.parametrize("d1,d2,n,L", FOURIER_SHAPES)
def test_dct_deltaw_kernel_matches_plain(cuda_device, d1, d2, n, L):
    """K4 against its plain version at atol 2e-5 / rtol 1e-5 (the JAX
    suite's site_delta tolerance), through the padding harness, at K1's
    shapes (radices 5 and 43, the one-unpadded-row-per-block 27648), and
    the same bits on a second launch (K1's collision-free scatter rounds,
    no float atomics)."""
    E = fourierft.sample_entries(d1, d2, n, seed=7).to(cuda_device)
    c = torch.from_numpy(np.random.default_rng(8).normal(
        size=(L, n)).astype(np.float32)).to(cuda_device)
    before = ddk.launches
    out = ops.dct_deltaw_forward(c, E, d1, d2, 300.0)
    assert ddk.launches == before + 1
    assert torch.equal(ops.dct_deltaw_forward(c, E, d1, d2, 300.0), out)
    plain = dct_delta(c, E, d1, d2, 300.0)
    np.testing.assert_allclose(out.cpu().numpy(), plain.cpu().numpy(),
                               atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("d1,d2", [(96, 160), (130, 7), (40, 24)])
def test_dct_kernels_take_any_integer_entry(cuda_device, d1, d2):
    """Entries at v = 0, at one column several times, at v ≡ d2 (mod 2d2)
    (a cosine that is 0 at every k), negative and past 4d: K4 and K5 fold
    them exactly as the plain versions' int64 phase does, within K4's and
    K5's tolerances."""
    rng = np.random.default_rng(3)
    v = np.array([0, 0, 5, 5, 5, d2, -3, 2 * d2 + 1, 3 * d2 + 7, 4 * d2 - 1,
                  2 * d2, d2 + 1, 7, 7, 0, 11], np.int32)
    u = np.array([0, 3, -1, 4 * d1 + 5, 7, 2, 8, 9, 10, 11, 12, 13, 14, 15,
                  16, 2 * d1], np.int32)
    u = torch.from_numpy(u).to(cuda_device)
    v = torch.from_numpy(v).to(cuda_device)
    c = torch.from_numpy(rng.normal(size=(2, 16)).astype(np.float32)).to(
        cuda_device)
    g = torch.from_numpy(rng.normal(size=(2, d1, d2)).astype(
        np.float32)).to(cuda_device)
    np.testing.assert_allclose(
        ddk.deltaw(c, u, v, d1, d2, 300.0).cpu().numpy(),
        ddk.deltaw_reference(c, u, v, d1, d2, 300.0).cpu().numpy(),
        atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(
        ddk.dc(g, u, v, d1, d2, 300.0).cpu().numpy(),
        ddk.dc_reference(g, u, v, d1, d2, 300.0).cpu().numpy(),
        atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("d1,d2,n", [(64, 58114, 16), (64, 29057, 16),
                                     (64, 67 * 8, 16), (65536, 64, 16),
                                     (64, 64, 16400)])
def test_dct_kernels_raise_beyond_their_limits(cuda_device, d1, d2, n):
    """K4 and K5 take the FFT kernels' plan: a CUDA tensor beyond its limits
    (d2 > 58112, an odd d2 past 29056, an odd prime factor above 63,
    d1 > 65535, and for K4 n > 16384) raises naming the limit and launches
    nothing; nothing falls back to the plain version on the card."""
    u = torch.zeros((n,), dtype=torch.int32, device=cuda_device)
    c = torch.zeros((1, n), dtype=torch.float32, device=cuda_device)
    before = (ddk.launches, ddk.dc_launches)
    with pytest.raises(ValueError, match="58112|even|63|65535|16384"):
        ddk.deltaw(c, u, u, d1, d2, 1.0)
    if d1 * d2 <= 2 ** 22 and n <= 16384:
        g = torch.zeros((1, d1, d2), dtype=torch.float32, device=cuda_device)
        with pytest.raises(ValueError, match="58112|even|63|65535"):
            ddk.dc(g, u, u, d1, d2, 1.0)
    assert (ddk.launches, ddk.dc_launches) == before


@pytest.mark.parametrize("d1,d2,n,L", FOURIER_SHAPES)
def test_dct_dc_kernel_matches_plain(cuda_device, d1, d2, n, L):
    """K5 against its plain version at atol 1e-4 / rtol 1e-3 (the JAX
    suite's gradient tolerance) at K1's shapes, bit-identical on a second
    launch, and
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
           pps=8, W=1):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device=device, dtype=dtype)

    bt = torch.from_numpy(rng.permutation(n_pages)[:B * pps].reshape(
        B, pps).astype(np.int32)).to(device)
    kv_len = torch.from_numpy(rng.integers(
        1, pps * ps - W + 2, size=(B,)).astype(np.int32)).to(device)
    return t(B, W, H, dh), t(n_pages, ps, K, dh), t(n_pages, ps, K, dh), \
        bt, kv_len


def _plain32(q, kp, vp, bt, kv_len):
    """The plain version in f32 on the kernel's inputs (upcast)."""
    return pa.paged_attention_reference(q.float(), kp.float(), vp.float(), bt,
                                        kv_len)


def _k3_close(out, ref, tol):
    """|out - ref| within `pa.agreement_limit` (f32 atol = rtol = tol; bf16
    tol of each output vector's largest |value|), ref from `_plain32`."""
    assert tol == pa.TOLERANCE[out.dtype]
    diff = (out.float() - ref).abs()
    lim = pa.agreement_limit(ref, out.dtype)
    assert bool((diff <= lim).all()), \
        f"max |diff| {float(diff.max()):.3e}, worst diff/limit " \
        f"{float((diff / lim).max()):.3f}"


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("dh", [16, 64, 80, 112, 128, 256])
@pytest.mark.parametrize("W", [1, 5])
def test_paged_attention_kernel_matches_plain(cuda_device, dtype, tol, dh,
                                              W):
    """K3 against its plain version at every head class (16 from
    configs.reduced, 80 and 112 padded to 16 in shared memory), W 1 and 5,
    kv_len 1 and the full window, one launch each."""
    q, kp, vp, bt, kv_len = _pages(5, cuda_device, dtype, dh=dh, W=W)
    kv_len[0] = 1
    kv_len[1] = bt.shape[1] * kp.shape[1] - W + 1
    before = pa.launches
    out = pa.paged_attention(q, kp, vp, bt, kv_len)
    assert pa.launches == before + 1 and out.dtype == dtype
    _k3_close(out, _plain32(q, kp, vp, bt, kv_len), tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("W,pps", [(1, 64), (1, 256), (5, 256)])
def test_paged_attention_splits_long_contexts(cuda_device, dtype, tol, W,
                                              pps):
    """kv_len up to 4096 (256 pages of 16): the plan splits the pages
    (S > 1, a combine), ragged slots (one at kv_len 1, one whose later
    splits never run) agree with the plain version, and a second launch
    gives the same bits (fixed-order combine, no atomics)."""
    B = 8
    q, kp, vp, bt, kv_len = _pages(7, cuda_device, dtype, B=B, pps=pps,
                                   n_pages=B * pps + 4, W=W)
    plan = pa.launch_plan(q, kp, vp, bt, kv_len)
    assert plan.splits > 1
    kv_len[0] = 1
    kv_len[1] = pps * 16 - W + 1
    kv_len[2] = plan.pages_per_split * 16 + 3
    out = pa.paged_attention(q, kp, vp, bt, kv_len)
    assert torch.equal(pa.paged_attention(q, kp, vp, bt, kv_len), out)
    _k3_close(out, _plain32(q, kp, vp, bt, kv_len), tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_combine_takes_odd_row_counts(cuda_device, dtype):
    """B 3, H = K = 3, W 1 and 3 splits (384 key rows, MIN_SPLIT_KEYS 128
    each): splits·B·W·H (27) is odd, so the workspace's (max, denominator)
    part is padded for the accumulators after it to start 16-byte aligned
    (the combine reads them as float4 at dh 64)."""
    q, kp, vp, bt, kv_len = _pages(8, cuda_device, dtype, B=3, H=3, K=3,
                                   dh=64, n_pages=76, pps=24)
    kv_len.copy_(torch.tensor([384, 200, 300], dtype=torch.int32))
    assert pa.launch_plan(q, kp, vp, bt, kv_len).splits == 3
    out = pa.paged_attention(q, kp, vp, bt, kv_len)
    assert torch.equal(pa.paged_attention(q, kp, vp, bt, kv_len), out)
    _k3_close(out, _plain32(q, kp, vp, bt, kv_len), pa.TOLERANCE[dtype])


@pytest.mark.parametrize("pps", [8, 256])
def test_paged_attention_fully_masked_row_is_zero(cuda_device, pps):
    """kv_len 0 gives 0, not NaN: with one split, and with every split of
    the row empty (pps 256 splits the pages)."""
    q, kp, vp, bt, kv_len = _pages(6, cuda_device, torch.float32, pps=pps,
                                   n_pages=4 * pps + 4)
    kv_len[2] = 0
    out = pa.paged_attention(q, kp, vp, bt, kv_len)
    assert torch.isfinite(out).all()
    assert bool((out[2] == 0).all())
    keep = [0, 1, 3]
    _k3_close(out[keep], _plain32(q, kp, vp, bt, kv_len)[keep], 1e-5)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_paged_attention_kernel_refuses_other_dtypes(cuda_device, dtype):
    q, kp, vp, bt, kv_len = _pages(6, cuda_device, dtype, dh=64)
    before = pa.launches
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pa.paged_attention(q, kp, vp, bt, kv_len)
    assert pa.launches == before


def test_reduced_model_serves_through_the_kernel(cuda_device):
    """The default configs.reduced(yi-6b) (head_dim 16, which K3 once
    refused) served through ContinuousScheduler on the card: K3 launched
    every decode step and layer, streams equal the einsum backend's (f32)."""
    cfg = configs.reduced(configs.get("yi-6b")).replace(
        param_dtype="float32", dtype="float32")
    assert cfg.head_dim == 16
    peft = PEFTConfig(n=32)
    params = build(cfg, peft).init(0, cuda_device)
    prompts = [torch.arange(3 + i, dtype=torch.int32) % cfg.vocab
               for i in range(5)]
    outs = {}
    for backend in ("auto", "einsum"):
        pa.launches = 0
        engine = Engine(build(cfg, peft.replace(kernel_backend=backend)),
                        params, batch_slots=3, max_len=48, device=cuda_device)
        sched = ContinuousScheduler(engine, page_size=8)
        reqs = [Request(prompt=p, max_new=4 + i) for i, p in enumerate(prompts)]
        sched.serve(reqs, [0.0, 0.0, 1.0, 2.0, 3.0])
        outs[backend] = [r.out for r in reqs]
        expected = sched.metrics.steps * cfg.num_layers
        assert pa.launches == (expected if backend == "auto" else 0)
    assert outs["auto"] == outs["einsum"]


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
        reqs = [Request(prompt=p, max_new=3 + i)
                for i, p in enumerate(prompts)]
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


@pytest.mark.parametrize("d1,d2", [(4096, 4096), (4096, 512), (300, 520)])
def test_fourier_bank_apply_matches_x_at_k1_delta(cuda_device, d1, d2):
    """The FourierFT bank apply (cached f32 bases, einsum) against x @ ΔW
    with ΔW from K1 for the same coefficients, per request row, within
    atol 1e-6 / rtol 5e-4 (the JAX suite's factored tolerance) scaled by
    the output's largest |value| as chip_smoke does."""
    from repro_torch.core import adapter as adapter_api
    m = adapter_api.resolve("fourierft")
    peft = PEFTConfig(method="fourierft", n=1000 if d1 > 1000 else 64,
                      alpha=300.0)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    entries = fourierft.sample_entries(d1, d2, peft.n, seed=7).to(cuda_device)
    aux = {"entries": entries}
    aux.update(m.frozen_tables(aux, d1, d2))
    B = 4
    c = torch.randn((B, peft.n), generator=gen, device=cuda_device)
    x = torch.randn((B, 1, d1), generator=gen, device=cuda_device)
    before = fdk.launches
    y = m.bank_apply(x, {"c": c}, aux, d1, d2, peft)
    dw = ops.fourier_deltaw_forward(c, entries, d1, d2, peft.alpha)
    assert fdk.launches == before + 1
    ref = torch.matmul(x, dw)
    scale = float(ref.abs().max())
    assert torch.allclose(y, ref, atol=1e-6 * scale, rtol=5e-4)


def test_bank_scheduler_launches_k3_every_decode_layer(cuda_device, tmp_path):
    """A bank of three methods over a reduced base, served by the
    continuous scheduler on the card: K3 launches decode steps x layers,
    and every request's first token equals the serial bank engine's (f32;
    later tokens go through K3 on one side and the dense cache on the
    other, so only the first is held bitwise)."""
    from repro_torch.checkpoint import adapters as adapter_ckpt
    from repro_torch.core import peft as peft_mod
    from repro_torch.serve import AdapterBank
    cfg = configs.reduced(configs.get("yi-6b"), width=512).replace(
        vocab=64, param_dtype="float32", dtype="float32")
    model = build(cfg, PEFTConfig(method="none"))
    params = model.init(0, cuda_device)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(1)
    profiles = {"fourierft": PEFTConfig(method="fourierft", n=64),
                "lora": PEFTConfig(method="lora", lora_r=4),
                "circulant": PEFTConfig(method="circulant")}
    for m, prof in profiles.items():
        tree = peft_mod.init_adapters(gen, model.sites, prof, cuda_device)
        tree = {s: {k: torch.randn(v.shape, generator=gen,
                                   device=cuda_device)
                    if v.is_floating_point() else v for k, v in d.items()}
                for s, d in tree.items()}
        adapter_ckpt.export_adapter(str(tmp_path), f"t-{m}", tree, prof)
    bank = AdapterBank(model, profiles, capacity=2,
                       checkpoint_dir=str(tmp_path), device=cuda_device)
    engine = Engine(model, params, batch_slots=3, max_len=32, bank=bank,
                    device=cuda_device)
    ids = ["t-fourierft", "t-lora", "t-circulant", None, "t-fourierft"]
    reqs = [Request(prompt=torch.arange(4 + i, dtype=torch.int32) % 64,
                    max_new=3 + i, adapter_id=a) for i, a in enumerate(ids)]
    pa.launches = 0
    sched = ContinuousScheduler(engine, page_size=8)
    sched.serve(reqs, [0.0, 0.0, 1.0, 2.0, 3.0])
    assert pa.launches == sched.metrics.steps * cfg.num_layers
    for r in reqs:
        if r.adapter_id is not None \
                and r.adapter_id not in bank.resident_ids:
            bank.load_from_checkpoint(r.adapter_id)
        ref = engine.generate([r.prompt], max_new=r.max_new,
                              adapter_ids=[r.adapter_id])[0].tolist()
        assert len(r.out) == r.max_new and r.out[0] == ref[0]


def _window_model(device, dtype):
    """A reduced yi-6b (head_dim 128) in `dtype` on `device`, its params
    seeded, and the same model on the plain attention (einsum backend)."""
    name = "float32" if dtype == torch.float32 else "bfloat16"
    cfg = configs.reduced(configs.get("yi-6b"), width=512).replace(
        vocab=64, param_dtype=name, dtype=name)
    peft = PEFTConfig(method="none")
    return (cfg, build(cfg, peft), build(cfg, peft.replace(
        kernel_backend="einsum")), build(cfg, peft).init(0, device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W", [4, 5])
def test_verify_step_through_k3_matches_plain(cuda_device, dtype, W):
    """verify_logits on a paged cache of seeded K/V — one slot inside its
    pages, one past its owned pages, one past the block table — through K3
    (one launch per layer, all at W rows) against the plain paged
    attention on the same inputs: f32 logits within atol = rtol = 1e-4 and
    the same tokens; bf16 logits within 5e-2 of each row's largest
    |logit| (K3's bf16 limit is 2e-2 of an output's largest |value| per
    layer); the window's first layer K/V rows bitwise equal (the writes
    are the same plain indexing on both sides)."""
    cfg, kmodel, pmodel, params = _window_model(cuda_device, dtype)
    B, ps, pps = 3, 16, 4
    n_pages = B + B * pps
    rng = np.random.default_rng(9)
    shape = (cfg.num_layers, n_pages, ps, cfg.n_kv, cfg.head_dim)
    pools = {k: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
             .to(cuda_device, dtype) for k in ("pk", "pv")}
    bt = B + torch.arange(B * pps, dtype=torch.int32).reshape(B, pps)
    bt[1, 2:] = 1
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, 64, size=(B, W)).astype(np.int32)).to(cuda_device),
        "block_table": bt.to(cuda_device),
        "scratch_pages": torch.arange(B, dtype=torch.int32,
                                      device=cuda_device)}
    pos = torch.tensor([7, 30, pps * ps - 2], dtype=torch.int32,
                       device=cuda_device)
    outs = {}
    for label, model in (("k3", kmodel), ("plain", pmodel)):
        cache = {k: v.clone() for k, v in pools.items()}
        cache["pos"] = pos.clone()
        before = (pa.launches, pa.launches_by_w.get(W, 0))
        outs[label] = model.verify_logits(params, cache, batch)
        torch.cuda.synchronize()
        launched = (pa.launches - before[0],
                    pa.launches_by_w.get(W, 0) - before[1])
        assert launched == ((cfg.num_layers, cfg.num_layers)
                            if label == "k3" else (0, 0))
    (lk, ck), (lp, cp) = outs["k3"], outs["plain"]
    assert lk.shape == (B, W, cfg.vocab)
    assert torch.equal(ck["pos"], pos)
    lk, lp = lk.float(), lp.float()
    if dtype == torch.float32:
        assert torch.allclose(lk, lp, atol=1e-4, rtol=1e-4)
        assert torch.equal(lk.argmax(-1), lp.argmax(-1))
    else:
        lim = 5e-2 * lp.abs().amax(-1, keepdim=True)
        assert bool(((lk - lp).abs() <= lim).all())
    for key in ("pk", "pv"):
        assert torch.equal(ck[key][0], cp[key][0])


@pytest.mark.parametrize("drafter,paged", [("self", True), ("ngram", True),
                                           ("self", False)])
def test_spec_serving_launches_k3_by_window(cuda_device, drafter, paged):
    """Speculative serving of a reduced yi-6b on the card (f32, k = 3):
    streams equal the plain scheduler's; K3 launches layers x verify steps
    at W = 4, and layers x verify steps x 3 at W = 1 for the self-drafter's
    probes (none for the n-gram drafter); the dense cache launches no K3."""
    cfg, model, _, params = _window_model(cuda_device, torch.float32)
    engine = Engine(model, params, batch_slots=3, max_len=40,
                    device=cuda_device)
    prompts = [torch.arange(4 + i, dtype=torch.int32) % 64 for i in range(5)]

    def trace():
        return [Request(prompt=p, max_new=4 + 2 * i)
                for i, p in enumerate(prompts)]
    base = trace()
    ContinuousScheduler(engine, page_size=8).serve(base, [0, 0, 1, 2, 3])
    pa.launches, pa.launches_by_w = 0, {}
    spec = trace()
    sched = ContinuousScheduler(
        engine, paged=paged, page_size=8,
        drafter=SelfDrafter(k=3) if drafter == "self" else NGramDrafter(k=3))
    sched.serve(spec, [0, 0, 1, 2, 3])
    assert [r.out for r in spec] == [r.out for r in base]
    steps, L = sched.metrics.steps, cfg.num_layers
    expected = {}
    if paged:
        expected[4] = L * steps
        if drafter == "self":
            expected[1] = L * steps * 3
    assert pa.launches_by_w == expected
    assert pa.launches == sum(expected.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pps", [8, 256])
@pytest.mark.parametrize("H,dh", [(32, 128), (16, 64)])
def test_paged_attention_at_group_size_one(cuda_device, dtype, H, dh, pps):
    """K3 at G = 1 (no GQA: each kv-head has one query row per window row)
    at LLaMA2-7B's (H = K = 32, dh 128) and GPT-2-medium's (H = K = 16,
    dh 64) geometry, B 8, short and 4096-long contexts: agrees with the
    plain version and gives the same bits on a second launch."""
    B = 8
    q, kp, vp, bt, kv_len = _pages(11, cuda_device, dtype, B=B, H=H, K=H,
                                   dh=dh, pps=pps, n_pages=B * pps + 4)
    assert pa.row_groups(H, H, 1, dtype == torch.bfloat16) == (1, 1)
    kv_len[0] = 1
    kv_len[1] = pps * 16
    out = pa.paged_attention(q, kp, vp, bt, kv_len)
    assert torch.equal(pa.paged_attention(q, kp, vp, bt, kv_len), out)
    _k3_close(out, _plain32(q, kp, vp, bt, kv_len), pa.TOLERANCE[dtype])


@pytest.mark.parametrize("kind", ["random", "orthogonal"])
@pytest.mark.parametrize("d,n,L", [(768, 768, 12), (4096, 1000, 2)])
def test_basis_deltaw_route_matches_plain(cuda_device, kind, d, n, L):
    """A random/orthogonal-basis site on the card resolves to the
    torch.matmul route (no hand-written kernel: K1 does not launch), equals
    the same product in float64 on the same card tensors at the registry
    tolerance (atol 2e-5 / rtol 1e-4), and hands c its gradient."""
    from repro_torch.core import adapter as adapter_api
    from repro_torch.core import basis as basis_mod
    from repro_torch.core.adapter import AdapterSite
    from repro_torch.kernels import api
    m = adapter_api.resolve("fourierft")
    site = AdapterSite("layers/wq", d, d, L)
    peft = PEFTConfig(basis=kind, n=n, alpha=300.0)
    ad = m.init_site(torch.Generator(device=cuda_device).manual_seed(0),
                     site, peft, cuda_device)
    op = api.resolve_op("deltaw", m, peft, d, d, device=cuda_device)
    assert op.fn is adapter_api._basis_deltaw_matmul
    c = ad["c"].detach().clone().float().requires_grad_(True)
    before = fdk.launches
    dw = m.site_delta({**ad, "c": c}, site, peft)
    assert fdk.launches == before
    plain = basis_mod.materialize_delta_basis(
        ad["c"].double(), ad["b1"].double(), ad["b2"].double(), kind, 300.0)
    np.testing.assert_allclose(dw.detach().cpu().numpy(),
                               plain.cpu().numpy(), atol=2e-5, rtol=1e-4)
    torch.sum(dw * dw).backward()
    assert c.grad is not None and bool(torch.isfinite(c.grad).all())


def test_full_step_on_the_card(cuda_device):
    """The `full` method on a reduced GPT-2-medium (non-gated GELU, no
    RoPE) on the card: the loss and every base leaf's gradient equal the
    CPU's (atol 1e-5), and one step moves every base leaf and launches no
    ΔW kernel."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.train import step as ts
    from repro_torch.tree import tree_leaves, tree_map
    cfg = configs.reduced(configs.get("gpt2-medium")).replace(
        vocab=64, param_dtype="float32", dtype="float32")
    model = build(cfg, PEFTConfig(method="full"))
    params = model.init(0, "cpu")
    batch = SyntheticLM(vocab=64, batch=4, seq=16).batch_at(0)
    out = {}
    for dev in ("cpu", cuda_device):
        trainable, frozen = ts.split_params(
            model, tree_map(lambda t: t.to(dev), params))
        loss, g = ts._value_and_grad(ts._loss_for(model), trainable, frozen,
                                     {k: v.to(dev) for k, v in batch.items()})
        out[str(dev)] = (float(loss), [t.cpu() for t in tree_leaves(g)])
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], abs=1e-5)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    state, frozen = ts.state_from_params(
        model, tree_map(lambda t: t.to(cuda_device), params))
    before = (fdk.launches, fdk.dc_launches, ddk.launches)
    state, m = ts.make_train_step(model, TrainConfig(total_steps=1))(
        state, frozen, {k: v.to(cuda_device) for k, v in batch.items()})
    assert (fdk.launches, fdk.dc_launches, ddk.launches) == before
    assert float(m["loss"]) == pytest.approx(out["cpu"][0], abs=1e-5)
    for a, a0 in zip(tree_leaves(state["trainable"]["base"]),
                     tree_leaves(params["base"])):
        assert not torch.equal(a.cpu(), a0)


def test_factored_step_on_the_card(cuda_device):
    """One factored step of a reduced yi-6b (width 512) on the card
    launches neither K1 nor K2, and its gradient w.r.t. c equals the
    merged step's (through K1/K2) within 1e-4 of the gradient's own size
    (norm-relative, and each entry against max |g|)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.train import step as ts
    cfg = configs.reduced(configs.get("yi-6b"), width=512).replace(
        vocab=64, param_dtype="float32", dtype="float32")
    peft = PEFTConfig(n=64, alpha=300.0, strategy="factored")
    model = build(cfg, peft)
    merged = build(cfg, peft.replace(strategy="merged"))
    params = model.init(0, cuda_device)
    batch = {k: v.to(cuda_device) for k, v in
             SyntheticLM(vocab=64, batch=4, seq=16).batch_at(0).items()}
    grads = {}
    for name, m in (("factored", model), ("merged", merged)):
        trainable, frozen = ts.split_params(m, params)
        before = (fdk.launches, fdk.dc_launches)
        _, g = ts._value_and_grad(ts._loss_for(m), trainable, frozen, batch)
        launched = (fdk.launches - before[0], fdk.dc_launches - before[1])
        assert launched == ((0, 0) if name == "factored" else (2, 2))
        grads[name] = torch.cat([g["peft"][s]["c"].flatten()
                                 for s in ("layers/wq", "layers/wv")])
    g = grads["merged"]
    diff = (grads["factored"] - g).abs()
    assert float(g.norm()) > 0
    assert float(diff.norm() / g.norm()) <= 1e-4
    assert float(diff.max()) <= 1e-4 * float(g.abs().max())
    state, frozen = ts.state_from_params(model, params)
    before = (fdk.launches, fdk.dc_launches)
    state, m = ts.make_train_step(model, TrainConfig(total_steps=1))(
        state, frozen, batch)
    assert (fdk.launches, fdk.dc_launches) == before
    assert np.isfinite(float(m["loss"]))


# ---- tiering: pinned host tiers and the side stream -------------------------
def _tiered(device, **tiering):
    """A reduced yi-6b (head_dim 128, f32) scheduler on `device` with a
    TieringConfig, 3 slots, page 8, a pool of 9 pages (two long requests
    own it)."""
    from repro_torch.serve import TieringConfig
    cfg = configs.reduced(configs.get("yi-6b"), width=512).replace(
        vocab=64, param_dtype="float32", dtype="float32")
    model = build(cfg, PEFTConfig(method="none"))
    engine = Engine(model, model.init(0, device), batch_slots=3, max_len=48,
                    device=device)
    return cfg, ContinuousScheduler(engine, page_size=8, n_pages=9,
                                    tiering=TieringConfig(**tiering))


def test_pinned_spill_fill_round_trip_bitwise(cuda_device):
    """Pages gathered, copied to pinned host memory on the side stream, a
    decode step queued that overwrites those very pages before the copy is
    waited on, then restored into other pages: the host copy is pinned,
    and host copy and restored pages are bitwise the pages as gathered."""
    cfg, sched = _tiered(cuda_device, mode="swap", host_kv_pages=16)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(4)
    for key in ("pk", "pv"):
        sched.cache[key].copy_(torch.randn(sched.cache[key].shape,
                                           generator=gen, device=cuda_device))
    idx = np.array([3, 4], np.int64)
    before = {key: sched.cache[key][:, idx].clone() for key in ("pk", "pv")}
    assert sched.host_kv.put_snapshot(7, *sched._spill_pages(idx), 2)
    # slot 0 writes its next row into page 3 (pos 0, block-table row [3, 4,
    # ..]); the gather was queued first, so the copy reads the old rows
    bt = torch.full((3, 6), 0, dtype=torch.int32, device=cuda_device)
    bt[0, :2] = torch.tensor([3, 4])
    batch = {"tokens": torch.ones((3, 1), dtype=torch.int32,
                                  device=cuda_device),
             "block_table": bt, "scratch_pages": torch.arange(
                 3, dtype=torch.int32, device=cuda_device)}
    with torch.no_grad():
        sched.model.decode_step(sched.engine.params, sched.cache, batch)
    assert not torch.equal(sched.cache["pk"][:, idx], before["pk"])
    sched.host_kv.settle()
    k, v, n = sched.host_kv.pop_snapshot(7)
    assert n == 2 and k.is_pinned() and v.is_pinned()
    assert torch.equal(k, before["pk"].cpu())
    assert torch.equal(v, before["pv"].cpu())
    dst = np.array([5, 6], np.int64)
    sched._fill_pages(k, v, dst)
    torch.cuda.synchronize()
    assert torch.equal(sched.cache["pk"][:, dst], before["pk"])
    assert torch.equal(sched.cache["pv"][:, dst], before["pv"])


def test_bank_host_spill_not_zeroed_by_the_clear(cuda_device):
    """An evicted tenant's rows reach the host tier as they were, not as
    the zeros `_clear_group_slot` writes into the slot right after the
    spill (the bank clones each row on the compute stream first), and
    reload bitwise."""
    from repro_torch.core import peft as peft_mod
    from repro_torch.serve import AdapterBank
    from repro_torch.serve.tiering import HostAdapterTier
    cfg = configs.reduced(configs.get("yi-6b"), width=512).replace(
        vocab=64, param_dtype="float32", dtype="float32")
    model = build(cfg, PEFTConfig(method="none"))
    prof = PEFTConfig(method="lora", lora_r=4)
    bank = AdapterBank(model, {"lora": prof}, capacity=1, device=cuda_device)
    bank.host_tier = HostAdapterTier(2, stream=torch.cuda.Stream(cuda_device))
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(2)
    trees = {}
    for tid in ("a", "b"):
        tree = peft_mod.init_adapters(gen, model.sites, prof, cuda_device)
        trees[tid] = {s: {k: torch.randn(v.shape, generator=gen,
                                         device=cuda_device)
                          for k, v in d.items()} for s, d in tree.items()}
        bank.load(tid, trees[tid], prof)            # "b" evicts "a"
    bank.host_tier.settle()
    _, host = bank.host_tier.get("a")
    for site, leaves in trees["a"].items():
        for leaf, v in leaves.items():
            assert host[site][leaf].is_pinned()
            assert torch.equal(host[site][leaf], v.cpu()), (site, leaf)
    slot = bank.load_from_host("a")
    for site, leaves in trees["a"].items():
        for leaf, v in leaves.items():
            assert torch.equal(bank.params["lora"]["sites"][site][leaf][slot],
                               v)


def test_cancel_frees_pages_while_a_spill_is_in_flight(cuda_device):
    """A swap preemption's copy to the host is left unsettled while its
    request is cancelled from the queue: the snapshot is dropped, the
    victim's pages are already free (they were freed right after the
    gather), the trace drains leak-free, and the other streams are the
    untiered run's."""
    cfg, sched = _tiered(cuda_device, mode="swap", host_kv_pages=32)
    rows = [([1, 2, 3, 4, 5], 20, "batch"), ([7, 8, 9], 18, "batch"),
            ([11, 12], 4, "interactive")]

    def reqs():
        return [Request(prompt=torch.tensor(p, dtype=torch.int32),
                        max_new=n, priority=pr) for p, n, pr in rows]

    plain = reqs()
    ContinuousScheduler(sched.engine, page_size=8).serve(plain,
                                                         [0.0, 0.0, 3.0])
    real_settle = sched.host_kv.settle
    sched.host_kv.settle = lambda: None
    tiered = reqs()
    for r, at in zip(tiered, (0.0, 0.0, 3.0)):
        sched.submit(r, arrival=at)
    victim = None
    for _ in range(40):
        victim = next((ev[1] for ev in sched.tick() if ev[0] == "preempt"),
                      None)
        if victim is not None:
            break
    assert victim is not None and sched.host_kv.has_snapshot(victim)
    assert sched.cancel(victim)
    assert not sched.host_kv.has_snapshot(victim)
    for _ in sched.events():
        pass
    real_settle()
    torch.cuda.synchronize()
    sched.pager.assert_no_leaks()
    for i, (r, p) in enumerate(zip(tiered, plain)):
        if i != victim:
            assert r.out == p.out, i


# ---------------------------------------------------------------------------
# Long sequences and the other transformer families
# rows past one block's 29056 columns, on a cluster of two blocks:
# qwen2-vl-72b's 29568, padded halves (30720, 32400 with radices 3 and 5,
# 46080) and the unpadded halves of 57344 (shift 30); small d1
CLUSTER_WIDTHS = [29568, 30720, 32400, 46080, 57344]
REL_TO_PLAIN = 1e-5     # chip_smoke's: of the plain version's largest |value|


def _held(out, plain, tag):
    err = float((out - plain).abs().max())
    scale = float(plain.abs().max())
    assert torch.isfinite(out).all(), tag
    assert err <= REL_TO_PLAIN * scale, (tag, err, scale)


@pytest.mark.parametrize("d2", CLUSTER_WIDTHS)
def test_cluster_widths_match_plain(cuda_device, d2):
    """K1, K2, K4 and K5 at d2 past one block's shared memory: each launch
    goes over a cluster of two blocks (the wrappers' cluster counts), is
    held to its plain version within REL_TO_PLAIN of the plain version's
    largest |value| and within its own kernel test's atol/rtol, and gives
    the same bits on a relaunch."""
    d1, n, L = 64, 200, 2
    plan = fp.fft_plan(d1, d2, n)
    assert plan.cluster == 2
    assert plan.shift == (30 if d2 == 57344 else 4)
    E = fourierft.sample_entries(d1, d2, n, seed=7).to(cuda_device)
    rng = np.random.default_rng(8)
    c = torch.from_numpy(rng.normal(size=(L, n)).astype(np.float32)).to(
        cuda_device)
    g = torch.from_numpy(rng.normal(size=(L, d1, d2)).astype(
        np.float32)).to(cuda_device)
    for mod, atol_w, rtol_w, atol_c, rtol_c in (
            (fdk, 2e-4, 0.0, 2e-3, 1e-4), (ddk, 2e-5, 1e-5, 1e-4, 1e-3)):
        npad = -(-n // mod.NC) * mod.NC
        e = torch.zeros((2, npad), dtype=torch.int32, device=cuda_device)
        e[:, :n] = E
        u, v = e[0].contiguous(), e[1].contiguous()
        cp = torch.zeros((L, npad), dtype=torch.float32, device=cuda_device)
        cp[:, :n] = c
        before = (mod.launches, mod.cluster_launches, mod.dc_launches,
                  mod.cluster_dc_launches)
        out = mod.deltaw(cp, u, v, d1, d2, 300.0)
        got = mod.dc(g, u, v, d1, d2, 300.0)
        assert (mod.launches, mod.cluster_launches, mod.dc_launches,
                mod.cluster_dc_launches) == tuple(b + 1 for b in before)
        plain = mod.deltaw_reference(cp, u, v, d1, d2, 300.0)
        _held(out, plain, (mod.__name__, "deltaw", d2))
        torch.testing.assert_close(out, plain, atol=atol_w, rtol=rtol_w)
        assert torch.equal(mod.deltaw(cp, u, v, d1, d2, 300.0), out)
        plain = mod.dc_reference(g, u, v, d1, d2, 300.0)
        _held(got, plain, (mod.__name__, "dc", d2))
        torch.testing.assert_close(got, plain, atol=atol_c, rtol=rtol_c)
        assert torch.equal(mod.dc(g, u, v, d1, d2, 300.0), got)


# ---------------------------------------------------------------------------

# the families' q/v stacks: olmoe-1b-7b 2048x2048 (L 16), phi3.5-moe's wv
# 4096x1024, musicgen-medium 1536x1536 (radix 3, L 48), qwen2-vl-72b's wq
# 8192x8192 and wv 8192x1024
FAMILY_QV = [(2048, 2048, 1000, 16), (4096, 1024, 1000, 4),
             (1536, 1536, 1000, 48), (8192, 8192, 1000, 2),
             (8192, 1024, 1000, 2)]


@pytest.mark.parametrize("d1,d2,n,L", FAMILY_QV)
def test_family_qv_shapes_k1_k2_match_plain(cuda_device, d1, d2, n, L):
    """K1 at atol 2e-4 and K2 at atol 2e-3 / rtol 1e-4 against their plain
    versions at the families' q/v shapes, one launch each."""
    E = fourierft.sample_entries(d1, d2, n, seed=7).to(cuda_device)
    rng = np.random.default_rng(8)
    c = torch.from_numpy(rng.normal(size=(L, n)).astype(np.float32)).to(
        cuda_device)
    before = fdk.launches
    out = ops.fourier_deltaw_forward(c, E, d1, d2, 300.0)
    assert fdk.launches == before + 1
    plain = fourierft.materialize_delta(c, E, d1, d2, 300.0)
    torch.testing.assert_close(out, plain, atol=2e-4, rtol=0)
    del out, plain
    g = torch.from_numpy(rng.normal(size=(L, d1, d2)).astype(
        np.float32)).to(cuda_device)
    npad = -(-n // fdk.NC) * fdk.NC
    e = torch.zeros((2, npad), dtype=torch.int32, device=cuda_device)
    e[:, :n] = E
    u, v = e[0].contiguous(), e[1].contiguous()
    before = fdk.dc_launches
    got = fdk.dc(g, u, v, d1, d2, 300.0)
    assert fdk.dc_launches == before + 1
    torch.testing.assert_close(got, fdk.dc_reference(g, u, v, d1, d2, 300.0),
                               atol=2e-3, rtol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_on_the_card_matches_direct(cuda_device, causal):
    """yi-6b's heads at S 4096 in f32: flash's forward within 3e-6 and its
    recomputing backward within 5e-5 of the function's exact value
    (direct attention in float64 under autograd), at a fraction of f32
    direct's peak memory. (f32 direct strays from the exact gradient by
    up to 1e-4 at this length on the card, so it is not the yardstick.)"""
    from repro_torch.models import attention as attn
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    q = torch.randn((1, 4096, 32, 128), generator=g, device=cuda_device)
    k = torch.randn((1, 4096, 4, 128), generator=g, device=cuda_device)
    v = torch.randn((1, 4096, 4, 128), generator=g, device=cuda_device)
    cot = torch.randn(q.shape, generator=g, device=cuda_device)

    def run(fn, dtype):
        xs = [t.to(dtype).requires_grad_(True) for t in (q, k, v)]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        o = fn(*xs)
        grads = torch.autograd.grad((o * cot.to(dtype)).sum(), xs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        return o.detach().double(), [x.double() for x in grads], peak

    def flash(*x):
        return attn.flash_attention(*x, causal, 512)

    def direct(*x):
        return attn.direct_attention(*x, causal=causal)

    fo, fg, flash_peak = run(flash, torch.float32)
    _, _, direct_peak = run(direct, torch.float32)
    ro, rg, _ = run(direct, torch.float64)
    torch.testing.assert_close(fo, ro, atol=3e-6, rtol=0)
    for a, b in zip(fg, rg):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=0)
    assert flash_peak * 8 < direct_peak


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"])
def test_moe_model_serves_through_the_kernels(cuda_device, arch):
    """A reduced MoE model at head_dim 128 (olmoe G = 1, phi3.5 G = 4)
    served through the scheduler in f32: the merge launches K1, every
    decode layer K3, and the streams equal the plain versions'."""
    cfg = configs.reduced(configs.get(arch), width=512).replace(
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
        reqs = [Request(prompt=p, max_new=3 + i)
                for i, p in enumerate(prompts)]
        sched.serve(reqs, [0.0, 1.0, 2.0, 3.0])
        outs[backend] = [r.out for r in reqs]
        if backend == "auto":
            assert fdk.launches == 2
            assert pa.launches == sched.metrics.steps * cfg.num_layers
        else:
            assert fdk.launches == pa.launches == 0
    assert outs["auto"] == outs["einsum"]


def test_codebook_model_trains_and_generates_on_the_card(cuda_device):
    """A reduced musicgen-medium: a merged train step at S 1536 through
    flash launches K1 and K2 once per site, and lockstep generation gives
    (T, 4) streams equal to the plain path's (f32)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.train import step as ts
    cfg = configs.reduced(configs.get("musicgen-medium")).replace(
        param_dtype="float32", dtype="float32")
    peft = PEFTConfig(n=64)
    model = build(cfg, peft)
    params = model.init(0, cuda_device)
    batch = {k: t.to(cuda_device) for k, t in SyntheticLM(
        vocab=cfg.vocab, batch=2, seq=1536, codebooks=4).batch_at(0).items()}
    state, frozen = ts.state_from_params(model, params)
    fdk.launches = fdk.dc_launches = 0
    state, metrics = ts.make_train_step(model, TrainConfig())(state, frozen,
                                                              batch)
    assert np.isfinite(float(metrics["loss"]))
    assert fdk.launches == fdk.dc_launches == 2
    prompts = [torch.arange(4 + i, dtype=torch.int32)[:, None].repeat(1, 4)
               for i in range(2)]
    outs = {}
    for backend in ("auto", "einsum"):
        engine = Engine(build(cfg, peft.replace(kernel_backend=backend)),
                        params, batch_slots=2, max_len=32, device=cuda_device)
        outs[backend] = [o.tolist() for o in engine.generate(prompts,
                                                              max_new=6)]
    assert outs["auto"] == outs["einsum"]
    assert [np.asarray(o).shape for o in outs["auto"]] == [(6, 4)] * 2


def test_custom_ops_launch_the_kernels_on_real_tensors(cuda_device):
    """K1–K5's custom ops (`kernels.custom_ops`, what the dry run traces on
    fake tensors) launch the same kernels on real CUDA tensors: the same
    bits as the wrappers, each launch counted; K1's op differentiates
    through K2's."""
    from repro_torch.kernels import custom_ops
    d1, d2, n, L = 512, 96, 64, 2
    E = fourierft.sample_entries(d1, d2, n, seed=7).to(cuda_device)
    u, v = E[0].to(torch.int32).contiguous(), E[1].to(torch.int32) \
        .contiguous()
    c = torch.from_numpy(np.random.default_rng(8).normal(
        size=(L, n)).astype(np.float32)).to(cuda_device)
    g = torch.randn((L, d1, d2), device=cuda_device)
    for name, mod in (("fourier", fdk), ("dct", ddk)):
        before = (mod.launches, mod.dc_launches)
        dw = custom_ops.op(f"{name}_deltaw")(c, u, v, d1, d2, 300.0)
        dc = custom_ops.op(f"{name}_dc")(g, u, v, d1, d2, 300.0)
        assert (mod.launches, mod.dc_launches) == (before[0] + 1,
                                                   before[1] + 1)
        assert torch.equal(dw, mod.deltaw(c, u, v, d1, d2, 300.0))
        assert torch.equal(dc, mod.dc(g, u, v, d1, d2, 300.0))
    cg = c.clone().requires_grad_(True)
    before = fdk.dc_launches
    dw = custom_ops.op("fourier_deltaw")(cg, u, v, d1, d2, 300.0)
    (grad,) = torch.autograd.grad((dw * g).sum(), [cg])
    assert fdk.dc_launches == before + 1
    assert torch.equal(grad, fdk.dc(g, u, v, d1, d2, 300.0))
    B, W, H, K, dh, ps, pps = 2, 1, 8, 2, 64, 16, 4
    q = torch.randn((B, W, H, dh), device=cuda_device, dtype=torch.bfloat16)
    kp = torch.randn((B * pps + 1, ps, K, dh), device=cuda_device,
                     dtype=torch.bfloat16)
    bt = (torch.arange(B * pps, dtype=torch.int32, device=cuda_device)
          .reshape(B, pps) + 1)
    kv = torch.tensor([50, 9], dtype=torch.int32, device=cuda_device)
    before = pa.launches
    out = custom_ops.op("paged_attention")(q, kp, kp, bt, kv)
    assert pa.launches == before + 1
    assert torch.equal(out, pa.paged_attention(q, kp, kp, bt, kv))
