"""The fused attention kernel (`kernels/fused_attention.py`,
`csrc/fused_attention.cu`) and the route to it.

The CPU tests hold the plain version (the Function on CPU tensors) to
`direct_attention`, its lse to `torch.logsumexp` of the masked scores,
the route of `attention()` and the custom op's fake implementation. The
`cuda` tests hold the kernel to the plain version on the card, its
gradients to a float64 reference at the precision of `direct_attention`'s
own, its refusals, its launch counts in a yi-6b layer and its range under
the profiler. The module imports neither JAX nor the JAX package, so on the
machine with the card it runs without them:

    PYTHONPATH=src python -m pytest -q --noconftest \\
        tests/test_torch_fused_attention.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import custom_ops
from repro_torch.kernels import fused_attention as fa
from repro_torch.models import attention as attn


def _qkv(B, S, H, K, dh, dtype=torch.float32, device="cpu", seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(device=device, dtype=dtype)

    return t(B, S, H, dh), t(B, S, K, dh), t(B, S, K, dh), t(B, S, H, dh)


def _grads(fn, q, k, v, do):
    xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out = fn(*xs)
    return (out.detach(),) + torch.autograd.grad((out * do).sum(), xs)


# (S, dh, G): every S with every head dim; G 1, 4 and 8 each at several
PLAIN_CASES = [(S, dh, G) for S in (1, 77, 1000, 1024)
               for dh, G in ((64, 1), (112, 4), (128, 8))] + [
    (77, 64, 8), (1000, 128, 1), (1024, 64, 4)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,dh,G", PLAIN_CASES)
def test_plain_version_matches_direct_attention(S, dh, G, causal):
    """The Function on CPU tensors (the plain forward and the recomputing
    backward) against `direct_attention` and its autograd gradients, in
    f32, where the two differ only by f32 rounding (the scale on the
    scores against on q, D as rowsum(dO ∘ O) against rowsum(P ∘ dP), the
    hi/lo split exact): within 2e-5 of 1 + the largest |value| (at S 1
    direct's dq is exactly 0, the plain version's P·(dP − D) ~1e-6)."""
    K = 2 if G == 1 and S < 1000 else 1
    q, k, v, do = _qkv(1, S, K * G, K, dh, seed=S + dh + G)
    want = _grads(lambda *x: attn.direct_attention(*x, causal=causal),
                  q, k, v, do)
    got = _grads(lambda *x: fa.fused_attention(*x, causal), q, k, v, do)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        scale = 1.0 + float(b.abs().max())
        assert float((a - b).abs().max()) <= 2e-5 * scale, name


@pytest.mark.parametrize("S,causal", [(77, True), (1000, False)])
def test_plain_version_in_bf16_stays_at_direct_attentions_distance(S,
                                                                  causal):
    """In bf16 both paths round P to bf16 (and direct rounds q·scale and
    dP as well): each lies about as far from the float64 function as the
    other."""
    q, k, v, do = _qkv(2, S, 8, 2, 64, dtype=torch.bfloat16, seed=S)
    exact = _grads(lambda *x: attn.direct_attention(*x, causal=causal),
                   *(t.double() for t in (q, k, v, do)))
    direct = _grads(lambda *x: attn.direct_attention(*x, causal=causal),
                    q, k, v, do)
    plain = _grads(lambda *x: fa.fused_attention(*x, causal), q, k, v, do)
    for name, e, d, p in zip(("out", "dq", "dk", "dv"), exact, direct, plain):
        err_d = float((d.double() - e).norm() / e.norm())
        err_p = float((p.double() - e).norm() / e.norm())
        assert err_p <= 1.5 * err_d, (name, err_p, err_d)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 77, 1024])
def test_lse_is_the_logsumexp_of_the_masked_scores(S, causal):
    q, k, v, _ = _qkv(2, S, 4, 2, 64, seed=3)
    out, lse = fa.reference_forward(q, k, v, causal)
    s = torch.einsum("bqhd,bthd->bhqt", q, k.repeat_interleave(2, dim=2))
    s = s * 64 ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(S, S).triu(1).bool(), float("-inf"))
    assert lse.shape == (2, 4, S)
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), atol=1e-5,
                               rtol=1e-6)
    torch.testing.assert_close(out, attn.direct_attention(q, k, v,
                                                          causal=causal),
                               atol=2e-6, rtol=0)


def _recorded(monkeypatch):
    seen = []
    for name in ("direct_attention", "flash_attention", "chunked_attention"):
        fn = getattr(attn, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            seen.append(_name)
            return _fn(*a, **kw)

        monkeypatch.setattr(attn, name, wrapped)
    fused = fa.fused_attention

    def counted(*a, **kw):
        seen.append("fused_attention")
        return fused(*a, **kw)

    monkeypatch.setattr(fa, "fused_attention", counted)
    return seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_routes_cpu_tensors_to_the_direct_path(monkeypatch, dtype):
    """CPU tensors, f32 or bf16, take `direct_attention` under the range
    `attention/direct`; the fused route is for tensors on the card."""
    from torch.profiler import ProfilerActivity, profile
    seen = _recorded(monkeypatch)
    q, k, v, _ = _qkv(1, 64, 4, 2, 64, dtype=dtype)
    assert not fa.takes(q, k, v)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        attn.attention(q, k, v, causal=True)
    names = {e.name for e in prof.events()}
    assert seen == ["direct_attention"]
    assert "repro_torch/attention/direct" in names
    assert "repro_torch/attention/fused" not in names


def test_route_follows_dtype_device_rows_and_head_dim(monkeypatch):
    """On (fake) CUDA tensors: bf16 at S <= 1024 with a head dim the kernel
    takes goes to the fused kernel (its custom op on fake tensors, nothing
    launched); f32 and dh 100 or 256 do not. (The direct and flash paths
    make real index tensors on the device, which a CPU build of torch
    cannot, so they are not called here.)"""
    from torch._subclasses.fake_tensor import FakeTensorMode
    seen = _recorded(monkeypatch)
    before = (fa.launches, fa.bwd_launches)
    with FakeTensorMode():
        def qkv(S, dh, dtype=torch.bfloat16, H=8, K=2):
            return (torch.empty(2, S, H, dh, dtype=dtype, device="cuda"),
                    torch.empty(2, S, K, dh, dtype=dtype, device="cuda"),
                    torch.empty(2, S, K, dh, dtype=dtype, device="cuda"))

        for dh in (64, 112, 128):
            assert fa.takes(*qkv(1024, dh))
            out = attn.attention(*qkv(1024, dh), causal=True)
            assert tuple(out.shape) == (2, 1024, 8, dh)
            assert out.dtype == torch.bfloat16
        assert not fa.takes(*qkv(1024, 64, torch.float32))
        assert not fa.takes(*qkv(1024, 100))
        assert not fa.takes(*qkv(1024, 256))
    assert seen == ["fused_attention"] * 3
    assert (fa.launches, fa.bwd_launches) == before


def test_dtensors_keep_the_direct_path_and_the_wrapper_refuses_them():
    """A DTensor is no input for the kernel: `takes` is False for it, so
    `attention` stays direct, and the launch raises rather than read a
    wrapper's storage. On a mesh the model hands the kernel local shards
    through `dist.dtensor.local_attention` (training and prefill)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        q, k, v, _ = _qkv(1, 16, 4, 2, 64, dtype=torch.bfloat16)
        dq, dk, dv = (DTensor.from_local(t, mesh, [Replicate()])
                      for t in (q, k, v))
        assert not fa._plain(dq) and fa._plain(q)
        assert not fa.takes(dq, dk, dv)
        with pytest.raises(ValueError, match="plain tensors"):
            fa._fwd_launch(dq, dk, dv, True)
    finally:
        dist.destroy_process_group()


def test_custom_op_fake_gives_the_shapes_and_differentiates():
    """The op's fake implementation: (out (B, S, H, dh) in v's dtype, lse
    (B, H, S) f32), and its VJP through the backward op's fake."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q = torch.empty(2, 77, 8, 112, dtype=torch.bfloat16,
                        requires_grad=True)
        k = torch.empty(2, 77, 2, 112, dtype=torch.bfloat16,
                        requires_grad=True)
        out, lse = custom_ops.op("fused_attention")(q, k, k, True)
        assert tuple(out.shape) == (2, 77, 8, 112)
        assert out.dtype == torch.bfloat16
        assert tuple(lse.shape) == (2, 8, 77) and lse.dtype == torch.float32
        dq, dk = torch.autograd.grad(out.float().sum(), [q, k])
        assert tuple(dq.shape) == tuple(q.shape)
        assert tuple(dk.shape) == tuple(k.shape)


def test_custom_op_costs_count_the_visible_pairs():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.dist.opstats import OpStats
    with FakeTensorMode():
        q = torch.empty(2, 10, 8, 64, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(2, 10, 2, 64, dtype=torch.bfloat16, device="cuda")
        with OpStats() as rec:
            fa.fused_attention(q, k, k, True)
    st = rec.stats
    assert st.kernel_counts == {"fused_attention": 1}
    assert st.flops == pytest.approx(4.0 * 8 * 64 * 2 * 55)
    assert st.bytes_min == pytest.approx(2 * (2 * 2 * 10 * 8 * 64
                                              + 2 * 2 * 10 * 2 * 64)
                                         + 4 * 2 * 8 * 10)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (B, S, H, K, dh, causal): S 1, 77, 1000, 1024; dh 64, 112, 128; G 1, 4,
# 8; and sft1k's shape (yi-6b's heads at 8 x 1024)
KERNEL_CASES = [
    (2, 1, 8, 8, 64, True), (2, 77, 8, 2, 64, True),
    (2, 77, 16, 2, 112, False), (1, 1000, 8, 1, 128, True),
    (1, 1000, 4, 4, 64, False), (2, 1024, 8, 2, 112, True),
    (1, 1024, 16, 2, 128, False), (1, 333, 12, 3, 112, True),
    (8, 1024, 32, 4, 128, True),
]


def _rel(a, b, floor=0.0):
    """||a - b|| / max(||b||, floor)."""
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(max(floor, 1e-30)))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,K,dh,causal", KERNEL_CASES)
def test_kernel_matches_plain_version(cuda_device, B, S, H, K, dh, causal):
    """The kernel against its plain version on the same bf16 inputs: lse
    within 1e-4 (f32 sums in another order, exp2 on the card), out and
    the gradients within 1e-2 relative (P rounded to bf16 before and after
    its normalisation; the gradients' norm floored at 1e-3 of dout's,
    since at S 1 dq and dk are zero but for rounding); the same bits on a
    relaunch (no atomics); one launch each way."""
    q, k, v, do = _qkv(B, S, H, K, dh, torch.bfloat16, cuda_device, seed=S)
    before = (fa.launches, fa.bwd_launches)
    out, lse = fa._fwd_launch(q, k, v, causal)
    dq, dk, dv = fa._bwd_launch(q, k, v, out, lse, do, causal)
    assert (fa.launches, fa.bwd_launches) == (before[0] + 1, before[1] + 1)
    p_out, p_lse = fa.reference_forward(q, k, v, causal)
    p_grads = fa.reference_backward(q, k, v, p_out, p_lse, do, causal)
    assert float((lse - p_lse).abs().max()) <= 1e-4
    assert _rel(out, p_out) <= 1e-2
    floor = 1e-3 * float(do.double().norm())
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), p_grads):
        assert _rel(a, b, floor) <= 1e-2, name
    out2, lse2 = fa._fwd_launch(q, k, v, causal)
    again = fa._bwd_launch(q, k, v, out, lse, do, causal)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)
    assert all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv)))


# dq/dk/dv no further from the float64 function than direct_attention's
# autograd gradients are, by this factor: the hi/lo dS meets the f32 dS
GRAD_FACTOR = 1.25


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,K,dh,causal", [
    (2, 1024, 32, 4, 128, True), (2, 1000, 16, 2, 112, False),
    (4, 1024, 8, 8, 64, True)])
def test_gradients_meet_direct_attentions_precision(cuda_device, B, S, H,
                                                    K, dh, causal):
    q, k, v, do = _qkv(B, S, H, K, dh, torch.bfloat16, cuda_device, seed=7)
    exact = _grads(lambda *x: attn.direct_attention(*x, causal=causal),
                   *(t.double() for t in (q, k, v, do)))
    direct = _grads(lambda *x: attn.direct_attention(*x, causal=causal),
                    q, k, v, do)
    fused = _grads(lambda *x: fa.fused_attention(*x, causal), q, k, v, do)
    for name, e, d, f in zip(("out", "dq", "dk", "dv"), exact, direct,
                             fused):
        err_d, err_f = _rel(d, e), _rel(f, e)
        print(f"{name}: fused {err_f:.3e}, direct {err_d:.3e}")
        if name != "out":
            assert err_f <= GRAD_FACTOR * err_d, (name, err_f, err_d)


@pytest.mark.cuda
def test_wrapper_raises_on_inputs_it_does_not_take(cuda_device):
    """f32, a head dim that is no multiple of 8 or past 128, and
    non-contiguous inputs raise; nothing falls back on the card."""
    before = (fa.launches, fa.bwd_launches)
    for dtype, dh in ((torch.float32, 64), (torch.bfloat16, 100),
                      (torch.bfloat16, 256)):
        q, k, v, _ = _qkv(1, 64, 4, 2, dh, dtype, cuda_device)
        with pytest.raises(ValueError, match="bfloat16|head_dim"):
            fa.fused_attention(q, k, v, True)
    q, k, v, _ = _qkv(1, 64, 4, 2, 64, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fa._fwd_launch(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                       True)
    assert (fa.launches, fa.bwd_launches) == before


@pytest.mark.cuda
def test_custom_op_launches_the_kernel_on_real_tensors(cuda_device):
    q, k, v, do = _qkv(2, 200, 8, 2, 128, torch.bfloat16, cuda_device)
    before = fa.launches
    out, lse = custom_ops.op("fused_attention")(q, k, v, True)
    assert fa.launches == before + 1
    ref, ref_lse = fa._fwd_launch(q, k, v, True)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    grads = custom_ops.op("fused_attention_bwd")(q, k, v, out, lse, do, True)
    assert all(torch.equal(a, b) for a, b in
               zip(grads, fa._bwd_launch(q, k, v, out, lse, do, True)))


@pytest.mark.cuda
def test_yi6b_layers_train_through_the_kernel(cuda_device):
    """yi-6b at full width, 2 layers, bf16, remat full, one train step at
    2 x 1024 under the profiler: the range `attention/fused` (and no
    `attention/direct`), and by the counters one forward launch a layer,
    one more for the recompute, and one backward launch a layer."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.configs.base import PEFTConfig, TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build
    from repro_torch.train import step as ts
    cfg = configs.get("yi-6b").replace(num_layers=2)
    model = build(cfg, PEFTConfig(n=1000, alpha=300.0), remat="full")
    params = model.init(0, cuda_device)
    batch = {k_: t.to(cuda_device) for k_, t in SyntheticLM(
        vocab=cfg.vocab, batch=2, seq=1024).batch_at(0).items()}
    state, frozen = ts.state_from_params(model, params)
    step = ts.make_train_step(model, TrainConfig())
    state, metrics = step(state, frozen, batch)
    torch.cuda.synchronize()
    before = (fa.launches, fa.bwd_launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, metrics = step(state, frozen, batch)
        torch.cuda.synchronize()
    assert np.isfinite(float(metrics["loss"]))
    assert (fa.launches - before[0], fa.bwd_launches - before[1]) == (4, 2)
    names = {e.name for e in prof.events()}
    assert "repro_torch/attention/fused" in names
    assert "repro_torch/attention/direct" not in names
