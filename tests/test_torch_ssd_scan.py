"""The SSD scan kernel (`kernels/ssd_scan.py`, `csrc/ssd_scan.cu`) and the
route to it (`models/mamba2.py::ssd_scan`).

On the CPU: the route keeps `ssd_chunked` for CPU and float64 tensors (bit
for bit), sends fake CUDA tensors of bf16 and f32 to the custom op (whose
VJP runs through the backward op's fake) and refuses shapes the kernel does
not take; the op's `COSTS` entry prices the benchmark's `ssd_ops` and
`ssd_bytes`; the wrapper's autograd on real tensors, with the launches
stood in for, pads, cuts and casts as the kernel needs; and a float64 emulation
of the kernel's decomposition (chunks of 64 rows over a sequence padded
with zero rows, the scores shared by a block's heads, the partial sums,
the chunk states and their recurrence both ways) matches `ssd_chunked` at
the model's chunk and its autograd gradients. The `cuda` tests
hold the kernel to `ssd_recurrent_oracle` in float64, values and
gradients, at the port's geometries; its refusals; its counters; its bits
on a relaunch; and a mamba2 train step through it. The module imports
neither JAX nor the JAX package, so on the machine with the card it runs
without them:

    PYTHONPATH=src python -m pytest -q --noconftest \\
        tests/test_torch_ssd_scan.py
"""
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import custom_ops
from repro_torch.kernels import ssd_scan as ssk
from repro_torch.models import mamba2

REPO = Path(__file__).resolve().parents[1]


def _inputs(b, S, H, G, N, dtype=torch.float32, device="cpu", seed=0,
            P=64):
    """x, dt, A, B, C, D as the model makes them (dt after softplus, A
    negative), and cotangents for y and the final state."""
    rng = np.random.default_rng(seed)

    def t(*shape, dt_=torch.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(device=device, dtype=dt_)

    x = t(b, S, H, P, dt_=dtype)
    dt = F.softplus(t(b, S, H)) * 0.1
    A = -torch.exp(t(H) * 0.5)
    B, C = t(b, S, G, N, dt_=dtype), t(b, S, G, N, dt_=dtype)
    D = t(H) * 0.5 + 1.0
    dy, dfin = t(b, S, H, P, dt_=dtype), t(b, H, P, N)
    return (x, dt, A, B, C, D), dy, dfin


# ---------------------------------------------------------------------------
# The route, the custom op and its costs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_route_takes_ssd_chunked_for_cpu_and_float64(monkeypatch, dtype):
    """CPU tensors (and float64 ones) take `ssd_chunked`: the same bits, and
    the kernel's wrapper is never called."""
    def refuse(*a, **k):
        raise AssertionError("the kernel route was taken")

    monkeypatch.setattr(ssk, "ssd_scan", refuse)
    ins, _, _ = _inputs(1, 256, 4, 2, 64, dtype=dtype, seed=1)
    assert not ssk.takes(*ins)
    y, fin = mamba2.ssd_scan(*ins, chunk=128)
    y0, fin0 = mamba2.ssd_chunked(*ins, chunk=128)
    assert torch.equal(y, y0) and torch.equal(fin, fin0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fake_cuda_tensors_reach_the_custom_op(dtype):
    """On (fake) CUDA tensors of bf16 and f32 the route reaches the custom
    op `repro_torch::ssd_scan` (counted by OpStats), nothing is launched,
    and y (x's dtype) and the final state (f32) have their shapes; float64
    CUDA tensors stay on `ssd_chunked`'s side of the route."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.dist.opstats import OpStats
    before = (ssk.launches, ssk.bwd_launches)
    with FakeTensorMode():
        def make(dt_, S=512, H=8, G=2, N=64):
            return (torch.empty(2, S, H, 64, dtype=dt_, device="cuda"),
                    torch.empty(2, S, H, device="cuda"),
                    torch.empty(H, device="cuda"),
                    torch.empty(2, S, G, N, dtype=dt_, device="cuda"),
                    torch.empty(2, S, G, N, dtype=dt_, device="cuda"),
                    torch.empty(H, device="cuda"))

        ins = make(dtype)
        assert ssk.takes(*ins)
        with OpStats() as rec:
            y, fin = mamba2.ssd_scan(*ins, chunk=256)
        assert tuple(y.shape) == (2, 512, 8, 64) and y.dtype == dtype
        assert tuple(fin.shape) == (2, 8, 64, 64)
        assert fin.dtype == torch.float32
        assert not ssk.takes(*make(torch.float64))
    assert rec.stats.kernel_counts == {"ssd_scan": 1}
    assert (ssk.launches, ssk.bwd_launches) == before


def test_custom_op_fake_differentiates_through_the_backward_op():
    """On fake tensors the wrapper's Function (the route's, here on CPU
    fakes: this build's autograd cannot make a CUDA leaf) runs through
    `ssd_scan` and `ssd_scan_bwd`'s fakes, one call each by OpStats: each
    gradient has its input's shape and dtype; the forward op's cum and
    states have theirs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.dist.opstats import OpStats
    with FakeTensorMode():
        shapes = ((1, 512, 8, 64), (1, 512, 8), (8,), (1, 512, 2, 128),
                  (1, 512, 2, 128), (8,))
        dtypes = (torch.bfloat16, torch.float32, torch.float32,
                  torch.bfloat16, torch.bfloat16, torch.float32)
        ins = [torch.empty(s, dtype=d, requires_grad=True)
               for s, d in zip(shapes, dtypes)]
        y, fin, cum, hst = custom_ops.op("ssd_scan")(*ins, 256)
        assert tuple(cum.shape) == (1, 8, 512)
        assert tuple(hst.shape) == (1, 8, 8, 64, 128)   # chunks of 64
        with OpStats() as rec:
            y, fin = ssk._SSDScan.apply(*ins, 256)
            grads = torch.autograd.grad(y.float().sum() + fin.sum(), ins)
    assert rec.stats.kernel_counts == {"ssd_scan": 1, "ssd_scan_bwd": 1}
    for g, t in zip(grads, ins):
        assert g.shape == t.shape and g.dtype == t.dtype


@pytest.mark.parametrize("change,match", [
    ({"P": 32}, "head_dim"), ({"N": 16}, "state"), ({"chunk": 512}, "chunk"),
    ({"dtype": torch.float16}, "bfloat16"), ({"S": 300}, "multiple"),
    ({"mixed": True}, "bfloat16")])
def test_fake_cuda_shapes_the_kernel_does_not_take_raise(change, match):
    """A CUDA input the kernel does not take raises on the route; nothing
    falls back to the plain version on the card."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    P, N, S = change.get("P", 64), change.get("N", 64), change.get("S", 512)
    dtype = change.get("dtype", torch.bfloat16)
    with FakeTensorMode():
        x = torch.empty(1, S, 8, P, dtype=dtype, device="cuda")
        bc = torch.empty(1, S, 2, N, device="cuda",
                         dtype=torch.float32 if "mixed" in change else dtype)
        v = torch.empty(8, device="cuda")
        with pytest.raises(ValueError, match=match):
            mamba2.ssd_scan(x, torch.empty(1, S, 8, device="cuda"), v, bc,
                            bc, v, chunk=change.get("chunk", 256))


def _stand_in_run(name, ts, x, B, q):
    """`ssd_scan._run` on CPU tensors: the library's outputs from `_emulate`
    (below) on the padded inputs it is handed (the op runs below autograd,
    so no autograd here); cum and the states are left as they are (only
    their shapes travel)."""
    x_, dt, A, B_, C, D = ts[:6]
    if name == "ssd_scan_fwd_launch":
        dy, dfin = torch.zeros_like(x_), None
    else:
        dy, dfin = ts[6], ts[7]
    if dfin is None:
        dfin = torch.zeros(x_.shape[0], x_.shape[2], x_.shape[3],
                           B_.shape[3])
    (y, fin), (dx, ddt, dA, dB, dC, dD) = _emulate(
        x_, dt, A, B_, C, D, dy, dfin, ssk.HEADS_A_BLOCK)
    if name == "ssd_scan_fwd_launch":
        ts[6].copy_(y)
        ts[7].copy_(fin)
        return
    dA_part, dD_part = ts[12], ts[13]
    dA_part.zero_()
    dD_part.zero_()
    dA_part[0, 0].copy_(dA)
    dD_part[0, 0].copy_(dD)
    for out, g in zip(ts[16:], (dx, ddt, dB, dC)):
        out.copy_(g)


@pytest.mark.parametrize("S,dtype,with_y,with_fin", [
    (256, torch.float32, True, True), (200, torch.bfloat16, True, False),
    (251, torch.float32, False, True), (37, torch.bfloat16, True, True)])
def test_autograd_on_real_tensors_pads_cuts_and_casts(
        monkeypatch, S, dtype, with_y, with_fin):
    """Real tensors through the wrapper's Function (the scan's only
    backward), the library stood in for by `_emulate`: y and the
    final state are the plain version's, the gradients its autograd's,
    each gradient in its input's dtype (a bf16 D's too), cum and the
    states over the padded length, a missing cotangent (y's or the final
    state's) taken as zero (the final state's reaching the library as
    none), and one forward and one backward call by the counters."""
    handed = []

    def run(name, ts, x, B, q):
        if name == "ssd_scan_bwd_launch":
            handed.append(ts[7] is not None)
        _stand_in_run(name, ts, x, B, q)

    monkeypatch.setattr(ssk, "_run", run)
    ins, dy, dfin = _inputs(2, S, 4, 2, 64, dtype, seed=S)
    ins = list(ins)
    ins[5] = ins[5].to(torch.bfloat16)
    xs = [t.detach().requires_grad_(True) for t in ins]
    before = (ssk.launches, ssk.bwd_launches)
    y, fin = ssk._SSDScan.apply(*xs, min(S, 256))
    q, Sp = ssk.tiling(S)
    assert y.grad_fn.saved_tensors[0].shape[1] == Sp    # x, padded
    assert tuple(y.grad_fn.saved_tensors[6].shape) == (2, 4, Sp)
    assert tuple(y.grad_fn.saved_tensors[7].shape) == (2, Sp // q, 4, 64,
                                                       64)
    assert y.dtype == dtype and tuple(y.shape) == tuple(ins[0].shape)
    loss = 0.0
    if with_y:
        loss = loss + (y.float() * dy.float()).sum()
    if with_fin:
        loss = loss + (fin * dfin).sum()
    grads = torch.autograd.grad(loss, xs)
    assert (ssk.launches - before[0], ssk.bwd_launches - before[1]) == (1, 1)
    assert handed == [with_fin]     # no zeros made for a missing cotangent
    ref = [t.detach().double().requires_grad_(True) for t in ins]
    y0, fin0 = mamba2.ssd_chunked(*ref, chunk=min(S, 256))
    loss0 = 0.0
    if with_y:
        loss0 = loss0 + (y0 * dy.double()).sum()
    if with_fin:
        loss0 = loss0 + (fin0 * dfin.double()).sum()
    want = torch.autograd.grad(loss0, ref, allow_unused=True,
                               materialize_grads=True)
    torch.testing.assert_close(y.double(), y0.detach().to(dtype).double(),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(fin.double(), fin0.detach(), atol=1e-4,
                               rtol=1e-5)
    for name, g, w, t in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), grads,
                             want, ins):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        torch.testing.assert_close(g.double(), w.to(t.dtype).double(),
                                   atol=1e-4 * max(float(w.abs().max()), 1.0),
                                   rtol=0, msg=name)


def _zamba2_family():
    spec = importlib.util.spec_from_file_location(
        "zamba2_family_for_tests", REPO / "perfbench/families/zamba2.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seq", [4096, 1024, 200])
def test_custom_op_costs_price_ssd_ops_and_ssd_bytes(seq):
    """At zamba2-7b-instruct's geometry (H 112, P 64, N 64, G 2, chunk 256)
    the op's COSTS entry counts the benchmark's `ssd_ops` and `ssd_bytes`
    of a layer, and its backward twice those operations."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.dist.opstats import OpStats
    fam = _zamba2_family()
    cfg = json.loads((REPO / "perfbench/configs/zamba2-7b-instruct.json"
                      ).read_text())
    H, P = cfg["n_mamba_heads"], cfg["mamba_headdim"]
    G, N = cfg["mamba_ngroups"], cfg["mamba_d_state"]
    chunk = min(cfg["chunk_size"], seq)
    with FakeTensorMode():
        x = torch.empty(1, seq, H, P, dtype=torch.bfloat16, device="cuda")
        dt = torch.empty(1, seq, H, device="cuda")
        v = torch.empty(H, device="cuda")
        bc = torch.empty(1, seq, G, N, dtype=torch.bfloat16, device="cuda")
        with OpStats() as rec:
            mamba2.ssd_scan(x, dt, v, bc, bc, v, chunk=chunk)
    assert rec.stats.flops == pytest.approx(fam.ssd_ops(cfg, 1, seq))
    assert rec.stats.bytes_min == pytest.approx(fam.ssd_bytes(cfg, 1, seq))
    args = (x, dt, v, bc, bc, v, None, None, x, None, chunk)
    ops, _ = custom_ops.COSTS["ssd_scan_bwd"](args, None)
    assert ops == pytest.approx(2 * fam.ssd_ops(cfg, 1, seq))
    if seq == 4096:     # the issue's figures: 15.2 GF and 121 MB a layer
        assert fam.ssd_ops(cfg, 1, seq) == pytest.approx(15.2e9, rel=0.01)
        assert fam.ssd_bytes(cfg, 1, seq) == pytest.approx(121e6, rel=0.01)


# ---------------------------------------------------------------------------
# The kernel's decomposition, emulated in float64
# ---------------------------------------------------------------------------

def _emulate(x, dt, A, B, C, D, dy, dfin, hb):
    """The kernel's algorithm in float64, launch by launch (the source's
    header): chunks of `tiling(S)` rows over the sequence padded with zero
    rows (the wrapper's), cut back to S at the end; forward chunk_state,
    state_pass, chunk_out (C·Bᵀ shared by a block's `hb` heads); backward
    chunk_state on (dy, C), dstate_pass, chunk_grad (the scores' gradient
    summed over the block's heads, dcum summed back along the chunk in the
    block), finish_bc (dB and dC summed over the blocks of heads)."""
    f = torch.float64
    x, dt, A, B, C, D, dy, dfin = (t.to(f) for t in (x, dt, A, B, C, D, dy,
                                                     dfin))
    S0 = x.shape[1]
    q, S = ssk.tiling(S0)
    x, dt, B, C, dy = (ssk._padded(t, S) for t in (x, dt, B, C, dy))
    b, _, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc, rep = S // q, H // G
    nhb = -(-rep // hb)
    z = torch.zeros
    below = torch.tril(torch.ones(q, q, dtype=torch.bool))    # s <= t

    def rows(t, c):
        return t[:, c * q:(c + 1) * q]

    def blocks(g):
        for k in range(nhb):
            yield k, range(g * rep + k * hb, g * rep + min(rep, (k + 1) * hb))

    # forward
    cum = z(b, H, S, dtype=f)
    hst = z(b, nc, H, P, N, dtype=f)
    for c in range(nc):
        for h in range(H):
            cs = torch.cumsum(rows(dt, c)[..., h] * A[h], dim=1)
            cum[:, h, c * q:(c + 1) * q] = cs
            w = torch.exp(cs[:, -1:] - cs) * rows(dt, c)[..., h]
            hst[:, c, h] = torch.einsum("bs,bsp,bsn->bpn", w,
                                        rows(x, c)[:, :, h],
                                        rows(B, c)[:, :, h // rep])
    cur = z(b, H, P, N, dtype=f)
    for c in range(nc):
        st = hst[:, c].clone()
        hst[:, c] = cur
        cur = torch.exp(cum[:, :, c * q + q - 1])[..., None, None] * cur + st
    final = cur
    y = z(b, S, H, P, dtype=f)
    for c in range(nc):
        for g in range(G):
            cb = torch.einsum("bsn,btn->bst", rows(B, c)[:, :, g],
                              rows(C, c)[:, :, g])
            for _, heads in blocks(g):
                for h in heads:
                    cq = cum[:, h, c * q:(c + 1) * q]
                    m = torch.where(below.T, cb * torch.exp(
                        cq[:, None, :] - cq[:, :, None])
                        * rows(dt, c)[..., h][:, :, None],
                        torch.zeros((), dtype=f))
                    acc = torch.exp(cq)[..., None] * torch.einsum(
                        "btn,bpn->btp", rows(C, c)[:, :, g], hst[:, c, h])
                    acc = acc + torch.einsum("bst,bsp->btp", m,
                                             rows(x, c)[:, :, h])
                    y[:, c * q:(c + 1) * q, h] = acc + D[h] * rows(x, c)[
                        :, :, h]

    # backward: chunk_state on (dy, C), dstate_pass
    gs = z(b, nc, H, P, N, dtype=f)
    for c in range(nc):
        for h in range(H):
            gs[:, c, h] = torch.einsum(
                "bs,bsp,bsn->bpn", torch.exp(cum[:, h, c * q:(c + 1) * q]),
                rows(dy, c)[:, :, h], rows(C, c)[:, :, h // rep])
    dS = z(b, nc, H, P, N, dtype=f)
    dT = z(b, H, nc, dtype=f)
    dh = dfin.clone()
    for c in range(nc - 1, -1, -1):
        eT = torch.exp(cum[:, :, c * q + q - 1])
        dT[:, :, c] = eT * (dh * hst[:, c]).sum((-1, -2))
        dS[:, c] = dh
        dh = eT[..., None, None] * dh + gs[:, c]

    # chunk_grad, a block per (chunk, group, block of heads); finish_bc
    dx = z(b, S, H, P, dtype=f)
    ddt = z(b, S, H, dtype=f)
    dA = z(H, dtype=f)
    dD = z(H, dtype=f)
    dB_part = z(nhb, b, S, G, N, dtype=f)
    dC_part = z(nhb, b, S, G, N, dtype=f)
    for c in range(nc):
        sl = slice(c * q, (c + 1) * q)
        for g in range(G):
            bs, ct = B[:, sl, g], C[:, sl, g]
            cb = torch.einsum("btn,bsn->bts", ct, bs)
            for k, heads in blocks(g):
                sg = z(b, q, q, dtype=f)
                dbacc = z(b, q, N, dtype=f)
                dcacc = z(b, q, N, dtype=f)
                for h in heads:
                    cs, ds = cum[:, h, sl], dt[:, sl, h]
                    xs, ys = x[:, sl, h], dy[:, sl, h]
                    es = torch.exp(cs[:, -1:] - cs)
                    acc = es[..., None] * torch.einsum("bsn,bpn->bsp", bs,
                                                       dS[:, c, h])
                    tmp = (es * ds)[..., None] * torch.einsum(
                        "bsp,bpn->bsn", xs, dS[:, c, h])
                    wv = (tmp * bs).sum(-1)
                    dbacc = dbacc + tmp
                    oc = torch.exp(cs)[..., None] * torch.einsum(
                        "btp,bpn->btn", ys, hst[:, c, h])
                    dc = (oc * ct).sum(-1)
                    dcacc = dcacc + oc
                    u = torch.einsum("btp,bsp->bts", ys, xs)
                    L = torch.where(below, torch.exp(cs[:, :, None]
                                                     - cs[:, None, :]),
                                    torch.zeros((), dtype=f))
                    K = cb * L
                    dK = ds[:, None, :] * u
                    r = dK * K
                    sg = sg + dK * L
                    acc = acc + torch.einsum("bts,btp->bsp", K, ys)
                    dx[:, sl, h] = acc * ds[..., None] + D[h] * ys
                    dcum = dc + r.sum(2) - r.sum(1) - wv
                    dcum[:, -1] += wv.sum(1) + dT[:, h, c]
                    da = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1),
                                    [1])
                    ddt[:, sl, h] = (acc * xs).sum(-1) + da * A[h]
                    dA[h] += (da * ds).sum()
                    dD[h] += (ys * xs).sum()
                dB_part[k, :, sl, g] = dbacc + torch.einsum("bts,btn->bsn",
                                                            sg, ct)
                dC_part[k, :, sl, g] = dcacc + torch.einsum("bts,bsn->btn",
                                                            sg, bs)
    return ((y[:, :S0], final),
            (dx[:, :S0], ddt[:, :S0], dA, dB_part.sum(0)[:, :S0],
             dC_part.sum(0)[:, :S0], dD))


@pytest.mark.parametrize("S,want", [
    (4096, (64, 4096)), (256, (64, 256)), (128, (64, 128)),
    (200, (64, 256)), (251, (64, 256)), (97, (64, 128)), (64, (64, 64)),
    (37, (37, 37)), (1, (1, 1))])
def test_tiling_is_64_row_chunks_over_a_padded_sequence(S, want):
    """Chunks of 64 rows whatever the length, the sequence padded to a
    multiple (a prime length too: no run of short chunks); a sequence
    shorter than 64 is one chunk."""
    assert ssk.tiling(S) == want


# (b, S, H, G, N, chunk, heads a block): S a multiple of 64, and S padded
# by 56, 32, 42 and 5 rows (200 and 251 not powers of two, 251 prime); S
# below 64 (one chunk of 37); G 1 and 2; a block of heads short of hb
EMULATED = [(1, 256, 4, 2, 8, 128, 2), (2, 200, 3, 1, 8, 100, 2),
            (1, 384, 6, 2, 4, 192, 4), (1, 96, 2, 1, 4, 96, 1),
            (1, 150, 4, 1, 4, 150, 3), (1, 37, 2, 2, 4, 37, 1),
            (1, 251, 2, 1, 4, 251, 2)]


@pytest.mark.parametrize("b,S,H,G,N,chunk,hb", EMULATED)
def test_emulated_kernel_algorithm_matches_autograd(b, S, H, G, N, chunk,
                                                    hb):
    """The emulation's y, final state and the six gradients (with a
    cotangent on the final state) against `ssd_chunked` at the model's
    chunk and its float64 autograd gradients, within float64 rounding."""
    ins, dy, dfin = _inputs(b, S, H, G, N, seed=S + H, P=8)
    ins = [t.double() for t in ins]
    dfin = dfin[..., :8, :].double()
    (y, fin), grads = _emulate(*ins, dy.double(), dfin, hb)
    xs = [t.detach().requires_grad_(True) for t in ins]
    y0, fin0 = mamba2.ssd_chunked(*xs, chunk=chunk)
    want = torch.autograd.grad((y0 * dy.double()).sum()
                               + (fin0 * dfin).sum(), xs)
    torch.testing.assert_close(y, y0.detach(), atol=1e-10, rtol=1e-10)
    torch.testing.assert_close(fin, fin0.detach(), atol=1e-10, rtol=1e-10)
    for name, a, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), grads,
                          want):
        scale = float(w.abs().max())
        assert float((a - w).abs().max()) <= 1e-10 * max(scale, 1.0), name


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


LIMIT = 1e-4    # chip_smoke's: of each tensor's largest |value|


def _within(got, want, name, dtype):
    """max |got − want| within LIMIT of want's largest |value|; a bf16
    output also gets the half ulp of its own rounding (2^-8 relative)."""
    want = want.double()
    err = (got.double() - want).abs()
    allow = LIMIT * float(want.abs().max())
    if got.dtype == torch.bfloat16:
        allow = allow + 2.0 ** -8 * want.abs()
    assert bool((err <= allow).all()), (
        name, dtype, float(err.max()), float(want.abs().max()))


def _oracle_grads(ins, dy, dfin):
    xs = [t.detach().double().requires_grad_(True) for t in ins]
    y, fin = mamba2.ssd_recurrent_oracle(*xs)
    loss = (y * dy.double()).sum()
    if dfin is not None:
        loss = loss + (fin * dfin.double()).sum()
    return (y.detach(), fin.detach()), torch.autograd.grad(loss, xs)


# (b, S, H, G, N, dtype, with a final-state cotangent): zamba2-7b-instruct
# at S 1024 and 4096, mamba2-2.7b, a rank's 56 local heads, S below the
# chunk (128; 200, no power of two, and 251, a prime: both padded to 256)
KERNEL_CASES = [
    (1, 1024, 112, 2, 64, torch.float32, False),
    (1, 1024, 112, 2, 64, torch.bfloat16, True),
    (1, 4096, 112, 2, 64, torch.bfloat16, False),
    (1, 2048, 80, 1, 128, torch.float32, True),
    (1, 1024, 80, 1, 128, torch.bfloat16, False),
    (1, 1024, 56, 2, 64, torch.bfloat16, False),
    (2, 128, 16, 2, 64, torch.float32, True),
    (1, 200, 8, 1, 128, torch.bfloat16, True),
    (2, 200, 24, 4, 64, torch.float32, False),
    (1, 251, 16, 2, 64, torch.float32, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,S,H,G,N,dtype,with_fin", KERNEL_CASES)
def test_kernel_matches_the_float64_oracle(cuda_device, b, S, H, G, N,
                                           dtype, with_fin):
    """y, the final state, dx, ddt, dA, dB, dC and dD through the route on
    the card against `ssd_recurrent_oracle` and its autograd in float64 on
    the same inputs; one forward and one backward call by the counters."""
    ins, dy, dfin = _inputs(b, S, H, G, N, dtype, cuda_device, seed=S + H)
    dfin = dfin if with_fin else None
    chunk = min(256, S)
    xs = [t.detach().requires_grad_(True) for t in ins]
    before = (ssk.launches, ssk.bwd_launches)
    y, fin = mamba2.ssd_scan(*xs, chunk=chunk)
    loss = (y.float() * dy.float()).sum()
    if dfin is not None:
        loss = loss + (fin * dfin).sum()
    grads = torch.autograd.grad(loss, xs)
    torch.cuda.synchronize()
    assert (ssk.launches - before[0], ssk.bwd_launches - before[1]) == (1, 1)
    assert y.dtype == dtype and fin.dtype == torch.float32
    (y64, fin64), g64 = _oracle_grads(ins, dy, dfin)
    _within(y, y64, "y", dtype)
    _within(fin, fin64, "final", dtype)
    for name, a, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), grads,
                          g64):
        assert a.dtype == xs[("dx", "ddt", "dA", "dB", "dC", "dD").index(
            name)].dtype
        _within(a, w, name, dtype)


@pytest.mark.cuda
def test_kernel_repeats_its_bits_and_matches_the_plain_version(cuda_device):
    """No atomics: a relaunch gives the same bits. In f32 the kernel and
    `ssd_chunked` on the card differ by f32 rounding only."""
    ins, dy, _ = _inputs(1, 1024, 112, 2, 64, torch.float32, cuda_device,
                         seed=5)
    y, fin, cum, hst = ssk._fwd_launch(*ins, 256)
    again = ssk._fwd_launch(*ins, 256)
    assert all(torch.equal(a, b_) for a, b_ in zip((y, fin, cum, hst),
                                                   again))
    g1 = ssk._bwd_launch(*ins, cum, hst, dy, None, 256)
    g2 = ssk._bwd_launch(*ins, cum, hst, dy, None, 256)
    assert all(torch.equal(a, b_) for a, b_ in zip(g1, g2))
    y0, fin0 = mamba2.ssd_chunked(*ins, chunk=256)
    for a, w in ((y, y0), (fin, fin0)):
        assert float((a - w).abs().max()) <= LIMIT * float(w.abs().max())


@pytest.mark.cuda
def test_wrapper_raises_on_inputs_it_does_not_take(cuda_device):
    before = (ssk.launches, ssk.bwd_launches)
    for kw, match in (({"P": 32}, "head_dim"), ({"N": 16}, "state")):
        ins, _, _ = _inputs(1, 256, 4, 2, kw.get("N", 64), torch.bfloat16,
                            cuda_device, P=kw.get("P", 64))
        with pytest.raises(ValueError, match=match):
            mamba2.ssd_scan(*ins, chunk=256)
    ins, _, _ = _inputs(1, 512, 4, 2, 64, torch.float16, cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        mamba2.ssd_scan(*ins, chunk=256)
    ins, _, _ = _inputs(1, 512, 4, 2, 64, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="chunk"):
        mamba2.ssd_scan(*ins, chunk=512)
    assert (ssk.launches, ssk.bwd_launches) == before


@pytest.mark.cuda
def test_mamba2_layers_train_through_the_kernel(cuda_device):
    """mamba2-2.7b at full width, 2 layers, bf16, remat full, one train
    step at 1 x 1024 under the profiler: by the counters two forward calls
    a layer (the forward and its recompute) and one backward call, inside
    the range `ssd`."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.configs.base import PEFTConfig, TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build
    from repro_torch.train import step as ts
    cfg = configs.get("mamba2-2.7b").replace(num_layers=2)
    model = build(cfg, PEFTConfig(n=1000, alpha=300.0), remat="full")
    params = model.init(0, cuda_device)
    batch = {k: t.to(cuda_device) for k, t in SyntheticLM(
        vocab=cfg.vocab, batch=1, seq=1024).batch_at(0).items()}
    state, frozen = ts.state_from_params(model, params)
    step = ts.make_train_step(model, TrainConfig())
    state, metrics = step(state, frozen, batch)
    torch.cuda.synchronize()
    before = (ssk.launches, ssk.bwd_launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, metrics = step(state, frozen, batch)
        torch.cuda.synchronize()
    assert math.isfinite(float(metrics["loss"]))
    assert (ssk.launches - before[0], ssk.bwd_launches - before[1]) == (4, 2)
    assert "repro_torch/ssd" in {e.name for e in prof.events()}
