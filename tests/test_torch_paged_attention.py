"""The port's paged decode attention against the JAX package's Pallas kernel.

Inputs are built as `tests/test_paged_attention.py` builds them, from numpy
seeds, and fed to both packages: the port's plain version (block-table
gather + dense ragged attention, windowed for W > 1) against
`paged_attention_pallas` in interpret mode and `paged_attention_einsum` at
atol/rtol 1e-5 in f32 (the JAX suite's) and 2e-2 in bf16, over seeds 0-3,
MHA (G = 1), the kv_len edges (1, the full window, one page), windows
W = 2, 5, 9 and head dims 16, 80, 112. The split-KV algorithm of the CUDA
kernel is emulated in torch with the wrapper's own planner and held to the
plain version at 1e-6. The CUDA kernel itself is held against the plain
version on the card by tests/test_torch_cuda_kernels.py and
chip_smoke.py."""
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



def _einsum(q, kp, vp, bt, kv_len):
    return np.asarray(jax_pa.paged_attention_einsum(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(kv_len)))


def _plain(q, kp, vp, bt, kv_len):
    return pa.paged_attention(*(torch.from_numpy(a) for a in
                                (q, kp, vp, bt, kv_len))).numpy()


@pytest.mark.parametrize("W", [2, 5, 9])
def test_window_matches_jax_kernel_and_einsum(W):
    """W > 1 (draft verification): row j sees columns < kv_len + j."""
    case = _case(20 + W, W=W)
    mine, theirs = _both(*case)
    np.testing.assert_allclose(mine, theirs, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(mine, _einsum(*case), atol=1e-5, rtol=1e-5)


def test_window_ragged_edges():
    """W = 5 at kv_len 1, the full span - W + 1 (the last row sees every
    column), and one page."""
    q, kp, vp, bt, _ = _case(31, W=5)
    pps, ps = bt.shape[1], kp.shape[1]
    kv_len = np.asarray([1, pps * ps - 5 + 1, ps], np.int32)
    mine, theirs = _both(q, kp, vp, bt, kv_len)
    np.testing.assert_allclose(mine, theirs, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(mine, _einsum(q, kp, vp, bt, kv_len),
                               atol=1e-5, rtol=1e-5)
    assert not np.isnan(mine).any()


def test_window_mha():
    case = _case(33, H=4, K=4, W=3)
    mine, theirs = _both(*case)
    np.testing.assert_allclose(mine, theirs, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(mine, _einsum(*case), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dh", [16, 80, 112])
def test_head_dims_the_reference_takes(dh):
    """configs.reduced's 16, and 80 and 112 (zamba2-7b), which the kernel
    once refused."""
    case = _case(40 + dh, dh=dh, W=2)
    mine, theirs = _both(*case)
    np.testing.assert_allclose(mine, theirs, atol=1e-5, rtol=1e-5)
    case = _case(41 + dh, dh=dh)
    mine, theirs = _both(*case)
    np.testing.assert_allclose(mine, theirs, atol=1e-5, rtol=1e-5)


def test_single_query_window_is_the_single_query_path_bitwise():
    """At W = 1 the plain version is `direct_attention` on the gathered
    window, bit for bit, and so is `windowed_decode_attention`."""
    q, kp, vp, bt, kv_len = (torch.from_numpy(a) for a in _case(50))
    B, pps = bt.shape
    ps = kp.shape[1]
    k = kp[bt.long()].reshape(B, pps * ps, *kp.shape[2:])
    v = vp[bt.long()].reshape(B, pps * ps, *vp.shape[2:])
    single = attn_mod.direct_attention(q, k, v, causal=False, kv_len=kv_len)
    assert torch.equal(pa.paged_attention(q, kp, vp, bt, kv_len), single)
    assert torch.equal(attn_mod.windowed_decode_attention(q, k, v, kv_len),
                       single)


# ---------------------------------------------------------------------------
# The CUDA kernel's split-KV algorithm, emulated in torch
# ---------------------------------------------------------------------------

def _emulate_split_kv(q, kp, vp, bt, kv_len, plan, chunk=8):
    """csrc/paged_attention.cu's arithmetic in f32: per split of
    `pa.split_ranges`, an online softmax over chunks of `chunk` keys (the
    kernel stages 16 to 64; the result does not depend on it), masked
    columns getting probability exactly 0, then the splits combined in
    order, dividing by max(l, 1e-30)."""
    B, W, H, dh = q.shape
    ps, K = kp.shape[1], kp.shape[2]
    G, pps = H // K, bt.shape[1]
    neg = attn_mod.NEG_INF
    out = torch.zeros_like(q)
    heads = torch.arange(H) // G
    for b in range(B):
        cols = max(0, min(int(kv_len[b]) + W - 1, pps * ps))
        keys = kp[bt[b].long()].reshape(pps * ps, K, dh)[:, heads]  # (T,H,dh)
        vals = vp[bt[b].long()].reshape(pps * ps, K, dh)[:, heads]
        lim = int(kv_len[b]) + torch.arange(W)[:, None, None]        # (W,1,1)
        parts = []
        for k0, k1 in pa.split_ranges(plan, ps, cols):
            m = torch.full((W, H), neg)
            l = torch.zeros((W, H))
            acc = torch.zeros((W, H, dh))
            for c0 in range(k0, k1, chunk):
                t = torch.arange(c0, min(c0 + chunk, k1))
                s = torch.einsum("whd,thd->wht", q[b] * dh ** -0.5, keys[t])
                ok = t[None, None, :] < torch.clamp(lim, max=k1)
                s = torch.where(ok, s, torch.full_like(s, neg))
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.where(ok, torch.exp(s - m_new[..., None]),
                                torch.zeros_like(s))
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum("wht,thd->whd", p,
                                                           vals[t])
                m = m_new
            parts.append((m, l, acc))
        if not parts:
            continue
        M = torch.stack([p_[0] for p_ in parts]).amax(0)
        L = sum(torch.exp(m_ - M) * l_ for m_, l_, _ in parts)
        acc = sum(torch.exp(m_ - M)[..., None] * a_ for m_, _, a_ in parts)
        out[b] = acc / torch.clamp(L, min=1e-30)[..., None]
    return out


@pytest.mark.parametrize("splits", [1, 2, 3, "pps"])
def test_split_kv_emulation_matches_plain(splits):
    """The kernel's algorithm with the wrapper's planner forced to S splits
    (one split per page at S = PPS) equals the plain version at 1e-6, with
    W = 2 and kv_len chosen so a split holds only a column row 0 cannot
    see (an empty split for that row), a slot whose later splits never run,
    and a kv_len 0 slot: its row 0 sees nothing and is 0, as in the Pallas
    kernel (the plain version's softmax of an all-masked row is uniform)."""
    B, W, H, K, dh, ps, pps = 4, 2, 8, 2, 16, 4, 6
    q, kp, vp, bt, _ = (torch.from_numpy(a) for a in _case(
        60, B=B, H=H, K=K, dh=dh, n_pages=14, ps=ps, pps=pps, W=W))
    S = pps if splits == "pps" else splits
    plan = pa.split_plan(B, W, H, K, ps, pps, False, 132, 2, splits=S)
    assert plan.splits == S
    span = plan.pages_per_split * ps
    kv_len = torch.tensor([span if S > 1 else 5, 1, pps * ps - W + 1, 0],
                          dtype=torch.int32)
    emu = _emulate_split_kv(q, kp, vp, bt, kv_len, plan)
    ref = pa.paged_attention_reference(q, kp, vp, bt, kv_len)
    sees = (kv_len[:, None] + torch.arange(W)[None, :]) > 0       # (B, W)
    np.testing.assert_allclose(emu[sees].numpy(), ref[sees].numpy(),
                               atol=1e-6, rtol=1e-6)
    assert bool((emu[~sees] == 0).all())
    theirs = jax_pa.paged_attention_pallas(
        *(jnp.asarray(t.numpy()) for t in (q, kp, vp, bt, kv_len)),
        interpret=True)
    np.testing.assert_allclose(emu.numpy(), np.asarray(theirs), atol=1e-5,
                               rtol=1e-5)


def test_split_ranges_cover_the_columns_once():
    plan = pa.split_plan(2, 1, 8, 2, 16, 10, True, 132, 3, splits=3)
    assert (plan.splits, plan.pages_per_split) == (3, 4)
    for cols in (0, 1, 63, 64, 65, 160):
        ranges = pa.split_ranges(plan, 16, cols)
        covered = [t for k0, k1 in ranges for t in range(k0, k1)]
        assert covered == list(range(cols))
        assert all(k0 < k1 for k0, k1 in ranges)
    assert pa.split_ranges(pa.split_plan(2, 1, 8, 2, 16, 10, True, 132, 3,
                                         splits=1), 16, 0) == [(0, 0)]


@pytest.mark.parametrize("B,W,pps,bf16", [(8, 1, 8, True), (8, 1, 256, True),
                                          (32, 1, 128, True),
                                          (8, 5, 256, True),
                                          (8, 1, 256, False),
                                          (8, 5, 256, False)])
def test_split_plan_fills_the_card_once(B, W, pps, bf16):
    """yi-6b geometry (H 32, K 4, dh 128, page 16): short contexts take one
    split (no combine); long ones as many splits as fill every SM with the
    blocks that fit it (as the card reported them for these instances),
    never a second wave, and none shorter than MIN_SPLIT_KEYS rows."""
    per_sm = 3 if bf16 and W == 1 else 2
    plan = pa.split_plan(B, W, 32, 4, 16, pps, bf16, 132, per_sm)
    blocks = B * 4 * plan.row_groups * plan.splits
    slots = 132 * per_sm
    assert plan.blocks_per_sm == per_sm
    assert blocks <= slots or plan.splits == 1
    assert plan.splits * plan.pages_per_split >= pps
    assert (plan.splits - 1) * plan.pages_per_split < pps
    if pps * 16 <= pa.MIN_SPLIT_KEYS:
        assert plan.splits == 1
    else:
        assert plan.pages_per_split * 16 >= pa.MIN_SPLIT_KEYS
        assert blocks + B * 4 * plan.row_groups > slots \
            or plan.pages_per_split * 16 < 2 * pa.MIN_SPLIT_KEYS


@pytest.mark.parametrize("H,K,W", [(32, 4, 1), (32, 4, 5), (32, 4, 9),
                                   (64, 8, 8), (64, 1, 1), (8, 8, 3),
                                   (3, 3, 1), (71, 1, 1), (28, 4, 5)])
@pytest.mark.parametrize("bf16", [True, False])
def test_row_groups_balance_the_query_rows(H, K, W, bf16):
    """The G·W query rows of a kv-head go in balanced groups no wider than
    the kernel instance takes (MAX_ROWS), none of them empty."""
    R = (H // K) * W
    rows, groups = pa.row_groups(H, K, W, bf16)
    assert rows <= pa.MAX_ROWS[bf16]
    assert rows * groups >= R > (groups - 1) * rows
    assert rows == -(-R // groups)
    plan = pa.split_plan(2, W, H, K, 16, 8, bf16, 132, 2)
    assert (plan.rows, plan.row_groups) == (rows, groups)


@pytest.mark.parametrize("splits,nrows,dh", [(3, 9, 64), (2, 8, 128),
                                             (5, 71, 16), (12, 256, 112),
                                             (1, 1, 1)])
def test_work_numel_aligns_the_accumulators(splits, nrows, dh):
    """The workspace holds (max, denominator) per split and row, padded so
    the accumulators after them start on a 16-byte boundary (the combine
    reads them as float4), then the accumulators."""
    n = pa.work_numel(splits, nrows, dh)
    ml = n - splits * nrows * dh
    assert ml % 4 == 0 and splits * nrows * 2 <= ml < splits * nrows * 2 + 4
