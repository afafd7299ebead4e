"""The host-side plan of the FFT-structured K1/K2 kernels
(`repro_torch.kernels.fft_plan`) and their algorithm, on the CPU.

The kernels themselves run only on the card (tests/test_torch_cuda_kernels.py).
Here the plan is checked for every site shape of the four configured archs,
and a numpy emulation of the kernels' steps — K1's scatter plan (direct
and mirrored entries in collision-free rounds), the Hermitian pairing of
two rows per complex transform, the in-place decimation-in-time and
decimation-in-frequency stages on the plan's radices, digit-reversed
positions and stage twiddles, K2's per-entry gather — is held against the
plain versions `deltaw_reference` and `dc_reference` and against `np.fft`."""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.fourierft import sample_entries
from repro_torch.kernels import dct_deltaw as ddk
from repro_torch.kernels import fft_plan as fp
from repro_torch.kernels import fourier_deltaw as fdk
from repro_torch.models.registry import adapter_sites

ARCHS = ("yi-6b", "yi-9b", "qwen3-4b", "qwen2.5-32b")


def _site_shapes():
    """(arch, site, d1, d2) of every adapter site, and the transposed
    (d2, d1) of the MLP site (the down projection's shape)."""
    out = []
    for arch in ARCHS:
        for s in adapter_sites(configs.get(arch)):
            out.append((arch, s.name, s.d_in, s.d_out))
            if s.name == "layers/wi":
                out.append((arch, "layers/w2", s.d_out, s.d_in))
    return out


@pytest.mark.parametrize("arch,site,d1,d2", _site_shapes())
def test_plan_takes_every_site_shape(arch, site, d1, d2):
    plan = fp.fft_plan(d1, d2, 1008)
    assert int(np.prod(plan.radices)) == d2
    assert all(r in (2, 4, 8) or (r % 2 and 3 <= r <= fp.MAX_RADIX)
               for r in plan.radices)
    assert len(plan.radices) <= fp.MAX_STAGES
    assert plan.smem_bytes == 8 * fp.row_words(d2, plan.shift) * plan.pairs
    assert plan.smem_bytes <= fp.SMEM_BYTES
    # padded wherever the padded rows fit
    assert (plan.shift == fp.PAD_SHIFT) == (
        8 * fp.row_words(d2, fp.PAD_SHIFT) * plan.pairs <= fp.SMEM_BYTES)
    assert plan.pairs in (1, 2, 4, 8) and plan.pairs <= fp.MAX_PAIRS
    # K2's row blocks cover the rows once, each block at least one row
    rows = 2 * plan.pairs * plan.k2_slabs
    assert plan.k2_row_blocks == -(-d1 // rows) <= fp.K2_ROW_BLOCKS
    assert (plan.k2_row_blocks - 1) * rows < d1
    ints = plan.as_ints()
    assert len(ints) == fp.PLAN_INTS and ints[0] == len(plan.radices)
    pos = fp.digit_reverse(plan.radices)
    assert pos.dtype == np.int32
    assert np.array_equal(np.sort(pos), np.arange(d2))


@pytest.mark.parametrize("d2,radices", [
    (1, ()), (7, (7,)), (96, (3, 8, 4)), (512, (8, 8, 8)),
    (520, (5, 13, 8)), (1024, (8, 8, 4, 4)), (2560, (5, 8, 8, 8)),
    (4096, (8, 8, 8, 8)), (9728, (19, 8, 8, 8)), (11008, (43, 8, 8, 4)),
    (27648, (3, 3, 3, 8, 8, 4, 4))])
def test_factor(d2, radices):
    assert fp.factor(d2) == radices


@pytest.mark.parametrize("d1,d2,n,limit", [
    (64, fp.MAX_D2 + 2, 16, "29056"), (64, 67, 16, "63"),
    (64, 2 * 3 * 71, 16, "63"), (fp.MAX_D1 + 1, 64, 16, "65535"),
    (64, 64, fp.MAX_N + 16, "16384"), (64, 0, 16, "29056")])
def test_plan_raises_beyond_its_limits(d1, d2, n, limit):
    with pytest.raises(ValueError, match=limit):
        fp.fft_plan(d1, d2, n)


def _stages(buf, radices, dif):
    """The kernels' in-place stages (fft_smem.cuh) on the last axis, sign
    +1, without normalisation: DIT runs stages 0..S-1 (twiddle, then
    butterfly), DIF stages S-1..0 (butterfly, then twiddle)."""
    N = buf.shape[-1]
    span = [int(np.prod(radices[:s])) for s in range(len(radices))]
    order = range(len(radices) - 1, -1, -1) if dif else range(len(radices))
    for s in order:
        r, m = radices[s], span[s]
        x = buf.reshape(buf.shape[:-1] + (N // (m * r), r, m))
        q, k = np.arange(r), np.arange(m)
        tw = np.exp(2j * np.pi * np.outer(q, k) / (m * r))
        root = np.exp(2j * np.pi * np.outer(q, q) / r)
        if dif:
            x = np.einsum("pq,...qk->...pk", root, x) * tw
        else:
            x = np.einsum("pq,...qk->...pk", root, x * tw)
        buf = x.reshape(buf.shape)
    return buf


@pytest.mark.parametrize("d2", [1, 7, 96, 520, 2560, 11008, 27648])
def test_stages_compute_the_transform(d2):
    """DIT on x at the digit-reversed positions and DIF on x in natural
    order (X read at pos) both give sum_k x[k] exp(+2πi tk/d2)."""
    radices = fp.factor(d2)
    pos = fp.digit_reverse(radices)
    rng = np.random.default_rng(d2)
    x = rng.normal(size=(2, d2)) + 1j * rng.normal(size=(2, d2))
    want = np.fft.ifft(x, axis=-1) * d2
    buf = np.zeros_like(x)
    buf[:, pos] = x
    np.testing.assert_allclose(_stages(buf, radices, dif=False), want,
                               atol=1e-9 * d2)
    np.testing.assert_allclose(_stages(x, radices, dif=True)[:, pos], want,
                               atol=1e-9 * d2)


@pytest.mark.parametrize("d2", [7, 96, 520, 4096, 11008, 27648])
def test_stage_twiddles_are_the_stage_roots(d2):
    """Entry m_s - 1 + (q-1)·m_s + k of the stage table is exp(2πi q·k /
    m_{s+1}); each odd stage's r roots follow the N - 1 stage twiddles."""
    radices = fp.factor(d2)
    w = np.exp(2j * np.pi * fp.stage_twiddles(radices) / d2)
    m, roots = 1, d2 - 1
    for r in radices:
        q, k = np.arange(1, r)[:, None], np.arange(m)[None, :]
        got = w[m - 1 + (q - 1) * m + k]
        np.testing.assert_allclose(got, np.exp(2j * np.pi * q * k / (m * r)),
                                   atol=1e-12)
        if r % 2:
            np.testing.assert_allclose(
                w[roots:roots + r], np.exp(2j * np.pi * np.arange(r) / r),
                atol=1e-12)
            roots += r
        m *= r
    assert len(w) == roots


def _scatter_plan(c, v, d2, live=True):
    """K1's (and K4's) pass 0: virtual entry i < n is entry i at column v_i,
    n + i its mirror at d2 - v_i; entries whose c is 0 in every layer, or
    that `live` marks False, are dropped. Returns the rounds: round r lists
    (virtual entry, column) of the r-th member, by virtual index, of every
    column's bin larger than r."""
    n = len(v)
    keep = (c != 0).any(axis=0) & live
    w = np.mod(v, d2)
    cols = np.concatenate([w, np.mod(-w, d2)])
    bins = {}
    for i in range(2 * n):
        if keep[i % n]:
            bins.setdefault(int(cols[i]), []).append(i)
    rounds = []
    for col, members in sorted(bins.items()):
        for r, i in enumerate(members):
            if r == len(rounds):
                rounds.append([])
            rounds[r].append((i, col))
    return rounds


def _inputs(d1, d2, n, L, seed):
    E = sample_entries(d1, d2, n, seed=seed).numpy()
    npad = -(-n // fdk.NC) * fdk.NC
    u = np.zeros(npad, dtype=np.int32)
    v = np.zeros(npad, dtype=np.int32)
    u[:n], v[:n] = E
    rng = np.random.default_rng(seed + 1)
    c = np.zeros((L, npad), dtype=np.float32)
    c[:, :n] = rng.normal(size=(L, n))
    g = rng.normal(size=(L, d1, d2)).astype(np.float32)
    return u, v, c, g


SHAPES = [(130, 7, 5, 1), (33, 520, 37, 2), (64, 96, 64, 3),
          (17, 512, 600, 1), (6, 27648, 40, 1)]


@pytest.mark.parametrize("d1,d2,n,L", SHAPES)
def test_k1_algorithm_matches_plain(d1, d2, n, L):
    u, v, c, _ = _inputs(d1, d2, n, L, seed=7)
    rounds = _scatter_plan(c, v, d2)
    # every kept virtual entry once; within a round the columns differ
    # (no collisions), and the zero padding is dropped
    slots = [i for rnd in rounds for i, _ in rnd]
    kept = np.flatnonzero((c != 0).any(axis=0))
    assert sorted(slots) == sorted(np.concatenate([kept, kept + len(v)]))
    assert all(len({col for _, col in rnd}) == len(rnd) for rnd in rounds)
    radices = fp.factor(d2)
    pos = fp.digit_reverse(radices)
    rows = d1 + d1 % 2
    theta = 2 * np.pi * np.mod(np.outer(np.arange(rows), u), d1) / d1
    rot = np.exp(1j * theta)
    rot[d1:] = 0                                  # rows past d1 add nothing
    out = np.zeros((L, rows, d2))
    for layer in range(L):
        # Z = 2·(H_j + i·H_{j+1}) per row pair, added round by round
        buf = np.zeros((rows // 2, d2), dtype=complex)
        for rnd in rounds:
            for i, col in rnd:
                e = i % len(v)
                a = c[layer, e] * rot[0::2, e]
                b = c[layer, e] * rot[1::2, e]
                if i >= len(v):
                    a, b = np.conj(a), np.conj(b)
                buf[:, pos[col]] += a + 1j * b
        T = _stages(buf, radices, dif=False)
        out[layer, 0::2], out[layer, 1::2] = T.real, T.imag
    out = 0.5 * (300.0 / (d1 * d2)) * out[:, :d1]
    plain = fdk.deltaw_reference(torch.from_numpy(c), torch.from_numpy(u),
                                 torch.from_numpy(v), d1, d2, 300.0)
    np.testing.assert_allclose(out, plain.numpy(), atol=2e-6)


@pytest.mark.parametrize("d1,d2,n,L", SHAPES)
def test_k2_algorithm_matches_plain(d1, d2, n, L):
    u, v, _, g = _inputs(d1, d2, n, L, seed=9)
    radices = fp.factor(d2)
    pos = fp.digit_reverse(radices)
    gp = np.zeros((L, d1 + d1 % 2, d2))
    gp[:, :d1] = g
    Z = _stages(gp[:, 0::2] + 1j * gp[:, 1::2], radices, dif=True)
    vr = np.mod(v, d2)
    zv, zm = Z[:, :, pos[vr]], Z[:, :, pos[np.mod(-vr, d2)]]     # (L, P, n)
    ha = zv + np.conj(zm)                                          # 2·T(g_a)
    hb = -1j * (zv - np.conj(zm))                                  # 2·T(g_b)
    j = np.arange(gp.shape[1])
    rot = np.exp(2j * np.pi * np.mod(np.outer(j, u), d1) / d1)     # (rows, n)
    dc = (rot[0::2] * ha).real.sum(1) + (rot[1::2] * hb).real.sum(1)
    dc *= 0.5 * 300.0 / (d1 * d2)
    plain = fdk.dc_reference(torch.from_numpy(g), torch.from_numpy(u),
                             torch.from_numpy(v), d1, d2, 300.0)
    np.testing.assert_allclose(dc, plain.numpy(), atol=2e-5,
                               rtol=1e-4)


# K4/K5: the dct method's ΔW and dc on the same plan. A DCT of length N is
# a complex transform of length N with a permutation and a twiddle
# φ_v = exp(iπv/2N); the kernels read φ from the length-4N table.
DCT_CASES = [s + (False,) for s in SHAPES] + [(40, 24, 16, 2, True)]


def _dct_fold(v, d2):
    """Each entry's column v' in [0, d2), sign and liveness: cos(π(2k+1)v/
    2d2) = sign·cos(π(2k+1)v'/2d2); where v ≡ d2 (mod 2d2) the cosine is 0
    for every k, so the entry adds nothing (not live, column 0)."""
    q = np.mod(v.astype(np.int64), 4 * d2)
    sign = np.where(q >= 2 * d2, -1.0, 1.0)
    q = np.where(q >= 2 * d2, q - 2 * d2, q)
    sign = np.where(q > d2, -sign, sign)
    q = np.where(q > d2, 2 * d2 - q, q)
    return np.where(q == d2, 0, q), sign, q != d2


def _dct_place(d2):
    """Where point k of a row sits in the permuted row the transform runs
    on: k even at k/2, k odd at d2 - 1 - (k-1)/2."""
    k = np.arange(d2)
    return np.where(k % 2 == 0, k // 2, d2 - 1 - k // 2)


def _dct_inputs(d1, d2, n, L, seed, edges):
    """`_inputs`, or for `edges` hand-set entries: v = 0 and duplicate
    columns, v ≡ d2 (mod 2d2), negative entries and entries past 4d, and an
    entry whose c is 0 in every layer (as the padding's)."""
    u, v, c, g = _inputs(d1, d2, n, L, seed)
    if edges:
        v = np.array([0, 0, 5, 5, 5, d2, -3, 2 * d2 + 1, 3 * d2 + 7,
                      4 * d2 - 1, 2 * d2, d2 + 1, 7, 7, 0, 11], np.int32)
        u = np.array([0, 3, -1, 4 * d1 + 5, 7, 2, 8, 9, 10, 11, 12, 13, 14,
                      15, 16, 2 * d1], np.int32)
        c[:, -1] = 0
    return u, v, c, g


def _c1(u, d1, rows):
    """C1[j, e] = cos(π((2j+1)·u_e mod 4d1)/2d1) for j < rows, 0 past d1."""
    j = np.arange(rows)[:, None]
    p = np.mod((2 * j + 1) * u.astype(np.int64)[None, :], 4 * d1)
    c1 = np.cos(np.pi * p / (2 * d1))
    c1[d1:] = 0
    return c1


@pytest.mark.parametrize("d1,d2,n,L,edges", DCT_CASES)
def test_k4_algorithm_matches_plain(d1, d2, n, L, edges):
    """K4 as the kernel runs it: K1's rounds on the folded columns (live
    entries only), each slot adding s·c·φ_v (its mirror s·c·conj φ_v) times
    C1 of rows j and j+1 as Re and Im, one DIT transform per row pair, and
    the store reading point k of a row from its permuted place."""
    u, v, c, _ = _dct_inputs(d1, d2, n, L, 11, edges)
    vf, sign, live = _dct_fold(v, d2)
    rounds = _scatter_plan(c, vf, d2, live)
    slots = [i for rnd in rounds for i, _ in rnd]
    kept = np.flatnonzero((c != 0).any(axis=0) & live)
    assert sorted(slots) == sorted(np.concatenate([kept, kept + len(v)]))
    assert all(len({col for _, col in rnd}) == len(rnd) for rnd in rounds)
    radices = fp.factor(d2)
    pos = fp.digit_reverse(radices)
    rows = d1 + d1 % 2
    c1 = _c1(u, d1, rows)
    phi = np.exp(1j * np.pi * vf / (2 * d2))
    out = np.zeros((L, rows, d2))
    for layer in range(L):
        buf = np.zeros((rows // 2, d2), dtype=complex)
        for rnd in rounds:
            for i, col in rnd:
                e = i % len(v)
                cf = sign[e] * c[layer, e] * phi[e]
                if i >= len(v):
                    cf = np.conj(cf)
                buf[:, pos[col]] += cf * (c1[0::2, e] + 1j * c1[1::2, e])
        T = _stages(buf, radices, dif=False)[:, _dct_place(d2)]
        out[layer, 0::2], out[layer, 1::2] = T.real, T.imag
    out = 0.5 * (300.0 / (d1 * d2)) * out[:, :d1]
    plain = ddk.deltaw_reference(torch.from_numpy(c), torch.from_numpy(u),
                                 torch.from_numpy(v), d1, d2, 300.0)
    np.testing.assert_allclose(out, plain.numpy(), atol=2e-6)


@pytest.mark.parametrize("d1,d2,n,L,edges", DCT_CASES)
def test_k5_algorithm_matches_plain(d1, d2, n, L, edges):
    """K5 as the kernel runs it: two rows of g loaded as one complex row at
    the permuted places, one DIF transform, and per entry the two rows'
    C1-weighted halves A = Z[v] + conj Z[d2-v], B = -i·(Z[v] - conj
    Z[d2-v]) summed over the rows, then Re(s·φ_v · sum)."""
    u, v, _, g = _dct_inputs(d1, d2, n, L, 13, edges)
    vf, sign, live = _dct_fold(v, d2)
    radices = fp.factor(d2)
    pos = fp.digit_reverse(radices)
    gp = np.zeros((L, d1 + d1 % 2, d2))
    gp[:, :d1] = g
    w = np.zeros_like(gp)
    w[:, :, _dct_place(d2)] = gp
    Z = _stages(w[:, 0::2] + 1j * w[:, 1::2], radices, dif=True)
    zv, zm = Z[:, :, pos[vf]], Z[:, :, pos[np.mod(-vf, d2)]]      # (L, P, n)
    a = zv + np.conj(zm)                                           # 2·T(w_a)
    b = -1j * (zv - np.conj(zm))                                   # 2·T(w_b)
    c1 = _c1(u, d1, gp.shape[1])
    s = (c1[0::2] * a).sum(1) + (c1[1::2] * b).sum(1)              # (L, n)
    phi = sign * live * np.exp(1j * np.pi * vf / (2 * d2))
    dc = (phi * s).real * (0.5 * 300.0 / (d1 * d2))
    plain = ddk.dc_reference(torch.from_numpy(g), torch.from_numpy(u),
                             torch.from_numpy(v), d1, d2, 300.0)
    np.testing.assert_allclose(dc, plain.numpy(), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("d1,d2,n,limit", [
    (64, fp.MAX_D2 + 2, 16, "29056"), (64, 67, 16, "63"),
    (64, 2 * 3 * 71, 16, "63"), (fp.MAX_D1 + 1, 64, 16, "65535"),
    (64, 64, fp.MAX_N + 16, "16384")])
def test_dct_wrappers_raise_beyond_their_limits(d1, d2, n, limit):
    """K4's and K5's wrappers take the FFT kernels' plan, so a shape beyond
    its limits raises naming the limit before anything is built or
    launched (meta tensors: no card is needed to get that far). Off the CPU only: a CPU tensor takes the plain version at any
    shape. (On the card: tests/test_torch_cuda_kernels.py.)"""
    meta = torch.device("meta")
    u = torch.zeros((n,), dtype=torch.int32, device=meta)
    c = torch.zeros((1, n), dtype=torch.float32, device=meta)
    g = torch.zeros((1, d1, d2), dtype=torch.float32, device=meta)
    before = (ddk.launches, ddk.dc_launches)
    with pytest.raises(ValueError, match=limit):
        ddk.deltaw(c, u, u, d1, d2, 1.0)
    if n <= fp.MAX_N:                   # K5, like K2, takes any n
        with pytest.raises(ValueError, match=limit):
            ddk.dc(g, u, u, d1, d2, 1.0)
    assert (ddk.launches, ddk.dc_launches) == before
    cpu = ddk.deltaw(torch.zeros((1, 16)), torch.zeros(16, dtype=torch.int32),
                     torch.zeros(16, dtype=torch.int32), 4, 67, 1.0)
    assert cpu.shape == (1, 4, 67)
