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


def _scatter_plan(c, v, d2):
    """K1's pass 0: virtual entry i < n is entry i at column v_i, n + i its
    mirror at d2 - v_i; entries whose c is 0 in every layer are dropped.
    Returns the rounds: round r lists (virtual entry, column) of the r-th
    member, by virtual index, of every column's bin larger than r."""
    n = len(v)
    keep = (c != 0).any(axis=0)
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
