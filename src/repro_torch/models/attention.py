"""GQA attention in plain PyTorch: the direct path (prefill and dense-cache
decode, with ragged per-slot kv_len), the multi-query decode window
(`windowed_decode_attention`, the plain form of the paged kernel at W > 1)
and the shared-prefix tail-prefill path for the paged cache
(`prefix_attention`).

Long sequences: `attention` switches from the direct path (which builds
every (S, S) score) to `flash_attention` above `direct_threshold` rows when
S is a multiple of the chunk, and to `chunked_attention` otherwise, as the
JAX package does. Both are the JAX package's algorithms in plain PyTorch
(online softmax over kv blocks, one (B, K, G, chunk, chunk) f32 score block
alive at a time); `flash_attention` is an autograd Function whose backward
recomputes each block's probabilities from the saved row max and
denominator instead of keeping them.

Up to `direct_threshold` rows, bf16 inputs on the card take the fused
kernel instead (`kernels/fused_attention.py`: the direct path's arithmetic
tile by tile, no (S, S) tensor in device memory); f32 inputs, other head
dims and CPU tensors take `direct_attention`. The route follows the
inputs alone.

Layouts are the JAX package's: q (B, Sq, H, dh), k/v (B, Skv, K, dh).
Scores and softmax are f32; the direct paths cast probabilities to v's
dtype before the value product, as `repro.models.attention` does, and the
blocked paths multiply f32 probabilities by v in f32, as it does there.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.core.spans import span
from repro_torch.kernels import fused_attention as fused_mod

NEG_INF = -1e30


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,Tq,K,G,dh), k (B,Tk,K,dh) -> (B,K,G,Tq,Tk) f32."""
    return torch.einsum("bqkgd,btkd->bkgqt", q.to(torch.float32),
                        k.to(torch.float32))


def _softmax_value(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype), v)


def direct_attention(q, k, v, *, causal: bool = True,
                     q_offset: Union[int, torch.Tensor] = 0,
                     kv_len: Optional[Union[int, torch.Tensor]] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q (B,Sq,H,dh), k/v (B,Skv,K,dh). Suitable for small S and for decode.

    kv_len: optional valid-KV length (positions >= kv_len are masked); a
    scalar for the whole batch or a (B,) tensor masking each row at its own
    length (continuous-batching decode). q_offset: global position of q[0]
    for the causal mask. scale: the scores' factor (None: dh ** -0.5)."""
    B, Sq, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    scale = dh ** -0.5 if scale is None else scale
    qs = q.reshape(B, Sq, K, G, dh) * scale
    s = _gqa_scores(qs, k)                                   # (B,K,G,Sq,Skv)
    Skv = k.shape[1]
    kv_pos = torch.arange(Skv, device=q.device)
    mask = None
    if causal:
        q_pos = torch.arange(Sq, device=q.device) + q_offset
        mask = q_pos[:, None] >= kv_pos[None, :]
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=q.device)
        if kv_len.ndim == 1:       # per-slot: broadcast over (K, G, Sq)
            kv_len = kv_len.reshape(B, 1, 1, 1, 1)
        valid = kv_pos[None, :] < kv_len
        mask = valid if mask is None else (mask & valid)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return _softmax_value(s, v).reshape(B, Sq, H, dh)


def windowed_decode_attention(q, k, v, kv_len) -> torch.Tensor:
    """Decode attention for a window of W consecutive queries per slot (the
    last accepted token plus W-1 draft tokens, for draft verification):
    q (B,W,H,dh), k/v (B,Skv,K,dh) the cache after the window's own rows
    were written, kv_len (B,) the valid length seen by query row 0. Row j
    sees the j window rows before it:

        query j attends columns  c < kv_len + j

    the mask a step-by-step decode would apply. Masked columns contribute
    exact zeros; a row that sees no column (kv_len + j == 0) is uniform
    over the window, as the JAX package's softmax of all-masked scores
    is."""
    B, W, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    scale = dh ** -0.5
    qs = q.reshape(B, W, K, G, dh) * scale
    s = _gqa_scores(qs, k)                                   # (B,K,G,W,Skv)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    lim = (torch.as_tensor(kv_len, device=q.device).reshape(B, 1, 1, 1, 1)
           + torch.arange(W, device=q.device).reshape(1, 1, 1, W, 1))
    s = torch.where(kv_pos < lim, s, torch.full_like(s, NEG_INF))
    return _softmax_value(s, v).reshape(B, W, H, dh)


def prefix_attention(q, k, v, kw, vw, prefix_len) -> torch.Tensor:
    """Tail-prefill attention for shared-prefix paged serving: `q`/`k`/`v`
    are the Sq tail rows of a prompt whose first `prefix_len` tokens are
    already resident as KV in `kw`/`vw` (the page window gathered through
    the slot's block table, (B, W, K, dh), W >= prefix_len; columns >=
    prefix_len are dirt and masked). Tail row i (global position
    prefix_len + i) attends every valid window column and tail columns
    j <= i."""
    B, Sq, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    W = kw.shape[1]
    scale = dh ** -0.5
    qs = q.reshape(B, Sq, K, G, dh) * scale
    k_all = torch.cat([kw.to(k.dtype), k], dim=1)
    v_all = torch.cat([vw.to(v.dtype), v], dim=1)
    s = _gqa_scores(qs, k_all)                       # (B,K,G,Sq,W+Sq)
    col = torch.arange(W + Sq, device=q.device)
    qpos = torch.arange(Sq, device=q.device)
    win_ok = (col[None, :] < prefix_len).expand(Sq, W + Sq)
    tail_ok = (col[None, :] - W) <= qpos[:, None]
    mask = torch.where(col[None, :] < W, win_ok, tail_ok)
    s = torch.where(mask[None, None, None], s, torch.full_like(s, NEG_INF))
    return _softmax_value(s, v_all).reshape(B, Sq, H, dh)


def _blocks(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, S, ...) -> (nb, B, chunk, ...): block i is rows i*chunk.."""
    B, S = x.shape[:2]
    return x.reshape(B, S // chunk, chunk, *x.shape[2:]).transpose(0, 1)


def _tri(chunk: int, device) -> torch.Tensor:
    """The diagonal block's additive mask: 0 on and below the diagonal,
    NEG_INF above it."""
    idx = torch.arange(chunk, device=device)
    return torch.where(idx[:, None] >= idx[None, :],
                       torch.zeros((), device=device),
                       torch.full((), NEG_INF, device=device))


def chunked_attention(q, k, v, *, causal: bool = True, chunk_q: int = 512,
                      chunk_kv: Optional[int] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """The flash-attention algorithm over q blocks and, inside each, kv
    blocks with a running (max, denominator, accumulator): `flash_attention`'s
    forward loop. Peak memory is one (B,K,G,Tq,Tk) score block. Causal: the
    triangular constant is added on diagonal blocks only, and blocks past
    the diagonal (whose probabilities are exact zeros in the JAX package's
    masked scan) are not visited. Falls back to `direct_attention` when S
    is not a multiple of the chunk. Autograd differentiates through the
    loop (it keeps every block's probabilities); `flash_attention` is the
    path that does not."""
    chunk_kv = chunk_q if chunk_kv is None else chunk_kv
    if chunk_q != chunk_kv:
        raise ValueError("diagonal-block masking needs equal chunks")
    if q.shape[1] % chunk_q:
        return direct_attention(q, k, v, causal=causal, scale=scale)
    return _flash_fwd(q, k, v, causal, chunk_q, scale)[0]


def _tri_pairs(nq: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(iq, jk) index tensors covering jk <= iq, ordered by iq then jk:
    exactly the nq(nq+1)/2 causal block pairs (the JAX package's scan
    order; `flash_attention` visits the same pairs by looping over q
    blocks and then over kv blocks up to the diagonal)."""
    pairs = [(i, j) for i in range(nq) for j in range(i + 1)]
    return (torch.tensor([p[0] for p in pairs], dtype=torch.int32),
            torch.tensor([p[1] for p in pairs], dtype=torch.int32))


def _flash_fwd(q, k, v, causal: bool, chunk: int,
               scale: Optional[float] = None):
    """-> (out in v's dtype, m, l), m and l (nq, B, K, G, chunk) f32: the
    final row max and softmax denominator of each q block."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    nq = S // chunk
    scale = dh ** -0.5 if scale is None else scale
    qb = _blocks(q.reshape(B, S, K, G, dh), chunk)
    kb, vb = _blocks(k, chunk), _blocks(v, chunk)
    tri = _tri(chunk, q.device)
    f32 = torch.float32
    outs, ms, ls = [], [], []
    for iq in range(nq):
        m = torch.full((B, K, G, chunk), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((B, K, G, chunk), dtype=f32, device=q.device)
        acc = torch.zeros((B, K, G, chunk, dh), dtype=f32, device=q.device)
        for jk in range(iq + 1 if causal else nq):
            s = _gqa_scores(qb[iq], kb[jk]) * scale           # (B,K,G,Tq,Tk)
            if causal and jk == iq:
                s = s + tri
            # one kv block of the online softmax
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = (acc * corr[..., None]
                   + torch.einsum("bkgqt,btkd->bkgqd", p, vb[jk].to(f32)))
            m = m_new
        out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(v.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4))
        ms.append(m)
        ls.append(l)
    out = torch.cat(outs, dim=1).reshape(B, S, H, dh)
    return out, torch.stack(ms), torch.stack(ls)


def _flash_bwd(q, k, v, out, m, l, do, causal: bool, chunk: int,
               scale: Optional[float] = None):
    """The JAX package's `_flash_bwd`: per block pair, p is recomputed from
    the saved (m, l); dq accumulates per q block, dk/dv per kv block (f32),
    with D = rowsum(do · o) taken against the output in v's dtype."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    nq = S // chunk
    scale = dh ** -0.5 if scale is None else scale
    f32 = torch.float32
    qb = _blocks(q.reshape(B, S, K, G, dh), chunk)
    kb, vb = _blocks(k, chunk), _blocks(v, chunk)
    dob = _blocks(do.reshape(B, S, K, G, dh), chunk)
    ob = _blocks(out.reshape(B, S, K, G, dh), chunk)
    D = torch.einsum("nbqkgd,nbqkgd->nbkgq", dob.to(f32), ob.to(f32))
    tri = _tri(chunk, q.device)
    dk = torch.zeros((nq, B, chunk, K, dh), dtype=f32, device=q.device)
    dv = torch.zeros_like(dk)
    dqs = []
    for iq in range(nq):
        qf, dof = qb[iq].to(f32), dob[iq].to(f32)
        li = torch.clamp(l[iq], min=1e-30)[..., None]
        dq = torch.zeros((B, chunk, K, G, dh), dtype=f32, device=q.device)
        for jk in range(iq + 1 if causal else nq):
            kf, vf = kb[jk].to(f32), vb[jk].to(f32)
            s = _gqa_scores(qb[iq], kb[jk]) * scale           # (B,K,G,Tq,Tk)
            if causal and jk == iq:
                s = s + tri
            p = torch.exp(s - m[iq][..., None]) / li
            dp = torch.einsum("bqkgd,btkd->bkgqt", dof, vf)
            ds = p * (dp - D[iq][..., None])
            dq = dq + scale * torch.einsum("bkgqt,btkd->bqkgd", ds, kf)
            dk[jk] += scale * torch.einsum("bkgqt,bqkgd->btkd", ds, qf)
            dv[jk] += torch.einsum("bkgqt,bqkgd->btkd", p, dof)
        dqs.append(dq)
    dq = torch.stack(dqs).transpose(0, 1).reshape(B, S, H, dh)
    return (dq.to(q.dtype),
            dk.transpose(0, 1).reshape(B, S, K, dh).to(k.dtype),
            dv.transpose(0, 1).reshape(B, S, K, dh).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, chunk, scale):
        out, m, l = _flash_fwd(q, k, v, causal, chunk, scale)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.causal, ctx.chunk, ctx.scale = causal, chunk, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, m, l = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, m, l, do, ctx.causal,
                                ctx.chunk, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, chunk: int = 512,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Blocked attention with a recomputing backward (the JAX package's
    `custom_vjp` flash attention): the forward visits the causal block
    pairs only and saves (q, k, v, out, m, l); the backward recomputes each
    block's probabilities. S must be a multiple of `chunk`."""
    if q.shape[1] % chunk:
        raise ValueError(f"flash_attention needs S ({q.shape[1]}) to be a "
                         f"multiple of the chunk ({chunk})")
    return _FlashAttention.apply(q, k, v, causal, chunk, scale)


def attention(q, k, v, *, causal: bool = True, direct_threshold: int = 1024,
              chunk: int = 512, flash: bool = True,
              scale: Optional[float] = None) -> torch.Tensor:
    """Full-sequence attention with the JAX package's switch: direct up to
    `direct_threshold` rows (the fused kernel where it takes the inputs:
    bf16 on the card, at the default scale dh ** -0.5, the one it
    computes), then flash when S is a multiple of `chunk`, else chunked
    (which itself falls back to direct for such S). `scale` multiplies the
    scores (None: dh ** -0.5). Under a profiler, forward and backward lie
    in the range `attention/<path>`."""
    S = q.shape[1]
    if S <= direct_threshold and scale is None and fused_mod.takes(q, k, v):
        with span("attention/fused") as sp:
            out = fused_mod.fused_attention(q, k, v, causal)
    elif S <= direct_threshold:
        with span("attention/direct") as sp:
            out = direct_attention(q, k, v, causal=causal, scale=scale)
    elif flash and S % chunk == 0:
        with span("attention/flash") as sp:
            out = flash_attention(q, k, v, causal, chunk, scale)
    else:
        with span("attention/chunked") as sp:
            out = chunked_attention(q, k, v, causal=causal, scale=scale)
    sp.backward(out)
    return out
