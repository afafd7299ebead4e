"""GQA attention in plain PyTorch: the direct path (prefill and dense-cache
decode, with ragged per-slot kv_len), the multi-query decode window
(`windowed_decode_attention`, the plain form of the paged kernel at W > 1)
and the shared-prefix tail-prefill path for the paged cache
(`prefix_attention`).

Layouts are the JAX package's: q (B, Sq, H, dh), k/v (B, Skv, K, dh).
Scores and softmax are f32; probabilities are cast to v's dtype before the
value product, as `repro.models.attention` does. The JAX package's
scan-based `flash_attention` (long training sequences) comes with a later
slice.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

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
                     kv_len: Optional[Union[int, torch.Tensor]] = None
                     ) -> torch.Tensor:
    """q (B,Sq,H,dh), k/v (B,Skv,K,dh). Suitable for small S and for decode.

    kv_len: optional valid-KV length (positions >= kv_len are masked); a
    scalar for the whole batch or a (B,) tensor masking each row at its own
    length (continuous-batching decode). q_offset: global position of q[0]
    for the causal mask."""
    B, Sq, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    scale = dh ** -0.5
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


def attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Full-sequence attention. The JAX package switches to its scan-based
    flash attention above 1024 rows; this slice serves short prompts and
    always takes the direct path."""
    return direct_attention(q, k, v, causal=causal)
