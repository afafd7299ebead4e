"""Plain PyTorch reference of a dense decoder with per-head RMSNorm on q
and k before RoPE (Qwen3's attention): the decoder reference
(perfbench/reference/decoder.py) with its layer replaced. Float32, TF32
off, as the decoder's."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from reference import decoder
from reference.decoder import (LINEARS, Dims, causal_attention,  # noqa: F401
                               entries_for, plain_linear, precise, rms_norm,
                               rope)

QK_NORM = True


def layer(x: torch.Tensor, lw: Dict, dw: Dict[str, torch.Tensor],
          dims: Dims, lin: Callable, pos: torch.Tensor) -> torch.Tensor:
    """The decoder's pre-norm block, q and k each RMS-normed over its head
    (weights lw["q_norm"], lw["k_norm"]) before the rotation."""
    B, S, _ = x.shape

    def w(name):
        t = lw[name].to(torch.float32)
        return t + dw[name] if name in dw else t

    h = rms_norm(x, lw["attn_norm"], dims.eps)
    q = lin(h, w("wq")).reshape(B, S, dims.H, dims.hd)
    k = lin(h, w("wk")).reshape(B, S, dims.K, dims.hd)
    v = lin(h, w("wv")).reshape(B, S, dims.K, dims.hd)
    if QK_NORM:
        q = rms_norm(q, lw["q_norm"], dims.eps)
        k = rms_norm(k, lw["k_norm"], dims.eps)
    q, k = rope(q, pos, dims.theta), rope(k, pos, dims.theta)
    x = x + lin(causal_attention(q, k, v), w("wo"))
    h = rms_norm(x, lw["mlp_norm"], dims.eps)
    a = torch.nn.functional.silu(lin(h, w("wg"))) * lin(h, w("wi"))
    return x + lin(a, w("wo_mlp"))


def loss_and_grads(*args, **kw):
    return decoder.loss_and_grads(*args, block=layer, **kw)


def logits_at(*args, **kw):
    return decoder.logits_at(*args, block=layer, **kw)
