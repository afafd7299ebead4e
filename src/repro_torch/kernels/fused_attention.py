"""Fused causal (and non-causal) GQA attention: the hand-written Hopper
kernel, its autograd Function and its plain PyTorch version.

Replaces no TPU kernel: the JAX package computes this attention with
einsums (`src/repro/models/attention.py`, the direct path up to 1024
rows), as the port's `models/attention.py::direct_attention` does, which
builds every (B, K, G, S, S) score, probability and gradient in f32 in
device memory. The kernel (`csrc/fused_attention.cu`) does the same
arithmetic tile by tile in registers and shared memory. What bounds it on
the card is operations: a causal layer of yi-6b at 8 x 1024 rows is 68.7
GFLOP forward against 0.1 GB of q/k/v/out, above the H100's bf16 ridge;
the source's header says what its design does about that.

    fused_attention(q, k, v, causal=True) -> out
        q (B, S, H, dh), k/v (B, S, K, dh), H a multiple of K; out in v's
        dtype. The forward saves (q, k, v, out, lse), lse (B, H, S) f32 the
        row log-sum-exp of the scaled scores; the backward recomputes the
        probabilities from it.

Numerics (`direct_attention`'s are the contract): scores are f32 products
of the bf16 inputs, scaled by dh^-0.5 in f32; P is cast to v's dtype
before P·V, O accumulates in f32; the backward takes dP = dO·Vᵀ and D =
rowsum(dO ∘ O) in f32, dS = P ∘ (dP − D) in f32, and multiplies dS by K
and Q as two terms in the inputs' dtype (hi, and lo = dS − hi), so about 16
significant bits of dS reach dq and dk. `reference_forward` and
`reference_backward` are that arithmetic in plain PyTorch, on whole (S, S)
tensors.

For CPU tensors the Function computes the plain version; for CUDA tensors
it launches the kernel (bf16, dh a multiple of 8 up to MAX_HEAD_DIM) or
raises: nothing falls back to the plain version on the card. A fake tensor
(the dry run's) takes the custom op `repro_torch::fused_attention`
(`kernels/custom_ops.py`), whose backward is `fused_attention_bwd`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import custom_ops

launches = 0        # forward kernel launches (the forward and its recompute)
bwd_launches = 0    # backward launches, each the dq pass then the dk/dv pass

MAX_HEAD_DIM = 128  # the kernel's instances: 64 and 128 columns
HEAD_ALIGN = 8      # head rows are copied 16 bytes at a time


def scale_of(dh: int) -> float:
    """The scores' scale, dh^-0.5 (applied to the f32 scores)."""
    return dh ** -0.5


def _mask(S: int, causal: bool, device) -> torch.Tensor:
    pos = torch.arange(S, device=device)
    if causal:
        return pos[:, None] >= pos[None, :]
    return torch.ones((S, S), dtype=torch.bool, device=device)


def _scores(q, k, causal: bool) -> torch.Tensor:
    """q (B,S,H,dh), k (B,S,K,dh) -> (B,K,G,S,S) f32 scaled scores, masked
    columns -inf."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, dh).to(torch.float32)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.to(torch.float32))
    s = s * scale_of(dh)
    return s.masked_fill(~_mask(S, causal, q.device), float("-inf"))


def reference_forward(q, k, v, causal: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the forward: (out in v's dtype, lse (B, H, S)
    f32)."""
    B, S, H, dh = q.shape
    s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)                         # (B,K,G,S)
    p = torch.exp(s - lse[..., None]).to(v.dtype).to(torch.float32)
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v.to(torch.float32))
    return (out.reshape(B, S, H, dh).to(v.dtype),
            lse.reshape(B, H, S))


def reference_backward(q, k, v, out, lse, dout, causal: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the backward: P from lse; dV = Pᵀ·dO with P in
    v's dtype; dP, D and dS in f32; dS as hi + lo in q's dtype against K
    and Q. Returns (dq, dk, dv) in the inputs' dtypes."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    f32 = torch.float32
    s = _scores(q, k, causal)
    p = torch.exp(s - lse.reshape(B, K, G, S)[..., None])
    do = dout.reshape(B, S, K, G, dh).to(f32)
    dv = torch.einsum("bkgqt,bqkgd->btkd", p.to(v.dtype).to(f32), do)
    dp = torch.einsum("bqkgd,btkd->bkgqt", do, v.to(f32))
    D = (do * out.reshape(B, S, K, G, dh).to(f32)).sum(-1)   # (B,S,K,G)
    ds = p * (dp - D.permute(0, 2, 3, 1)[..., None])
    hi = ds.to(q.dtype).to(f32)
    ds = hi + (ds - hi).to(q.dtype).to(f32)
    scale = scale_of(dh)
    dq = torch.einsum("bkgqt,btkd->bqkgd", ds, k.to(f32)) * scale
    dk = torch.einsum("bkgqt,bqkgd->btkd", ds,
                      q.reshape(B, S, K, G, dh).to(f32)) * scale
    return (dq.reshape(B, S, H, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, S, H, dh = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != dh \
            or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not attend over k "
                         f"{tuple(k.shape)}: same batch, rows and head dim, "
                         "and H a multiple of K")


def kernel_accepts(q, k, v) -> Tuple[bool, str]:
    """Whether the kernel takes these inputs (their device aside): bf16
    q/k/v, dh a multiple of HEAD_ALIGN up to MAX_HEAD_DIM."""
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        return False, (f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the fused "
                       "attention kernel takes bfloat16")
    dh = q.shape[-1]
    if dh % HEAD_ALIGN or not 0 < dh <= MAX_HEAD_DIM:
        return False, (f"head_dim={dh}: the fused attention kernel takes a "
                       f"multiple of {HEAD_ALIGN} up to {MAX_HEAD_DIM}")
    return True, ""


def _plain(t) -> bool:
    """A tensor the kernel can launch on (or a fake one, for its op): not a
    DTensor, whose local shard reaches attention through
    `dist.dtensor.local_attention`."""
    return type(t) is torch.Tensor or custom_ops.is_fake(t)


def takes(q, k, v) -> bool:
    """The route `models/attention.py::attention` takes below its direct
    threshold: the kernel for plain CUDA inputs it accepts (self-attention
    over the same rows), the direct path for anything else."""
    return (q.device.type == "cuda" and q.ndim == 4 and k.shape == v.shape
            and k.shape[1] == q.shape[1] and q.shape[2] % k.shape[2] == 0
            and all(_plain(t) for t in (q, k, v))
            and kernel_accepts(q, k, v)[0])


def _cuda_checked(*ts) -> None:
    dev = ts[0].device
    for t in ts:
        if type(t) is not torch.Tensor:
            raise ValueError(f"the fused attention kernel takes plain "
                             f"tensors, got {type(t).__name__} (a DTensor's "
                             "local shard goes through "
                             "dist.dtensor.local_attention)")
        if t.device != dev:
            raise ValueError("inputs on several devices")
        if not t.is_contiguous():
            raise ValueError("the fused attention kernel takes contiguous "
                             "tensors")


def _fwd_launch(q, k, v, causal: bool):
    """The kernel's forward on CUDA tensors -> (out, lse)."""
    _check(q, k, v)
    ok, why = kernel_accepts(q, k, v)
    if not ok:
        raise ValueError(why)
    _cuda_checked(q, k, v)
    B, S, H, dh = q.shape
    dev = q.device
    out = torch.empty(q.shape, dtype=v.dtype, device=dev)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    lib = _LIB or _library()
    with torch.cuda.device(dev):
        code = lib.fused_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, H, k.shape[2], dh, int(causal),
            scale_of(dh), torch.cuda.current_stream(dev).cuda_stream)
    if code:
        from repro_torch.kernels import build
        build.check(code, "fused_attention_fwd_launch")
    global launches
    launches += 1
    return out, lse


def _bwd_launch(q, k, v, out, lse, dout, causal: bool):
    """The kernel's backward on CUDA tensors -> (dq, dk, dv)."""
    _check(q, k, v)
    ok, why = kernel_accepts(q, k, v)
    if not ok:
        raise ValueError(why)
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} and dout "
                         f"{tuple(dout.shape)} {dout.dtype} must match q")
    B, S, H, dh = q.shape
    if lse.shape != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 ({B}, {H}, {S}), got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    _cuda_checked(q, k, v, out, lse, dout)
    dev = q.device
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    lib = _LIB or _library()
    with torch.cuda.device(dev):
        code = lib.fused_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, H,
            k.shape[2], dh, int(causal), scale_of(dh),
            torch.cuda.current_stream(dev).cuda_stream)
    if code:
        from repro_torch.kernels import build
        build.check(code, "fused_attention_bwd_launch")
    global bwd_launches
    bwd_launches += 1
    return dq, dk, dv


def _forward(q, k, v, causal: bool):
    if q.device.type == "cuda":
        return _fwd_launch(q, k, v, causal)
    if q.device.type != "cpu":
        raise ValueError(f"no fused attention kernel for device {q.device}")
    _check(q, k, v)
    return reference_forward(q, k, v, causal)


def _backward(q, k, v, out, lse, dout, causal: bool):
    if q.device.type == "cuda":
        return _bwd_launch(q, k, v, out, lse, dout, causal)
    return reference_backward(q, k, v, out, lse, dout, causal)


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, dout.contiguous(),
                               ctx.causal)
        return dq, dk, dv, None


def fused_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Attention over q (B, S, H, dh), k/v (B, S, K, dh) -> (B, S, H, dh),
    differentiable; see the module's docstring."""
    if custom_ops.is_fake(q, k, v):
        _check(q, k, v)
        return custom_ops.op("fused_attention")(q, k, v, causal)[0]
    return _FusedAttention.apply(q, k, v, causal)


_LIB = None


def _library():
    global _LIB
    from repro_torch.kernels import build
    _LIB = build.library("fused_attention")
    return _LIB


custom_ops.define_fused_attention(_fwd_launch, _bwd_launch)
