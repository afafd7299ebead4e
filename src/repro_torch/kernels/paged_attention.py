"""Paged decode attention: the hand-written Hopper kernel (K3) and its plain
PyTorch version.

Replaces the TPU kernel `paged_attention_pallas` in
src/repro/kernels/paged_attention.py. The kernel is
`csrc/paged_attention.cu` (its header says what bounds it on the card —
bytes — and what the design does about that); this module holds the
wrapper, the plain version, and the registry owner shim.

    paged_attention(q, k_pages, v_pages, block_table, kv_len) -> out

    q           (B, W, H, dh)   W consecutive query rows per slot (W == 1
                                for plain decode)
    k_pages     (P, ps, K, dh)  one layer's page pool (post-RoPE K)
    v_pages     (P, ps, K, dh)
    block_table (B, PPS) int32  per-slot logical-page -> physical-page map
    kv_len      (B,)     int32  valid length seen by query row 0; row j
                                attends columns < kv_len + j
    out         (B, W, H, dh)   in v_pages.dtype

For CPU tensors the wrapper computes the plain version; for CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.api import KernelOp
from repro_torch.models import attention as attn_mod

launches = 0            # kernel launches made by `paged_attention`

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (32, 64, 128, 256)


def paged_attention_reference(q, k_pages, v_pages, block_table, kv_len):
    """The plain version: gather the slot's logical window through the
    block table, then the dense ragged decode attention (the JAX package's
    `paged_attention_einsum`). Masked columns contribute exact zeros."""
    B, PPS = block_table.shape
    if q.shape[1] != 1:
        raise NotImplementedError(
            "the plain version covers W == 1; the verify window (W = k+1) "
            "comes with the speculation slice")
    ps = k_pages.shape[1]
    bt = block_table.to(torch.int64)
    k = k_pages[bt].reshape(B, PPS * ps, *k_pages.shape[2:])
    v = v_pages[bt].reshape(B, PPS * ps, *v_pages.shape[2:])
    return attn_mod.direct_attention(q, k, v, causal=False, kv_len=kv_len)


def _check(q, k_pages, v_pages, block_table, kv_len):
    if q.ndim != 4 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k "
                         f"{tuple(k_pages.shape)} v {tuple(v_pages.shape)}")
    B, W, H, dh = q.shape
    _, ps, K, dhk = k_pages.shape
    if dhk != dh or H % K:
        raise ValueError(f"q heads {H}x{dh} do not group over kv heads "
                         f"{K}x{dhk}")
    if block_table.ndim != 2 or block_table.shape[0] != B \
            or block_table.dtype != torch.int32:
        raise ValueError(f"block_table must be int32 ({B}, PPS), got "
                         f"{tuple(block_table.shape)} {block_table.dtype}")
    if kv_len.shape != (B,) or kv_len.dtype != torch.int32:
        raise ValueError(f"kv_len must be int32 ({B},), got "
                         f"{tuple(kv_len.shape)} {kv_len.dtype}")
    devs = {t.device for t in (q, k_pages, v_pages, block_table, kv_len)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def paged_attention(q, k_pages, v_pages, block_table, kv_len):
    _check(q, k_pages, v_pages, block_table, kv_len)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_table,
                                         kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_attention kernel for device {q.device}")
    B, W, H, dh = q.shape
    _, ps, K, _ = k_pages.shape
    if not (q.dtype == k_pages.dtype == v_pages.dtype) \
            or q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the kernel takes q/k/v all f32 or all bf16, got "
                         f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if dh not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {_KERNEL_HEAD_DIMS}, "
                         f"got {dh}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", block_table), ("kv_len", kv_len)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from repro_torch.kernels import build
    lib = build.library("paged_attention")
    global launches
    out = torch.empty(q.shape, dtype=v_pages.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            B, W, H, K, dh, ps, block_table.shape[1],
            _KERNEL_DTYPES[q.dtype], stream)
    build.check(code, "paged_attention_launch")
    launches += 1
    return out


class _PagedAttentionOwner:
    """Registry owner for the model-side paged_attention op: carries the
    `name`/`kernel_ops()` surface `api.ensure_method` collects, nothing
    else (no adapter state, no sites)."""
    name = "attention"
    has_site_params = False

    def kernel_ops(self):
        return (
            KernelOp("paged_attention", self.name, "einsum",
                     paged_attention_reference,
                     note="block-table gather + dense ragged decode attn"),
            KernelOp("paged_attention", self.name, "cuda", paged_attention,
                     devices=("cuda",),
                     note="one block per (slot, kv-head), online softmax "
                          "(csrc/paged_attention.cu)"),
        )


OWNER = _PagedAttentionOwner()
