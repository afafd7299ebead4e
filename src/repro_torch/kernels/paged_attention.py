"""Paged decode attention: the hand-written Hopper kernel (K3), its split
planner and its plain PyTorch version.

Replaces the TPU kernel `paged_attention_pallas` in
src/repro/kernels/paged_attention.py. The kernel is
`csrc/paged_attention.cu` (its header says what bounds it on the card —
bytes — and what the design does about that); this module holds the
wrapper, the split planner, the plain version, and the registry owner shim.

    paged_attention(q, k_pages, v_pages, block_table, kv_len) -> out

    q           (B, W, H, dh)   W consecutive query rows per slot (W == 1
                                for plain decode, W == k+1 to verify k
                                draft tokens)
    k_pages     (P, ps, K, dh)  one layer's page pool (post-RoPE K)
    v_pages     (P, ps, K, dh)
    block_table (B, PPS) int32  per-slot logical-page -> physical-page map
    kv_len      (B,)     int32  valid length seen by query row 0; row j
                                attends columns < kv_len + j
    out         (B, W, H, dh)   in v_pages.dtype

The kernel is split over pages (flash-decoding): a block per (slot,
kv-head, row group, split), each split an online softmax over a
contiguous run of the slot's pages, then a fixed-order combine of the
splits' partial (max, denominator, accumulator). `split_plan` decides how
many splits and which pages each takes, from the shapes and the blocks an
SM holds, which the card reports (kv_len stays on the card: the plan takes
the block table's capacity as the longest context, and blocks past a
slot's kv_len exit at once).

For CPU tensors the wrapper computes the plain version; for CUDA tensors it
launches the kernel or raises. The kernel takes head_dim 1..MAX_HEAD_DIM in
float32 or bfloat16; a fully masked row (kv_len + j == 0) gives 0 there, as
the Pallas kernel does.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels.api import KernelOp
from repro_torch.kernels import custom_ops
from repro_torch.models import attention as attn_mod

launches = 0            # kernel launches made by `paged_attention`
launches_by_w = {}      # the same launches by query rows per slot W

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256      # the widest head class the kernel is built for
# query rows one block takes (csrc/paged_attention.cu refuses more): bf16
# four M tiles of 16, f32 its MAXR
MAX_ROWS = {True: 64, False: 32}
MIN_SPLIT_KEYS = 128    # a split covers at least this many key rows
MAX_SPLITS = 64

# What the C side assumes (KernelOp.caps; analysis/kernel_audit.py derives
# MAX_HEAD_DIM, MAX_ROWS and the shared memory of every instance from it
# and holds it against csrc/paged_attention.cu): `classes` are the
# instances `dispatch` picks by head_dim, (head class, CHUNK key rows a
# stage); f32 instances take at most `f32_max_rows` query rows (MAXR), bf16
# ones an M tile of 16 rows per warp; a block requests `smem_bytes`.
CAPS = {"kind": "paged_attention", "threads": 128, "smem_bytes": 232_448,
        "off_slots": 4, "f32_max_rows": 32, "max_splits": 64,
        "classes": {"bfloat16": ((64, 64), (128, 64), (256, 32)),
                    "float32": ((64, 64), (128, 32), (256, 16))}}


def paged_attention_reference(q, k_pages, v_pages, block_table, kv_len):
    """The plain version: gather the slot's logical window through the
    block table, then the dense ragged decode attention (the JAX package's
    `paged_attention_einsum`): W == 1 is the single-query path
    (`direct_attention`), W > 1 the windowed mask (row j sees columns
    < kv_len + j). Masked columns contribute exact zeros."""
    B, PPS = block_table.shape
    ps = k_pages.shape[1]
    bt = block_table.to(torch.int64)
    k = k_pages[bt].reshape(B, PPS * ps, *k_pages.shape[2:])
    v = v_pages[bt].reshape(B, PPS * ps, *v_pages.shape[2:])
    if q.shape[1] == 1:
        return attn_mod.direct_attention(q, k, v, causal=False, kv_len=kv_len)
    return attn_mod.windowed_decode_attention(q, k, v, kv_len)


# ---------------------------------------------------------------------------
# Split planner (the kernel's shared memory and registers stay in C: the
# blocks an SM holds come from the card, `paged_attention_occupancy`)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SplitPlan:
    """How one call's work is cut into blocks.

    rows             query rows (G·W of a kv-head) of one row group
    row_groups       ceil(G·W / rows): each re-reads the kv-head's pages
    splits           blocks per (slot, kv-head, row group) along the pages
    pages_per_split  split s covers logical pages [s·pps_s, (s+1)·pps_s)
    blocks_per_sm    resident blocks per SM the plan counted on"""
    rows: int
    row_groups: int
    splits: int
    pages_per_split: int
    blocks_per_sm: int


def row_groups(H: int, K: int, W: int, bf16: bool) -> Tuple[int, int]:
    """(rows, groups): the G·W query rows of a kv-head cut into balanced
    groups of at most MAX_ROWS[bf16]."""
    R = (H // K) * W
    groups = -(-R // MAX_ROWS[bf16])
    return -(-R // groups), groups


def split_plan(B: int, W: int, H: int, K: int, ps: int, pps: int,
               bf16: bool, sms: int, blocks_per_sm: int,
               splits: Optional[int] = None) -> SplitPlan:
    """The blocks of one call: the query rows in `row_groups`, then the
    pages in splits, as many as fill every SM once with the blocks that
    fit it (`blocks_per_sm`, as the card reports it for the kernel
    instance), no more than keep MIN_SPLIT_KEYS key rows per split of the
    longest context the block table holds. `splits` forces a count; it is
    rounded so that no split is empty of pages."""
    rows, groups = row_groups(H, K, W, bf16)
    if splits is None:
        splits = min(sms * blocks_per_sm // (B * K * groups),
                     -(-(pps * ps) // MIN_SPLIT_KEYS), MAX_SPLITS)
    splits = max(1, min(splits, pps))
    per = -(-pps // splits)
    return SplitPlan(rows, groups, -(-pps // per), per, blocks_per_sm)


def split_ranges(plan: SplitPlan, ps: int, cols: int):
    """[(k0, k1)] key ranges of the splits that run for a slot whose widest
    row sees `cols` columns (kv_len + W - 1, clamped to the table): split
    s covers keys [s·pps_s·ps, (s+1)·pps_s·ps) ∩ [0, cols), and a split
    that starts at or past `cols` exits (a single split still runs, to
    write the zero rows)."""
    span = plan.pages_per_split * ps
    if plan.splits == 1:
        return [(0, cols)]
    return [(s * span, min((s + 1) * span, cols))
            for s in range(plan.splits) if s * span < cols]


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

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


def kernel_accepts(dh: int, dtype: Optional[torch.dtype]) -> Tuple[bool, str]:
    """The kernel's limits: head_dim 1..MAX_HEAD_DIM, float32 or bfloat16
    (dtype None: not known yet, not refused)."""
    if not 1 <= dh <= MAX_HEAD_DIM:
        return False, (f"head_dim={dh}: the paged attention kernel takes "
                       f"1 <= head_dim <= {MAX_HEAD_DIM}")
    if dtype is not None and dtype not in _KERNEL_DTYPES:
        return False, (f"dtype {dtype}: the paged attention kernel takes "
                       "float32 or bfloat16")
    return True, ""


class _Launch:
    """What one call signature (shapes, dtypes, device) needs, built once:
    the plan, the C side's dims array and the workspace size."""
    __slots__ = ("plan", "dims", "dims_ptr", "work_numel")

    def __init__(self, q, k_pages, v_pages, block_table, kv_len):
        _check(q, k_pages, v_pages, block_table, kv_len)
        B, W, H, dh = q.shape
        _, ps, K, _ = k_pages.shape
        if not (q.dtype == k_pages.dtype == v_pages.dtype):
            raise ValueError(f"the kernel takes q/k/v of one dtype, got "
                             f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
        ok, why = kernel_accepts(dh, q.dtype)
        if not ok:
            raise ValueError(why)
        bf16 = q.dtype == torch.bfloat16
        pps = block_table.shape[1]
        # the blocks of the kernel instance an SM holds, as the card counts
        # them (shared memory and registers; the split count plays no part)
        rows, groups = row_groups(H, K, W, bf16)
        probe = SplitPlan(rows, groups, 1, pps, 0)
        per_sm = ctypes.c_int(0)
        ints = self._ints(probe, B, W, H, K, dh, ps, pps, bf16)
        code = (_LIB or _library()).paged_attention_occupancy(
            ctypes.addressof(ints), ctypes.addressof(per_sm))
        if code:
            from repro_torch.kernels import build
            build.check(code, "paged_attention_occupancy")
        if per_sm.value < 1:
            raise RuntimeError(f"paged attention kernel: no block of "
                               f"head_dim {dh}, {rows} rows fits an SM")
        sms = torch.cuda.get_device_properties(
            q.device).multi_processor_count
        plan = split_plan(B, W, H, K, ps, pps, bf16, sms, per_sm.value)
        self.plan = plan
        self.dims = self._ints(plan, B, W, H, K, dh, ps, pps, bf16)
        self.dims_ptr = ctypes.addressof(self.dims)
        self.work_numel = (work_numel(plan.splits, B * W * H, dh)
                           if plan.splits > 1 else 0)

    @staticmethod
    def _ints(plan, B, W, H, K, dh, ps, pps, bf16):
        ints = (B, W, H, K, dh, ps, pps, plan.splits, plan.pages_per_split,
                plan.rows, plan.row_groups, int(bf16))
        return (ctypes.c_int * len(ints))(*ints)


def work_numel(splits: int, nrows: int, dh: int) -> int:
    """f32 workspace of a split call (csrc: `paged_attention_launch`): the
    partial (max, denominator) of each split and output row, rounded up to
    4 floats so that the partial accumulators after them start 16-byte
    aligned (the combine reads them as float4), then the accumulators."""
    return -(-splits * nrows * 2 // 4) * 4 + splits * nrows * dh


_LAUNCHES = {}          # call signature -> _Launch


def _launch_for(q, k_pages, v_pages, block_table, kv_len) -> _Launch:
    key = (q.shape, k_pages.shape, v_pages.shape, block_table.shape,
           kv_len.shape, q.dtype, k_pages.dtype, v_pages.dtype,
           block_table.dtype, kv_len.dtype, q.device)
    launch = _LAUNCHES.get(key)
    if launch is None:
        launch = _LAUNCHES[key] = _Launch(q, k_pages, v_pages, block_table,
                                          kv_len)
    return launch


def launch_plan(q, k_pages, v_pages, block_table, kv_len) -> SplitPlan:
    """The plan the kernel runs these CUDA inputs with (blocks per SM as
    the card reports them)."""
    return _launch_for(q, k_pages, v_pages, block_table, kv_len).plan


def paged_attention(q, k_pages, v_pages, block_table, kv_len):
    dev = q.device
    if dev.type != "cuda":
        _check(q, k_pages, v_pages, block_table, kv_len)
        if dev.type == "cpu":
            return paged_attention_reference(q, k_pages, v_pages,
                                             block_table, kv_len)
        raise ValueError(f"no paged_attention kernel for device {dev}")
    if custom_ops.is_fake(q, k_pages, v_pages, block_table, kv_len):
        _check(q, k_pages, v_pages, block_table, kv_len)
        return custom_ops.op("paged_attention")(q, k_pages, v_pages,
                                                block_table, kv_len)
    return _launch(q, k_pages, v_pages, block_table, kv_len)


def _launch(q, k_pages, v_pages, block_table, kv_len):
    dev = q.device
    launch = _launch_for(q, k_pages, v_pages, block_table, kv_len)
    if not (k_pages.device == dev and v_pages.device == dev
            and block_table.device == dev and kv_len.device == dev):
        raise ValueError("inputs on several devices")
    if not (q.is_contiguous() and k_pages.is_contiguous()
            and v_pages.is_contiguous() and block_table.is_contiguous()
            and kv_len.is_contiguous()):
        raise ValueError("q, k_pages, v_pages, block_table and kv_len must "
                         "be contiguous")
    lib = _LIB or _library()
    out = torch.empty(q.shape, dtype=v_pages.dtype, device=dev)
    # the splits' partial (max, denominator) and accumulator, f32
    work = (torch.empty((launch.work_numel,), dtype=torch.float32,
                        device=dev) if launch.work_numel else None)
    global launches
    index = dev.index
    switch = index != torch.cuda.current_device()
    if switch:
        prev = torch.cuda.current_device()
        torch.cuda.set_device(index)
    try:
        code = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            work.data_ptr() if work is not None else None, launch.dims_ptr,
            torch._C._cuda_getCurrentRawStream(index))
    finally:
        if switch:
            torch.cuda.set_device(prev)
    if code:
        from repro_torch.kernels import build
        build.check(code, "paged_attention_launch")
    launches += 1
    W = q.shape[1]
    launches_by_w[W] = launches_by_w.get(W, 0) + 1
    return out


TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def agreement_limit(ref: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The largest |kernel - plain| each output element may show, where
    `ref` is the plain version computed in f32 on the kernel's inputs
    (upcast) and `dtype` the kernel's, t = TOLERANCE[dtype]: f32
    t·(1 + |ref|) (atol = rtol = t); bf16 t times the largest |value| of the
    element's (slot, row, head) vector, and never more than t·(1 + |ref|).
    The bf16 limit scales with the output: at long contexts an output is a
    mean over thousands of values and its elements are a few 1e-2, where a
    fixed 2e-2 would pass a wrong kernel."""
    t = TOLERANCE[dtype]
    mag = ref.float().abs()
    if dtype == torch.float32:
        return t * (1 + mag)
    return t * torch.minimum(mag.amax(-1, keepdim=True), 1 + mag)


_LIB = None


def _library():
    global _LIB
    from repro_torch.kernels import build
    _LIB = build.library("paged_attention")
    return _LIB


def _cuda_accepts(d1, d2, peft, dtype):
    # the registry's (d1, d2) of this op are (kv heads, head_dim)
    return kernel_accepts(d2, dtype)


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
                     devices=("cuda",), accepts=_cuda_accepts, caps=CAPS,
                     note="split-KV over pages, mma.sync bf16 / FP32 FMA, "
                          "fixed-order combine (csrc/paged_attention.cu)"),
        )


OWNER = _PagedAttentionOwner()


custom_ops.define_paged_attention(_launch)
