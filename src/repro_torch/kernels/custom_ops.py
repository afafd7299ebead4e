"""K1–K5, the fused attention and the SSD scan as `torch.library` custom
ops, so fake tensors keep the kernel route.

A fake tensor (`torch._subclasses.fake_tensor.FakeTensor`, the dry run's:
shapes, dtypes and a device, no storage) cannot reach a kernel launch.
Each wrapper (`fourier_deltaw.deltaw` / `dc`, `dct_deltaw.deltaw` / `dc`,
`paged_attention.paged_attention`, `fused_attention.fused_attention`,
`ssd_scan.ssd_scan`)
therefore hands a fake input to its custom op `repro_torch::<name>`,
whose fake implementation returns the output's shape, and whose real
implementation is the wrapper's own launch
(what a direct `torch.ops.repro_torch.<name>` call on CUDA tensors runs).
Real tensors take the wrapper's route exactly as before: the launch is
called directly, the counters count it, no dispatcher round trip. K1's op
carries its autograd: the VJP through K2's op; the fused attention's op
(out, lse) its backward through `fused_attention_bwd`. The SSD scan's ops
(`ssd_scan` -> y, final, cum, entering states; `ssd_scan_bwd`) carry
none: the wrapper's autograd Function calls them on fake tensors, so its
backward is written once.

`COSTS` prices one call of each op the way chip_smoke's bounds do (its
`fft_ops` and the bytes each function must move), so `dist.opstats`
counts a kernel as one op: K1/K2/K4/K5 2.5·N·log2 N operations per layer
for N = d1·d2 and the coefficients, entries and ΔW (or cotangent) once;
K3 4·H·dh operations per (query row, column) and q, the output, the K/V
rows and the block table once, over the block table's whole capacity
(fake tensors carry no kv_len values to count from); the fused attention
4·H·dh operations per (query row, visible column) forward and twice that
backward (the required work, as the benchmark's `harness/flops.py`
counts it: the backward's recompute and dS's hi/lo products are not), and
its tensors once; the SSD scan the benchmark's `ssd_ops` and `ssd_bytes`
of a layer (`perfbench/families/zamba2.py`) forward, and twice those
operations backward with x, dy, dx, dt, ddt, B, C, dB and dC once.
"""
import math
from typing import Callable, Dict, Optional, Tuple

import torch

NAMESPACE = "repro_torch"


def is_fake(*tensors) -> bool:
    """True when any argument is a fake tensor (no storage to launch on)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor) for t in tensors)


def op(name: str):
    """The registered op `repro_torch::<name>`."""
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def _fft_ops(d1: int, d2: int, L: int) -> float:
    size = float(d1 * d2)
    return 2.5 * size * math.log2(size) * L if size > 1 else 0.0


def _deltaw_cost(args, out) -> Tuple[float, float]:
    c, u, v, d1, d2 = args[:5]
    L, n = c.shape
    return _fft_ops(d1, d2, L), 4.0 * (L * n + 2 * n + L * d1 * d2)


def _dc_cost(args, out) -> Tuple[float, float]:
    g, u, v, d1, d2 = args[:5]
    L, n = g.shape[0], u.shape[0]
    return _fft_ops(d1, d2, L), 4.0 * (L * d1 * d2 + 2 * n + L * n)


def _paged_cost(args, out) -> Tuple[float, float]:
    q, k_pages, _, block_table, _ = args[:5]
    B, W, H, dh = q.shape
    ps, K = k_pages.shape[1], k_pages.shape[2]
    cols = block_table.shape[1] * ps
    elt = q.element_size()
    nbytes = (2 * B * W * H * dh * elt + 2 * B * cols * K * dh * elt
              + 4 * B * block_table.shape[1] + 4 * B)
    return 4.0 * H * dh * B * W * cols, float(nbytes)


def _visible_pairs(S: int, causal: bool) -> float:
    return S * (S + 1) / 2.0 if causal else float(S * S)


def _fused_cost(args, out) -> Tuple[float, float]:
    q, k, _, causal = args[:4]
    B, S, H, dh = q.shape
    elt = q.element_size()
    nbytes = elt * (2 * q.numel() + 2 * k.numel()) + 4 * B * H * S
    return 4.0 * H * dh * B * _visible_pairs(S, causal), float(nbytes)


def _fused_bwd_cost(args, out) -> Tuple[float, float]:
    q, k, _, _, _, _, causal = args[:7]
    B, S, H, dh = q.shape
    elt = q.element_size()
    nbytes = elt * (4 * q.numel() + 4 * k.numel()) + 4 * B * H * S
    return 8.0 * H * dh * B * _visible_pairs(S, causal), float(nbytes)


def _ssd_ops(x, B, chunk: int) -> float:
    """The benchmark's `ssd_ops` of one layer: the causal C·Bᵀ scores (a
    group's N a visible pair) and their product with dt·x (a head's P a
    pair), a token's share of its chunk's state and of the state's output
    (H·P·N each), 2 operations a multiply-add."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = min(chunk, S)
    pairs = b * (S // Q) * Q * (Q + 1) / 2.0
    return 2.0 * pairs * (G * N + H * P) + 2.0 * b * S * 2 * H * P * N


def _ssd_cost(args, out) -> Tuple[float, float]:
    x, _, _, B, _, _, chunk = args[:7]
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    elt = x.element_size()
    # the benchmark's `ssd_bytes`: x and y, dt (f32), B and C, each once
    nbytes = b * S * (2 * elt * H * P + 4 * H + 2 * elt * G * N)
    return _ssd_ops(x, B, chunk), float(nbytes)


def _ssd_bwd_cost(args, out) -> Tuple[float, float]:
    x, _, _, B = args[:4]
    chunk = args[10]
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    elt = x.element_size()
    # twice the forward's operations; x, dy and dx, dt and ddt, B, C, dB, dC
    nbytes = b * S * (3 * elt * H * P + 8 * H + 4 * elt * G * N)
    return 2.0 * _ssd_ops(x, B, chunk), float(nbytes)


COSTS: Dict[str, Callable] = {
    "fourier_deltaw": _deltaw_cost, "fourier_dc": _dc_cost,
    "dct_deltaw": _deltaw_cost, "dct_dc": _dc_cost,
    "paged_attention": _paged_cost,
    "fused_attention": _fused_cost, "fused_attention_bwd": _fused_bwd_cost,
    "ssd_scan": _ssd_cost, "ssd_scan_bwd": _ssd_bwd_cost,
}


def define_deltaw_pair(prefix: str, deltaw_launch: Callable,
                       dc_launch: Callable) -> None:
    """`<prefix>_deltaw` (c (L, n), u, v -> (L, d1, d2)) and `<prefix>_dc`
    (g (L, d1, d2), u, v -> (L, n)), f32, with K1's (K4's) VJP through
    the dc op."""
    T = torch.Tensor

    @torch.library.custom_op(f"{NAMESPACE}::{prefix}_dc", mutates_args=())
    def dc_op(g: T, u: T, v: T, d1: int, d2: int, alpha: float) -> T:
        return dc_launch(g, u, v, d1, d2, alpha)

    @dc_op.register_fake
    def _(g, u, v, d1, d2, alpha):
        return g.new_empty((g.shape[0], u.shape[0]), dtype=torch.float32)

    @torch.library.custom_op(f"{NAMESPACE}::{prefix}_deltaw",
                             mutates_args=())
    def deltaw_op(c: T, u: T, v: T, d1: int, d2: int, alpha: float) -> T:
        return deltaw_launch(c, u, v, d1, d2, alpha)

    @deltaw_op.register_fake
    def _(c, u, v, d1, d2, alpha):
        return c.new_empty((c.shape[0], d1, d2), dtype=torch.float32)

    def setup(ctx, inputs, output):
        _, u, v, d1, d2, alpha = inputs
        ctx.save_for_backward(u, v)
        ctx.meta = (d1, d2, alpha)

    def backward(ctx, g):
        u, v = ctx.saved_tensors
        d1, d2, alpha = ctx.meta
        dc = dc_op(g.to(torch.float32).contiguous(), u, v, d1, d2, alpha)
        return dc, None, None, None, None, None

    deltaw_op.register_autograd(backward, setup_context=setup)


def define_paged_attention(launch: Callable) -> None:
    """`paged_attention` (q (B, W, H, dh), pages (P, page, K, dh) x2,
    block_table (B, PPS), kv_len (B,) -> (B, W, H, dh))."""
    T = torch.Tensor

    @torch.library.custom_op(f"{NAMESPACE}::paged_attention",
                             mutates_args=())
    def paged_op(q: T, k_pages: T, v_pages: T, block_table: T,
                 kv_len: T) -> T:
        return launch(q, k_pages, v_pages, block_table, kv_len)

    @paged_op.register_fake
    def _(q, k_pages, v_pages, block_table, kv_len):
        return q.new_empty(q.shape, dtype=v_pages.dtype)


def define_fused_attention(fwd_launch: Callable, bwd_launch: Callable
                           ) -> None:
    """`fused_attention` (q (B, S, H, dh), k/v (B, S, K, dh), causal ->
    (out (B, S, H, dh), lse (B, H, S) f32)) and `fused_attention_bwd`
    (q, k, v, out, lse, dout, causal -> (dq, dk, dv)), the first's VJP
    through the second."""
    T = torch.Tensor

    @torch.library.custom_op(f"{NAMESPACE}::fused_attention_bwd",
                             mutates_args=())
    def bwd_op(q: T, k: T, v: T, out: T, lse: T, dout: T,
               causal: bool) -> Tuple[T, T, T]:
        return bwd_launch(q, k, v, out, lse, dout, causal)

    @bwd_op.register_fake
    def _(q, k, v, out, lse, dout, causal):
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    @torch.library.custom_op(f"{NAMESPACE}::fused_attention",
                             mutates_args=())
    def fwd_op(q: T, k: T, v: T, causal: bool) -> Tuple[T, T]:
        return fwd_launch(q, k, v, causal)

    @fwd_op.register_fake
    def _(q, k, v, causal):
        B, S, H, _ = q.shape
        return (q.new_empty(q.shape, dtype=v.dtype),
                q.new_empty((B, H, S), dtype=torch.float32))

    def setup(ctx, inputs, output):
        q, k, v, causal = inputs
        ctx.save_for_backward(q, k, v, *output)
        ctx.causal = causal

    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = bwd_op(q, k, v, out, lse, dout.contiguous(),
                            ctx.causal)
        return dq, dk, dv, None

    fwd_op.register_autograd(backward, setup_context=setup)


def define_ssd_scan(fwd_launch: Callable, bwd_launch: Callable,
                    tiling: Callable) -> None:
    """`ssd_scan` (x (b, S, H, P), dt (b, S, H), A (H,), B/C (b, S, G, N),
    D (H,), chunk -> (y (b, S, H, P) in x's dtype, final (b, H, P, N), cum
    (b, H, S'), the states entering the kernel's chunks (b, S' / q, H, P,
    N), all three f32, with (q, S') = `tiling(S)`)) and `ssd_scan_bwd` (the
    inputs, cum, states, dy, dfinal or None, chunk -> (dx, ddt, dA, dB,
    dC, dD)), the first's VJP through the second. Real tensors take both
    ops too: this autograd is the scan's only backward."""
    T = torch.Tensor
    f32 = torch.float32

    @torch.library.custom_op(f"{NAMESPACE}::ssd_scan_bwd", mutates_args=())
    def bwd_op(x: T, dt: T, A: T, B: T, C: T, D: T, cum: T, hst: T, dy: T,
               dfinal: Optional[T], chunk: int
               ) -> Tuple[T, T, T, T, T, T]:
        return bwd_launch(x, dt, A, B, C, D, cum, hst, dy, dfinal, chunk)

    @bwd_op.register_fake
    def _(x, dt, A, B, C, D, cum, hst, dy, dfinal, chunk):
        return (torch.empty_like(x), dt.new_empty(dt.shape, dtype=f32),
                A.new_empty(A.shape, dtype=f32),
                B.new_empty(B.shape, dtype=f32),
                C.new_empty(C.shape, dtype=f32),
                D.new_empty(D.shape, dtype=f32))

    @torch.library.custom_op(f"{NAMESPACE}::ssd_scan", mutates_args=())
    def fwd_op(x: T, dt: T, A: T, B: T, C: T, D: T, chunk: int
               ) -> Tuple[T, T, T, T]:
        return fwd_launch(x, dt, A, B, C, D, chunk)

    @fwd_op.register_fake
    def _(x, dt, A, B, C, D, chunk):
        b, S, H, P = x.shape
        N = B.shape[3]
        q, Sp = tiling(S)
        return (torch.empty_like(x), x.new_empty((b, H, P, N), dtype=f32),
                x.new_empty((b, H, Sp), dtype=f32),
                x.new_empty((b, Sp // q, H, P, N), dtype=f32))
