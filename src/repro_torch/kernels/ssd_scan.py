"""The chunked SSD scan on the card: the hand-written Hopper kernel
(`csrc/ssd_scan.cu`) and its one autograd Function.

Replaces no TPU kernel: XLA computes the JAX package's `ssd_chunked`
(`src/repro/models/mamba2.py`). The port's plain version is
`models/mamba2.py::ssd_chunked`, which builds every (b, nc, H, Q, Q) f32
score, decay and product in device memory; the kernel does the same
arithmetic in f32 with each chunk's (Q, Q) tiles in registers and shared
memory. What bounds it on the card is operations: a Zamba2-7B layer at 4096
tokens requires 15.2 GFLOP forward against 121 MB (0.23 ms of f32 FFMA at
67 TFLOP/s against 36 µs at 3.35 TB/s); the source's header says what its
design does about that.

    ssd_scan(x, dt, A, B, C, D, chunk=Q) -> (y, final_state)
        `ssd_chunked`'s signature and contract: x (b, S, H, 64), dt (b, S,
        H), A (H,), B/C (b, S, G, N), D (H,); y in x's dtype, the final
        state (b, H, 64, N) f32. The kernel passes the state over chunks of
        `tiling(S)` rows (64, or S below 64), whatever the model's chunk
        Q: the same function with fewer operations (the source's header).
        A length that is no multiple of 64 is padded at its end with zero
        rows (dt 0: the state passes them unchanged, and they add nothing
        to y, the final state or the gradients of the rows before them),
        so no length runs on short chunks. The forward saves the inputs, cum (b, H, S') f32 (dt·A
        summed within each chunk) and the state entering each (b, S' / 64,
        H, 64, N) f32 (117 MB a layer at Zamba2-7B's 4096 tokens), S' the
        padded length; the backward gives dx, ddt, dA, dB, dC and dD.

The kernel takes bf16 or f32 x, B and C (one dtype), head dim 64, state 64
or 128, G dividing H, and S a multiple of a chunk Q <= 256 (`ssd_chunked`'s
contract; the kernel's own chunks do not depend on Q); dt, A and D are
read in f32. Everything is computed in f32 (no TF32, no bf16 operand); the
sums run in another order than `ssd_chunked`'s. `models/mamba2.py::
ssd_scan` routes plain CUDA tensors here, float64 ones (the oracle's) and
CPU tensors to `ssd_chunked`; a CUDA input the kernel does not take
raises, nothing falls back on the card. The Function `_SSDScan` is the
scan's only backward: on real tensors it launches the kernel directly, on
fake ones (the dry run's) it calls the custom ops `repro_torch::ssd_scan`
and `ssd_scan_bwd` (`kernels/custom_ops.py`), which price each call.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import custom_ops

launches = 0        # forward calls (the forward and remat's recompute)
bwd_launches = 0    # backward calls (each a few kernels)

HEAD_DIM = 64
STATES = (64, 128)
MAX_CHUNK = 256
HEADS_A_BLOCK = 8   # heads of a group that share one block's C·Bᵀ
TILE = 64           # the chunk the kernel passes states over


def tiling(S: int) -> Tuple[int, int]:
    """(the kernel's chunk, the length it scans) for S rows: chunks of
    TILE rows (S when S < TILE), the sequence padded at its end with zero
    rows to a multiple of the chunk."""
    q = min(S, TILE)
    return q, -(-S // q) * q


def _check(x, dt, A, B, C, D, chunk: int) -> None:
    if x.ndim != 4 or dt.ndim != 3 or B.ndim != 4 or C.shape != B.shape \
            or A.ndim != 1 or D.ndim != 1:
        raise ValueError(f"bad shapes x {tuple(x.shape)} dt {tuple(dt.shape)}"
                         f" A {tuple(A.shape)} B {tuple(B.shape)} C "
                         f"{tuple(C.shape)} D {tuple(D.shape)}")
    b, S, H, _ = x.shape
    if tuple(dt.shape) != (b, S, H) or B.shape[:2] != (b, S) \
            or A.shape[0] != H or D.shape[0] != H or H % B.shape[2]:
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, B "
                         f"{tuple(B.shape)}, A/D ({A.shape[0]}, {D.shape[0]}):"
                         " dt (b, S, H), B/C (b, S, G, N) with G dividing H, "
                         "A and D (H,)")
    if chunk <= 0 or S % chunk:
        raise ValueError(f"S={S} is no multiple of the chunk {chunk}")


def kernel_accepts(x, B, chunk: int) -> Tuple[bool, str]:
    """Whether the kernel takes these shapes and dtypes (their device
    aside)."""
    if x.dtype not in (torch.bfloat16, torch.float32) \
            or B.dtype != x.dtype:
        return False, (f"dtypes x {x.dtype}, B/C {B.dtype}: the SSD scan "
                       "kernel takes bfloat16 or float32, one for both")
    if x.shape[-1] != HEAD_DIM:
        return False, (f"head_dim={x.shape[-1]}: the SSD scan kernel takes "
                       f"{HEAD_DIM}")
    if B.shape[-1] not in STATES:
        return False, (f"state={B.shape[-1]}: the SSD scan kernel takes "
                       f"{' or '.join(map(str, STATES))}")
    if not 0 < chunk <= MAX_CHUNK:
        return False, (f"chunk={chunk}: the SSD scan kernel takes up to "
                       f"{MAX_CHUNK}")
    return True, ""


def _plain(t) -> bool:
    return type(t) is torch.Tensor or custom_ops.is_fake(t)


def takes(x, dt, A, B, C, D) -> bool:
    """The route of `models/mamba2.py::ssd_scan`: plain CUDA tensors go to
    the kernel (which launches for bf16 and f32 and raises on anything else
    it does not take), except float64 ones (the oracle's); those and CPU
    tensors go to `ssd_chunked`."""
    return (x.device.type == "cuda" and x.dtype != torch.float64
            and all(_plain(t) for t in (x, dt, A, B, C, D)))


def _ready(t: torch.Tensor, dtype=None) -> torch.Tensor:
    """Contiguous, in `dtype`, and 16-byte aligned (the kernel's float4 and
    8-byte bf16 loads)."""
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def _cuda_checked(*ts) -> None:
    dev = ts[0].device
    for t in ts:
        if type(t) is not torch.Tensor:
            raise ValueError(f"the SSD scan kernel takes plain tensors, got "
                             f"{type(t).__name__}")
        if t.device != dev:
            raise ValueError("inputs on several devices")


def _dims(x, B, q: int):
    b, S, H, _ = x.shape
    G, N = B.shape[2], B.shape[3]
    return (ctypes.c_int * 8)(b, S, H, G, N, q, HEADS_A_BLOCK,
                              int(x.dtype == torch.bfloat16))


def _run(name: str, ts, x, B, q: int) -> None:
    """Launches `name` of the library on the tensors `ts` (None for an
    absent one) at x's and B's dimensions, chunks of q rows."""
    lib = _LIB or _library()
    dev = x.device
    with torch.cuda.device(dev):
        code = getattr(lib, name)(
            (ctypes.c_void_p * len(ts))(*(
                None if t is None else t.data_ptr() for t in ts)),
            _dims(x, B, q), torch.cuda.current_stream(dev).cuda_stream)
    if code:
        from repro_torch.kernels import build
        build.check(code, name)


def _padded(t: torch.Tensor, length: int) -> torch.Tensor:
    """`t` (b, S, ...) with zero rows appended up to `length`."""
    if t.shape[1] == length:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], length - t.shape[1],
                                      *t.shape[2:]))], dim=1)


def _cut(t: torch.Tensor, S: int) -> torch.Tensor:
    """The first S rows of a padded (b, S', ...) output, a tensor of its
    own."""
    return t if t.shape[1] == S else t[:, :S].clone()


def _prepared(x, dt, A, B, C, D):
    """The inputs made ready for the kernel: x, B, C as they come, dt, A,
    D in f32; x, dt, B, C padded to `tiling(S)`'s length; each contiguous
    and aligned."""
    _cuda_checked(x, dt, A, B, C, D)
    f32 = torch.float32
    Sp = tiling(x.shape[1])[1]
    return (_ready(_padded(x, Sp)), _ready(_padded(dt, Sp), f32),
            _ready(A, f32), _ready(_padded(B, Sp)), _ready(_padded(C, Sp)),
            _ready(D, f32))


def _fwd(ins, S: int):
    """The kernel's forward on `_prepared` inputs of S rows -> (y, final,
    cum, entering states); cum and the states over the padded length."""
    x, dt, A, B, C, D = ins
    b, Sp, H, P = x.shape
    N = B.shape[3]
    q = tiling(S)[0]
    dev, f32 = x.device, torch.float32
    y = torch.empty_like(x)
    final = torch.empty((b, H, P, N), dtype=f32, device=dev)
    cum = torch.empty((b, H, Sp), dtype=f32, device=dev)
    hst = torch.empty((b, Sp // q, H, P, N), dtype=f32, device=dev)
    _run("ssd_scan_fwd_launch", (x, dt, A, B, C, D, y, final, cum, hst),
         x, B, q)
    global launches
    launches += 1
    return _cut(y, S), final, cum, hst


def _bwd(ins, S: int, cum, hst, dy, dfinal):
    """The kernel's backward on `_prepared` inputs of S rows -> (dx in x's
    dtype, ddt, dA, dB, dC, dD in f32), each of S rows."""
    x, dt, A, B, C, D = ins
    b, Sp, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    q = tiling(S)[0]
    nc = Sp // q
    f32 = torch.float32
    if tuple(dy.shape) != (b, S, H, P) or cum.shape != (b, H, Sp) \
            or hst.shape != (b, nc, H, P, N):
        raise ValueError(f"dy {tuple(dy.shape)}, cum {tuple(cum.shape)}, "
                         f"states {tuple(hst.shape)} do not match x "
                         f"{tuple(x.shape)} (padded)")
    dy = _ready(_padded(dy, Sp), x.dtype)
    cum, hst = _ready(cum, f32), _ready(hst, f32)
    if dfinal is not None:
        dfinal = _ready(dfinal, f32)
    dev = x.device
    nhb = -(-(H // G) // HEADS_A_BLOCK)
    nsl = -(-(P * N) // 1024)

    def empty(*shape):
        return torch.empty(shape, dtype=f32, device=dev)

    dst = empty(b, nc, H, P, N)
    dT_part = empty(b * H, nc, nsl)
    dA_part, dD_part = empty(b, nc, H), empty(b, nc, H)
    dB_part, dC_part = empty(nhb, b, Sp, G, N), empty(nhb, b, Sp, G, N)
    dx = torch.empty_like(x)
    ddt, dB, dC = empty(b, Sp, H), empty(b, Sp, G, N), empty(b, Sp, G, N)
    _run("ssd_scan_bwd_launch", (x, dt, A, B, C, D, dy, dfinal, cum, hst,
                                 dst, dT_part, dA_part, dD_part, dB_part,
                                 dC_part, dx, ddt, dB, dC), x, B, q)
    global bwd_launches
    bwd_launches += 1
    return (_cut(dx, S), _cut(ddt, S), dA_part.sum((0, 1)), _cut(dB, S),
            _cut(dC, S), dD_part.sum((0, 1)))


def _fwd_launch(x, dt, A, B, C, D, chunk: int):
    """The kernel's forward on CUDA tensors as they come (the custom op's
    real implementation) -> (y, final, cum, entering states)."""
    return _fwd(_prepared(x, dt, A, B, C, D), x.shape[1])


def _bwd_launch(x, dt, A, B, C, D, cum, hst, dy, dfinal: Optional[
        torch.Tensor], chunk: int):
    """The kernel's backward on CUDA tensors as they come (the backward
    op's real implementation) -> (dx in x's dtype, ddt, dA, dB, dC, dD in
    f32)."""
    _cuda_checked(x, cum, hst, dy, *(() if dfinal is None else (dfinal,)))
    return _bwd(_prepared(x, dt, A, B, C, D), x.shape[1], cum, hst, dy,
                dfinal)


class _SSDScan(torch.autograd.Function):
    """The scan's one autograd. Real tensors launch the kernel directly
    (no dispatcher round trip, which cost pack4k 0.33 % of its tokens/s)
    and keep their prepared inputs for the backward; fake tensors (the dry
    run's) call the custom ops `ssd_scan` / `ssd_scan_bwd`."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk):
        S = x.shape[1]
        ctx.meta = (S, chunk, dt.dtype, A.dtype, B.dtype, D.dtype)
        ctx.fake = custom_ops.is_fake(x, dt, A, B, C, D)
        if ctx.fake:
            ins = (x, dt, A, B, C, D)
            y, final, cum, hst = custom_ops.op("ssd_scan")(*ins, chunk)
        else:
            ins = _prepared(x, dt, A, B, C, D)
            y, final, cum, hst = _fwd(ins, S)
        ctx.save_for_backward(*ins, cum, hst)
        # no zeros made for a cotangent nobody gave (the final state's)
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        *ins, cum, hst = ctx.saved_tensors
        S, chunk, dt_t, A_t, B_t, D_t = ctx.meta
        x = ins[0]
        if dy is None:
            dy = x.new_zeros((x.shape[0], S, *x.shape[2:]))
        if ctx.fake:
            dx, ddt, dA, dB, dC, dD = custom_ops.op("ssd_scan_bwd")(
                *ins, cum, hst, dy, dfinal, chunk)
        else:
            dx, ddt, dA, dB, dC, dD = _bwd(ins, S, cum, hst, dy, dfinal)
        return (dx, ddt.to(dt_t), dA.to(A_t), dB.to(B_t), dC.to(B_t),
                dD.to(D_t), None)


def ssd_scan(x, dt, A, B, C, D, *, chunk: int):
    """The SSD scan through the kernel -> (y, final state), differentiable;
    see the module's docstring."""
    _check(x, dt, A, B, C, D, chunk)
    ok, why = kernel_accepts(x, B, chunk)
    if not ok:
        raise ValueError(why)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD scan kernel for device {x.device}: the "
                         "plain version is models/mamba2.py::ssd_chunked")
    return _SSDScan.apply(x, dt, A, B, C, D, chunk)


_LIB = None


def _library():
    global _LIB
    from repro_torch.kernels import build
    _LIB = build.library("ssd_scan")
    return _LIB


custom_ops.define_ssd_scan(_fwd_launch, _bwd_launch, tiling)
