"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface (it may include the headers
`csrc/*.cuh`, such as the shared-memory FFT) and is compiled on its own by
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`
into `build/repro_torch_kernels/` at the repository root (git-ignored),
then loaded with `ctypes`. The build runs at first use; `build_all()` starts
one nvcc per source at once. A library's file name carries a hash of its
source and the headers, so an edit is rebuilt and an unchanged one reused.

Every C entry point takes its pointers and the CUDA stream as `void*` and
returns `cudaGetLastError()` after its launches; `check()` raises on a
non-zero code. Nothing here is imported or built for CPU tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> ((argtypes...), ) of the C entry points each library exports
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES: Dict[str, Dict[str, Tuple]] = {
    "fourier_deltaw": {
        # cos, sin, d, stream
        "fourier_twiddles_launch": (_P, _P, _I, _P),
        # c, u, v, cos1, sin1, tw, pos, scratch, out, plan, L, n, d1, d2,
        # scale, stream
        "fourier_deltaw_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _F, _P),
        # g, u, v, cos1, sin1, tw, pos, partial, out, plan, L, n, d1, d2,
        # scale, stream
        "fourier_dc_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _F, _P),
    },
    "dct_deltaw": {
        # c, u, v, cos1, phic, phis, tw, pos, scratch, out, plan, L, n, d1,
        # d2, scale, stream
        "dct_deltaw_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _F, _P),
        # g, u, v, cos1, phic, phis, tw, pos, partial, out, plan, L, n, d1,
        # d2, scale, stream
        "dct_dc_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _F, _P),
    },
    "paged_attention": {
        # q, k_pages, v_pages, block_table, kv_len, out, work, dims (int
        # array: B, W, H, K, dh, ps, pps, splits, pages_per_split, rows,
        # groups, is_bf16), stream
        "paged_attention_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P),
        # dims, blocks (int*: written)
        "paged_attention_occupancy": (_P, _P),
    },
    "fused_attention": {
        # q, k, v, out, lse, B, S, H, K, dh, causal, scale, stream
        "fused_attention_fwd_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _I, _I, _F, _P),
        # q, k, v, out, dout, lse, delta, dq, dk, dv, B, S, H, K, dh,
        # causal, scale, stream
        "fused_attention_bwd_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _I, _I, _I, _I, _I, _I, _F, _P),
    },
    "ssd_scan": {
        # pointers (void* array: x, dt, A, B, C, D, y, final, cum, states),
        # dims (int array: b, S, H, G, N, Q, heads a block, is_bf16), stream
        "ssd_scan_fwd_launch": (_P, _P, _P),
        # pointers (x, dt, A, B, C, D, dy, dfinal or null, cum, states, the
        # scratch, dx, ddt, dB, dC), dims, stream
        "ssd_scan_bwd_launch": (_P, _P, _P),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}      # name -> nvcc output (ptxas -v report)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit under "
                       "/usr/local/cuda)")


def _target(name: str) -> Path:
    # the source, every header of csrc/ (a source may include any) and
    # the flags
    data = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(data + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> float:
    """Compile every named kernel library that is not built yet, one nvcc
    process per source, all started together. Returns the seconds taken."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    lib = ctypes.CDLL(str(_target(name)))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
