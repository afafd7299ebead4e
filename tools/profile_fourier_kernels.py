#!/usr/bin/env python3
"""Where the time of the FFT-structured kernels goes, on one NVIDIA card:
FourierFT's K1 (ΔW) and K2 (dc), and the dct method's K4 (ΔW) and K5 (dc),
which share their passes (`csrc/fft_rows.cuh`).

    python3 tools/profile_fourier_kernels.py

1. Device time of each CUDA kernel a K1, K2, K4 or K5 launch runs
   (`torch.profiler`, mean over 10 launches): the ΔW kernels' scatter plan
   and row transforms, the dc kernels' entry table, row transforms and
   reduction, at the main-path shapes (yi-6b wq 4096x4096 and wv 4096x512,
   n = 1000, L = 2) and yi-6b's MLP 4096x11008.
2. Phase ablation: both libraries rebuilt with one phase cut out of the
   shared passes (the shared-memory transform; the ΔW kernels' scatter
   rounds and the dc kernels' entry gathers; both), each timed with CUDA
   events at the main shapes. The cut libraries give wrong results and
   serve only to split the time.

Prints one line per measurement, with the card's name and power limit
first. Imports nothing of JAX; needs the repository's `src/` and nvcc.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MAIN = ((4096, 4096, 1000, 2), (4096, 512, 1000, 2))
# the kernel libraries, each with its wrapper module and its ΔW and dc
LIBS = {"fourier_deltaw": ("K1", "K2"), "dct_deltaw": ("K4", "K5")}
# (file, text, replacement): each cut removes one phase's work
CUTS = {
    "transform": [("fft_smem.cuh", "const int r = p.radix[s], m = p.span[s];",
                   "return;\n  const int r = p.radix[s], m = p.span[s];")],
    "scatter+gather": [
        ("fft_rows.cuh", "const int rounds = *s.rounds;",
         "const int rounds = 0;"),
        ("fft_rows.cuh",
         "for (int e = threadIdx.x; e < n; e += blockDim.x) {\n"
         "      unsigned places",
         "for (int e = threadIdx.x; e < 0; e += blockDim.x) {\n"
         "      unsigned places")],
}
CUTS["both"] = CUTS["transform"] + CUTS["scatter+gather"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_fourier_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.fourierft import sample_entries
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import dct_deltaw as ddk
    from repro_torch.kernels import fourier_deltaw as fdk
    mods = {"fourier_deltaw": fdk, "dct_deltaw": ddk}

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    kb.build_all(tuple(LIBS))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def inputs(d1, d2, n, L):
        entries = sample_entries(d1, d2, n, seed=7).to(dev)
        npad = -(-n // fdk.NC) * fdk.NC
        e = torch.zeros((2, npad), dtype=torch.int32, device=dev)
        e[:, :n] = entries
        c = torch.zeros((L, npad), device=dev)
        c[:, :n] = torch.randn((L, n), generator=gen, device=dev)
        g = torch.randn((L, d1, d2), generator=gen, device=dev)
        return e[0].contiguous(), e[1].contiguous(), c, g

    def timed_ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    # ---- 1. device time per CUDA kernel ----------------------------------
    for d1, d2, n, L in MAIN + ((4096, 11008, 1000, 1),):
        u, v, c, g = inputs(d1, d2, n, L)
        for lib, mod in mods.items():
            for _ in range(3):
                mod.deltaw(c, u, v, d1, d2, 300.0)
                mod.dc(g, u, v, d1, d2, 300.0)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    mod.deltaw(c, u, v, d1, d2, 300.0)
                    mod.dc(g, u, v, d1, d2, 300.0)
                torch.cuda.synchronize()
            for ev in prof.key_averages():
                us = getattr(ev, "device_time_total", 0) or 0
                if us > 0:
                    name = ev.key.replace("(anonymous namespace)::", "")
                    name = name.replace("void ", "").split("(")[0]
                    print(f"[kernels] {'/'.join(LIBS[lib])} {d1}x{d2} L={L} "
                          f"{name}: {us / ev.count:.1f} us per launch")
        del g

    # ---- 2. phase ablation ------------------------------------------------
    # (cut, library) -> the loaded library; "nothing" is the real one
    libs = {("nothing", lib): kb.library(lib) for lib in LIBS}
    procs = {}
    for name, cuts in CUTS.items():
        d = ROOT / "build" / "profile_cuts" / name.replace("+", "_")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(kb.CSRC, d)
        for fname, text, repl in cuts:
            src = (d / fname).read_text()
            if text not in src:
                print(f"profile_fourier_kernels: cut {name!r} no longer "
                      f"matches {fname}", file=sys.stderr)
                return 1
            (d / fname).write_text(src.replace(text, repl))
        for lib in LIBS:
            procs[name, lib] = (d / f"lib{lib}.so", subprocess.Popen(
                [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(d / f"lib{lib}.so"),
                 str(d / f"{lib}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    for (name, lib), (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"profile_fourier_kernels: nvcc failed for {name} "
                  f"({lib}):\n{log}", file=sys.stderr)
            return 1
        cdll = ctypes.CDLL(str(path))
        for fn, argtypes in kb.SIGNATURES[lib].items():
            getattr(cdll, fn).argtypes = list(argtypes)
            getattr(cdll, fn).restype = ctypes.c_int
        libs[name, lib] = cdll
    for d1, d2, n, L in MAIN:
        u, v, c, g = inputs(d1, d2, n, L)
        for (name, lib), cdll in libs.items():
            kb._LIBS[lib] = cdll
            mod = mods[lib]
            dw = timed_ms(lambda: mod.deltaw(c, u, v, d1, d2, 300.0))
            dc = timed_ms(lambda: mod.dc(g, u, v, d1, d2, 300.0))
            kdw, kdc = LIBS[lib]
            print(f"[cut] {d1}x{d2} L={L} without {name}: {kdw} {dw:.4f} "
                  f"ms, {kdc} {dc:.4f} ms")
            kb._LIBS[lib] = libs["nothing", lib]
        del g
    return 0


if __name__ == "__main__":
    sys.exit(main())
