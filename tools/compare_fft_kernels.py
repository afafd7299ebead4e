#!/usr/bin/env python3
"""Hold the FFT-structured kernels' output bits against another tree's, on
one NVIDIA card: FourierFT's K1 (ΔW) and K2 (dc), the dct method's K4 (ΔW)
and K5 (dc), at chip_smoke phase 3's shapes and one of 27648 columns (the
widest a single block takes with odd factors), all inside one block's
shared memory.

    python3 tools/compare_fft_kernels.py --src build/parent/src

Each tree's kernels run in a process of their own (the other tree's `src/`
on the path, its libraries built from its own `csrc/`) on the same inputs,
made on the card from fixed seeds; the outputs are compared by their
SHA-256. Exit 0 when every output is bit-identical, else 1. Prints the
card's name and power limit first, then one line per output. Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (d1, d2, n, L): chip_smoke phase 3's shapes, and one row near the single
# block's limit
SHAPES = ((4096, 4096, 1000, 2), (4096, 512, 1000, 2), (300, 520, 37, 1),
          (5120, 5120, 1000, 1), (4096, 11008, 1000, 1), (6, 27648, 40, 1))


def digests(src: Path) -> dict:
    """{"K1 d1xd2": sha256, ...} of this process's kernels (`src` first on
    the path) on the fixed inputs."""
    sys.path.insert(0, str(src))
    import torch
    from repro_torch.core.fourierft import sample_entries
    from repro_torch.kernels import dct_deltaw as ddk
    from repro_torch.kernels import fourier_deltaw as fdk
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {}
    for d1, d2, n, L in SHAPES:
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        e = sample_entries(d1, d2, n, seed=7).to(dev)
        npad = -(-n // fdk.NC) * fdk.NC
        u = torch.zeros(npad, dtype=torch.int32, device=dev)
        v = torch.zeros_like(u)
        u[:n], v[:n] = e[0], e[1]
        c = torch.zeros((L, npad), device=dev)
        c[:, :n] = torch.randn((L, n), generator=gen, device=dev)
        g = torch.randn((L, d1, d2), generator=gen, device=dev)
        for name, fn, arg in (("K1", fdk.deltaw, c), ("K2", fdk.dc, g),
                              ("K4", ddk.deltaw, c), ("K5", ddk.dc, g)):
            got = fn(arg, u, v, d1, d2, 300.0).cpu().numpy()
            out[f"{name} {d1}x{d2}"] = hashlib.sha256(
                got.tobytes()).hexdigest()
        del g
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--src", required=True,
                    help="the other tree's src/ (e.g. a `git archive` of "
                         "the parent commit unpacked under build/)")
    ap.add_argument("--digests-only", action="store_true",
                    help="print this process's digests as JSON and exit")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_fft_kernels: no CUDA device", file=sys.stderr)
        return 1
    if args.digests_only:
        print("DIGESTS " + json.dumps(digests(Path(args.src).resolve())))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    runs = {}
    for tag, src in (("this", ROOT / "src"), ("other", Path(args.src))):
        proc = subprocess.run(
            [sys.executable, __file__, "--src", str(src.resolve()),
             "--digests-only"], capture_output=True, text=True, timeout=900)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("DIGESTS ")]
        if proc.returncode or not line:
            print(f"compare_fft_kernels: the {tag} tree failed: "
                  f"{proc.stderr[-2000:]}", file=sys.stderr)
            return 1
        runs[tag] = json.loads(line[0][len("DIGESTS "):])
    same = True
    for key, digest in runs["this"].items():
        equal = digest == runs["other"].get(key)
        same &= equal
        print(f"{key}: {'bit-identical' if equal else 'DIFFERENT'} "
              f"({digest[:16]})")
    print("every output bit-identical to the other tree's" if same
          else "outputs differ")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
