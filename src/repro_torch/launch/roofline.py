"""Roofline report: renders the per-cell dry-run JSONs into the roofline
and dry-run tables (the JAX package's `launch/roofline.py`), with hints in
the H100's terms.

    python -m repro_torch.launch.roofline [--dir build/dryrun] \\
        [--mesh 16x16] [--variant baseline] [--summary]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

from repro_torch import configs

# the report's row order: the JAX package's ARCH_IDS, so both packages
# render one table alike
ARCH_ORDER = ("musicgen-medium", "yi-9b", "qwen3-4b", "yi-6b", "qwen2.5-32b",
              "qwen2-vl-72b", "zamba2-7b", "olmoe-1b-7b",
              "phi3.5-moe-42b-a6.6b", "mamba2-2.7b")

HINTS = {
    "compute_s": "raise tensor-core utilization: bigger per-device tiles, "
                 "remove remat recompute, fuse adapter materialization",
    "memory_s": "cut HBM traffic: a fused attention kernel (recompute p "
                "instead of spilling (nq, nk) probability blocks), bf16 "
                "cotangents, larger microbatches",
    "collective_s": "cut NVLink/InfiniBand traffic: shard kv heads instead "
                    "of gathering them, overlap collectives with compute, "
                    "reduce-scatter gradient flow, keep the slow pod hop "
                    "for the gradient reduction",
}


def load(dir_: str) -> List[Dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def _ordered(rows: List[Dict], mesh: str, variant: str) -> List[Dict]:
    rows = [r for r in rows if r["mesh"] == mesh
            and r.get("variant", "baseline") == variant]
    order = {a: i for i, a in enumerate(ARCH_ORDER)}
    shape_order = {s.name: i for i, s in enumerate(configs.SHAPES)}
    return sorted(rows, key=lambda r: (order.get(r["arch"], 99),
                                       shape_order.get(r["shape"], 9)))


def render(rows: List[Dict], mesh: str = "16x16",
           variant: str = "baseline") -> str:
    lines = [
        "| arch | shape | compute | memory [min..up] | collective | dominant "
        "| MODEL_FLOPS | useful ratio | roofline frac | HBM fit |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in _ordered(rows, mesh, variant):
        t = r["terms"]
        dom = r["dominant"].replace("_s", "")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(t['compute_s'])} "
            f"| {fmt_s(t['memory_s'])}.."
            f"{fmt_s(t.get('memory_s_upper', t['memory_s']))} "
            f"| {fmt_s(t['collective_s'])} | {dom} "
            f"| {r['model_flops']:.2e} | {r['useful_flops_ratio']:.2f} "
            f"| {r['roofline_fraction']:.4f} "
            f"| {'Y' if r['memory']['fits_hbm'] else 'N'} |")
    for arch in ARCH_ORDER:
        if not configs.get(arch).subquadratic:
            lines.append(f"| {arch} | long_500k | — | — | — | SKIP "
                         f"(full attention; DESIGN.md §Arch-applicability) "
                         f"| — | — | — | — |")
    return "\n".join(lines)


def render_dryrun(rows: List[Dict], mesh: str) -> str:
    lines = [
        "| arch | shape | bytes/dev (args+temp) | flops/dev | coll bytes/dev "
        "| collectives | compile |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in _ordered(rows, mesh, "baseline"):
        m = r["memory"]
        coll = "; ".join(f"{k}:{int(v)}" for k, v in
                         sorted(r.get("collective_counts", {}).items()))
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {(m['argument_bytes'] + m['temp_bytes']) / 1e9:.2f}GB "
            f"| {r['flops_per_device']:.2e} "
            f"| {r['collective_bytes_per_device']:.2e} | {coll or '—'} "
            f"| {r['compile_seconds']:.0f}s |")
    return "\n".join(lines)


def dominant_summary(rows: List[Dict], mesh: str) -> str:
    lines = []
    for r in rows:
        if r["mesh"] != mesh or r.get("variant", "baseline") != "baseline":
            continue
        lines.append(f"- **{r['arch']} × {r['shape']}**: dominated by "
                     f"{r['dominant'].replace('_s', '')} — "
                     f"{HINTS[r['dominant']]}.")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--mesh", default="16x16",
                    help="mesh tag to filter rows by (launch/mesh.py "
                         "parse_mesh_shape's DxM format)")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--summary", action="store_true",
                    help="also print the per-cell dominant-term summary")
    args = ap.parse_args(argv)
    rows = load(args.dir)
    print(render(rows, args.mesh, args.variant))
    if args.summary:
        print()
        print(dominant_summary(rows, args.mesh))


if __name__ == "__main__":
    main()
