"""CLI for the port's static analyzer:
`python -m repro_torch.analysis [--all|--ast|--kernels|--sharding|--graphs]`.

Exit code 0 iff every finding is in the committed baseline (report.gate).
The AST pass is pure source analysis; `--kernels` derives the kernels'
limits from their caps and the C sources (and, on the card, holds them
against its shared memory); `--sharding` audits every leaf the resolved
sharding plan places (meta tensors; no device); `--graphs` runs the
reduced train step and
serve replays under the dispatch recorder (seconds on the CPU). Both run
on `--device` (default cuda; with no card they fail unless `--device cpu`
is given: there is no fallback). `--update-baseline` rewrites the
baseline from the current findings, keeping existing justifications.

    python -m repro_torch.analysis --all --device cpu
    python -m repro_torch.analysis --ast src/repro_torch/serve
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List

from repro_torch.analysis import report
from repro_torch.analysis.report import Finding


def _ast_findings(paths: List[str]) -> List[Finding]:
    from repro_torch.analysis import ast_lint
    if not paths:
        return ast_lint.lint_package()
    return ast_lint.lint_paths(paths)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis",
        description="static hot-path analyzer of the PyTorch port")
    ap.add_argument("--all", action="store_true",
                    help="run every pass: --ast, --kernels, --sharding and "
                         "--graphs (default when none is selected)")
    ap.add_argument("--ast", action="store_true",
                    help="Python source lint over src/repro_torch (or PATHS)")
    ap.add_argument("--kernels", action="store_true",
                    help="kernel capability verifier (with the card's "
                         "shared memory when --device is cuda)")
    ap.add_argument("--graphs", action="store_true",
                    help="dispatch lint of the train step and the decode "
                         "loop")
    ap.add_argument("--sharding", action="store_true",
                    help="sharding-coverage audit")
    ap.add_argument("--device", default=None,
                    help="device of --kernels and --graphs (default: cuda; "
                         "fails without one)")
    ap.add_argument("--json", metavar="PATH",
                    help="also write the machine-readable report here")
    ap.add_argument("--baseline", metavar="PATH",
                    help=f"baseline file (default {report.DEFAULT_BASELINE})")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from the current findings "
                         "(keeps existing justifications) and exit 0")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs for the AST pass (default: "
                         "src/repro_torch)")
    args = ap.parse_args(argv)

    chosen = args.ast or args.kernels or args.sharding or args.graphs
    run_all = args.all or not chosen
    findings: List[Finding] = []
    if run_all or args.ast:
        findings += _ast_findings(args.paths)
    if run_all or args.kernels or args.graphs:
        from repro_torch.devices import resolve_device
        device = resolve_device(args.device)
    if run_all or args.kernels:
        from repro_torch.analysis import kernel_audit
        findings += kernel_audit.run()
        if device.type == "cuda":
            findings += kernel_audit.audit_device(device)
    if run_all or args.sharding:
        from repro_torch.analysis import sharding_audit
        findings += sharding_audit.run()
    if run_all or args.graphs:
        from repro_torch.analysis import graphs
        findings += graphs.run(device)

    baseline = report.load_baseline(args.baseline)
    if args.update_baseline:
        report.save_baseline(findings, args.baseline, old=baseline)
        print(f"baseline updated: {len(findings)} finding(s) -> "
              f"{args.baseline or report.DEFAULT_BASELINE}")
        return 0
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report.to_json(findings, baseline), f, indent=2)
            f.write("\n")
    print(report.render(findings, baseline))
    return report.gate(findings, baseline)


if __name__ == "__main__":
    sys.exit(main())
