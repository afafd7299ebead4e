"""Findings, reports, and the baseline gate (a copy of the JAX package's
`analysis/report.py`, which this package may not import).

Every analyzer pass returns a flat list of `Finding`s. A finding's identity
is its `key` — ``section:rule:where`` — which is what the committed baseline
file (`repro_torch/analysis/baseline.json`) records: a known, justified finding that the
gate tolerates. The gate fails on NEW findings only (not in the baseline),
so the workflow for a finding is fix it, suppress it at the site
(`# repro: allow(<rule>)`, AST pass only), or baseline it WITH a written
justification — never ignore it.

Baseline format (versioned, human-editable)::

    {"version": 1,
     "findings": {"<section>:<rule>:<where>": "<justification>"}}

`--update-baseline` rewrites the file from the current findings, keeping
existing justifications and stamping new entries "TODO: justify".
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

BASELINE_VERSION = 1

# the committed repo baseline, importable by CI/tests/CLI alike
DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.json")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer finding. `section` is the pass ("dispatch" |
    "kernels" | "ast"), `rule` the specific check, `where` a stable
    location string (file:line for AST, path/op labels otherwise) — the
    three together are the baseline identity. `mult` carries loop
    multiplicity where it means something (transfers per step)."""
    section: str
    rule: str
    where: str
    message: str
    mult: float = 1.0

    @property
    def key(self) -> str:
        return f"{self.section}:{self.rule}:{self.where}"

    def render(self) -> str:
        tail = f"  (x{self.mult:g} per call)" if self.mult > 1 else ""
        return f"[{self.section}/{self.rule}] {self.where}: {self.message}{tail}"


def load_baseline(path: Optional[str] = None) -> Dict[str, str]:
    """{finding key: justification}. A missing file is an empty baseline."""
    path = path or DEFAULT_BASELINE
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(f"{path}: unsupported baseline version "
                         f"{data.get('version')!r} (expected "
                         f"{BASELINE_VERSION})")
    return dict(data.get("findings", {}))


def save_baseline(findings: Sequence[Finding], path: Optional[str] = None,
                  old: Optional[Mapping[str, str]] = None) -> None:
    old = dict(old or {})
    entries = {f.key: old.get(f.key, "TODO: justify") for f in findings}
    path = path or DEFAULT_BASELINE
    with open(path, "w") as f:
        json.dump({"version": BASELINE_VERSION,
                   "findings": dict(sorted(entries.items()))}, f, indent=2)
        f.write("\n")


def diff(findings: Sequence[Finding],
         baseline: Mapping[str, str]) -> Tuple[List[Finding], List[str]]:
    """-> (new findings not in the baseline, stale baseline keys that no
    current finding matches). Stale keys don't fail the gate — they're a
    cleanup nudge printed with the report."""
    keys = {f.key for f in findings}
    new = [f for f in findings if f.key not in baseline]
    stale = sorted(k for k in baseline if k not in keys)
    return new, stale


def gate(findings: Sequence[Finding],
         baseline: Mapping[str, str]) -> int:
    """Exit code for the CI gate: 0 iff every finding is baselined."""
    new, _ = diff(findings, baseline)
    return 1 if new else 0


def to_json(findings: Sequence[Finding],
            baseline: Mapping[str, str]) -> Dict:
    """Machine-readable report (the CLI's `--json`)."""
    new, stale = diff(findings, baseline)
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.section] = counts.get(f.section, 0) + 1
    return {
        "version": BASELINE_VERSION,
        "counts": counts,
        "n_findings": len(findings),
        "n_new": len(new),
        "n_baselined": len(findings) - len(new),
        "new": [f.key for f in new],
        "stale_baseline": stale,
        "findings": [dataclasses.asdict(f) for f in findings],
    }


def render(findings: Sequence[Finding], baseline: Mapping[str, str]) -> str:
    """Human report: new findings first, then baselined ones, then stale
    baseline keys."""
    new, stale = diff(findings, baseline)
    newk = {f.key for f in new}
    lines: List[str] = []
    if new:
        lines.append(f"{len(new)} NEW finding(s) — fix, suppress, or "
                     "baseline with a justification:")
        lines += ["  " + f.render() for f in new]
    baselined = [f for f in findings if f.key not in newk]
    if baselined:
        lines.append(f"{len(baselined)} baselined finding(s):")
        lines += [f"  {f.render()}\n      justification: "
                  f"{baseline.get(f.key, '')}" for f in baselined]
    if stale:
        lines.append(f"{len(stale)} stale baseline entr(y/ies) — remove "
                     "from baseline.json:")
        lines += ["  " + k for k in stale]
    if not lines:
        lines.append("no findings.")
    return "\n".join(lines)
