"""Kernel-capability verifier for the port's five Hopper kernels (the JAX
package's `src/repro/analysis/kernel_audit.py`).

Every `KernelOp` with a `caps` record (kernels/api.py) states what its C
side assumes; this pass re-derives from those assumptions the shape limits
the op's `accepts` enforces, and fails where a declaration is LOOSER than
its derivation. A declaration below its derivation is conservative and
passes.

- **K1/K2 and K4/K5** (`fft_rows` caps, `kernels/fft_plan.py`; one plan
  and one set of limits for the four kernels):
  - `MAX_D2` from the shared memory a block may request: one unpadded
    complex f32 row of d2 points (`smem_bytes // point_bytes`);
  - `MAX_D1` from the phase products: K1/K2 reduce `j·u mod d1` with
    j, u < d1 in one product of `phase_bits` (unsigned 32-bit, so
    (d1 − 1)² < 2³²; a signed product would allow only (d1 − 1)² < 2³¹),
    K4/K5 `(2j+1)·u mod 4·d1` with u < 4·d1 in a 64-bit product; both then
    step the phase in a 32-bit sum that stays below twice the modulus;
  - `MAX_N` from the scatter plan: 2n ints (`scatter_entry_bytes` an
    entry) beside its static `part[SORT_THREADS]` ints, n padded to the
    entry chunk;
  - `MAX_RADIX` from the generic odd stage's local array (the largest odd
    radix it holds).
- **K3** (`paged_attention` caps, `kernels/paged_attention.py`): the
  largest head class the C side instantiates bounds `MAX_HEAD_DIM`; a bf16
  block takes an M tile of 16 rows per warp and an f32 block `MAXR` rows,
  which bound `MAX_ROWS`; each instance's shared memory (the `Layout` of
  csrc/paged_attention.cu: the K/V ring or the bf16 warps' merge scratch,
  q, the f32 scores and row statistics, the key-row offsets) at
  `MAX_HEAD_DIM` and `MAX_ROWS` must fit what a block requests
  (`smem-over-budget`, the counterpart of `vmem-over-budget`).

Rule ids are the JAX pass's: `bound-missing` (caps but no `accepts`, or an
`accepts` that admits a shape past a derived limit), `bound-loosened` (a
declared limit above its derivation), `constant-drift` (a Python constant
or a caps field that disagrees with the C sources, which this pass reads),
`unknown-caps`, and `smem-over-budget`. `limit-below-reference` reports a
kernel whose accepted range is narrower than the JAX package's
(`REFERENCE_LIMITS`): not a fault of the port, a gap it carries.

`audit_device(device)` runs only on the card: it holds every shared-memory
request (`fft_plan.SMEM_BYTES`, the C sides' `SMEM_MAX` and K3's
`cudaFuncSetAttribute`) and every derivation against the card's opt-in
shared memory per block.

Ops without caps (the plain versions, library routes) have nothing to
verify and are skipped.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.analysis.report import Finding

# the JAX package's accepted widths (src/repro/kernels/ops.py:36-37:
# FOURIER_INT32_SAFE_DIM, DCT_INT32_SAFE_DIM), copied: this package imports
# nothing of it
REFERENCE_LIMITS = {"fourier": 46_336, "dct": 32_500}
_PHASE_METHOD = {"linear": "fourier", "half": "dct"}

CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"


# ---------------------------------------------------------------------------
# The C sides' constants
# ---------------------------------------------------------------------------

def _constexprs(text: str) -> Dict[str, int]:
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr\s+int\s+(\w+)\s*=\s*(\d+)\s*;", text)}


def csrc_constants(csrc: Path = CSRC) -> Dict[str, Dict]:
    """{"fft": constants of fft_rows.cuh and fft_smem.cuh, "k3": those of
    paged_attention.cu with its shared-memory request and limits and the
    (head class, CHUNK[, MAXR]) of each instance `dispatch` picks}."""
    fft = {**_constexprs((csrc / "fft_smem.cuh").read_text()),
           **_constexprs((csrc / "fft_rows.cuh").read_text())}
    text = (csrc / "paged_attention.cu").read_text()
    k3 = _constexprs(text)

    def first(pattern: str) -> Optional[int]:
        m = re.search(pattern, text)
        return int(m.group(1)) if m else None

    k3.update(
        attr=first(r"cudaFuncAttributeMaxDynamicSharedMemorySize,\s*(\d+)"),
        smem_max=first(r"if \(smem > (\d+)\)"),
        max_head_dim=first(r" dh > (\d+) \|\|"),        # make_args
        max_splits=first(r" splits > (\d+) \|\|"),
        classes={
            "bfloat16": tuple((int(a), int(b)) for a, b in re.findall(
                r"run_bf16_split<(\d+), (\d+)>\(a", text)),
            "float32": tuple((int(a), int(b)) for a, b, _ in re.findall(
                r"run_f32<(\d+), (\d+), (\d+)>\(a", text))},
        f32_max_rows=tuple(sorted({int(c) for _, _, c in re.findall(
            r"run_f32<(\d+), (\d+), (\d+)>\(a", text)})))
    return {"fft": fft, "k3": k3}


# ---------------------------------------------------------------------------
# Derivations: K1/K2, K4/K5
# ---------------------------------------------------------------------------

def _phase_fits(d: int, caps: Dict) -> bool:
    """Whether d1 = d keeps the row phase exact: the one product below
    2^phase_bits (2^(bits-1) signed) and the running sum p + step, both
    below the modulus, below 2^accum_bits."""
    bits = caps["phase_bits"] - (1 if caps["phase_signed"] else 0)
    if caps["phase"] == "linear":          # (j·u) mod d1, j, u < d1
        q = d
        product = (d - 1) * (d - 1)
    elif caps["phase"] == "half":          # ((2j+1)·u) mod 4·d1, u < 4·d1
        q = 4 * d
        product = (2 * (d - 1) + 1) * (q - 1)
    else:
        raise ValueError(f"unknown phase kind {caps['phase']!r}")
    return product < 2 ** bits and 2 * (q - 1) < 2 ** caps["accum_bits"]


def derived_d1(caps: Dict) -> int:
    """Largest d1 whose row phase stays exact (nondecreasing: bisect)."""
    lo, hi = 1, 1 << 40
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if _phase_fits(mid, caps):
            lo = mid
        else:
            hi = mid - 1
    return lo


def derived_fft_limits(caps: Dict, smem_bytes: Optional[int] = None
                       ) -> Dict[str, int]:
    """{"MAX_D2", "MAX_D1", "MAX_N", "MAX_RADIX"} as `caps` allows them,
    at `smem_bytes` (default the caps' own request)."""
    smem = caps["smem_bytes"] if smem_bytes is None else smem_bytes
    chunk = caps["entry_chunk"]
    n = (smem - caps["scatter_static_bytes"]) // caps["scatter_entry_bytes"]
    regs = caps["odd_radix_regs"]
    return {"MAX_D2": smem // caps["point_bytes"],
            "MAX_D1": derived_d1(caps),
            "MAX_N": n // chunk * chunk,
            "MAX_RADIX": regs if regs % 2 else regs - 1}


def declared_fft_limits() -> Dict[str, int]:
    from repro_torch.kernels import fft_plan
    return {k: getattr(fft_plan, k)
            for k in ("MAX_D2", "MAX_D1", "MAX_N", "MAX_RADIX")}


def _smooth(d: int, most: int) -> bool:
    for p in range(2, most + 1):
        while d % p == 0:
            d //= p
    return d == 1


def fft_probes(lim: Dict[str, int]):
    """(limit name, d1, d2, n) shapes just past each limit of `lim`, each
    inside the other limits (d2 7-smooth, so only the width can refuse)."""
    d2 = lim["MAX_D2"] + 1
    while not _smooth(d2, 7):
        d2 += 1
    p = lim["MAX_RADIX"] + 2
    while any(p % q == 0 for q in range(3, int(p ** 0.5) + 1, 2)):
        p += 2
    return (("MAX_D2", 2, d2, 16), ("MAX_D1", lim["MAX_D1"] + 1, 64, 16),
            ("MAX_N", 256, 256, lim["MAX_N"] + 16), ("MAX_RADIX", 2, p, 16))


def _audit_fft(op, caps: Dict, where: str) -> List[Finding]:
    out: List[Finding] = []
    lim = derived_fft_limits(caps)
    for name, declared in declared_fft_limits().items():
        if declared > lim[name]:
            out.append(Finding(
                "kernels", "bound-loosened", f"{where}/{name}",
                f"declared fft_plan.{name} {declared} exceeds {lim[name]} "
                f"derived from the kernel's caps (phase {caps['phase']}, "
                f"{caps['phase_bits']}-bit "
                f"{'signed' if caps['phase_signed'] else 'unsigned'} "
                f"product, {caps['smem_bytes']} B of shared memory a block)"))
    if op.accepts is None:
        return out + [Finding(
            "kernels", "bound-missing", where,
            "caps declared but no `accepts` on the op: the derived limits "
            f"{lim} are unenforced")]
    from repro_torch.configs.base import PEFTConfig
    for name, d1, d2, n in fft_probes(lim):
        ok, _ = op.accepts(d1, d2, PEFTConfig(method=op.method, n=n), None)
        if ok:
            out.append(Finding(
                "kernels", "bound-missing", f"{where}/{name}",
                f"accepts admits d1={d1}, d2={d2}, n={n}, past the derived "
                f"{name} {lim[name]}"))
    return out


# ---------------------------------------------------------------------------
# Derivations: K3
# ---------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def k3_smem_bytes(dh: int, rows: int, bf16: bool, chunk: int,
                  caps: Dict) -> int:
    """Dynamic shared memory of one K3 block (`Layout` in
    csrc/paged_attention.cu): the ring of 4·CHUNK K/V rows (in bf16 at
    least the warps' merge scratch, WARPS·16 rows of kd + 1 floats and
    their statistics), q, in f32 the scores and row max, denominator and
    rescale, then OFF_SLOTS chunks of key-row offsets."""
    warps = caps["threads"] // 32
    elt = 2 if bf16 else 4
    kd = _round_up(dh, 16 if bf16 else 4)
    stride = kd + (8 if bf16 else 4)
    rows_p = _round_up(rows, 16 if bf16 else 4)
    ring = 4 * chunk * stride * elt
    if bf16:
        merge = (warps * 16 * (kd + 1) + 2 * warps * 16) * 4
        ring = ring if ring > merge else _round_up(merge, 16)
    total = ring + rows_p * stride * elt
    if not bf16:
        total += rows_p * (chunk + 4) * 4 + 3 * rows_p * 4
    return total + caps["off_slots"] * chunk * 8


def derived_k3(caps: Dict) -> Dict:
    """{"MAX_HEAD_DIM", "MAX_ROWS": {bf16: rows}} as the instances allow."""
    return {"MAX_HEAD_DIM": min(max(hc for hc, _ in classes)
                                for classes in caps["classes"].values()),
            "MAX_ROWS": {True: 16 * (caps["threads"] // 32),
                         False: caps["f32_max_rows"]}}


def k3_instances(caps: Dict, max_head_dim: int, max_rows: Dict):
    """(dtype, head class, CHUNK, rows, shared bytes) of every instance at
    the declared limits (a class past MAX_HEAD_DIM is never picked)."""
    out = []
    for dt, classes in caps["classes"].items():
        bf16 = dt == "bfloat16"
        lo = 0
        for hc, chunk in classes:
            if lo >= max_head_dim:
                break
            dh = min(hc, max_head_dim)
            rows = max_rows[bf16]
            out.append((dt, hc, chunk, rows,
                        k3_smem_bytes(dh, rows, bf16, chunk, caps)))
            lo = hc
    return out


def _audit_k3(op, caps: Dict, where: str,
              smem_bytes: Optional[int] = None) -> List[Finding]:
    from repro_torch.kernels import paged_attention as pak
    out: List[Finding] = []
    der = derived_k3(caps)
    if pak.MAX_HEAD_DIM > der["MAX_HEAD_DIM"]:
        out.append(Finding(
            "kernels", "bound-loosened", f"{where}/MAX_HEAD_DIM",
            f"declared MAX_HEAD_DIM {pak.MAX_HEAD_DIM} exceeds the widest "
            f"head class the C side instantiates ({der['MAX_HEAD_DIM']})"))
    for bf16, rows in pak.MAX_ROWS.items():
        if rows > der["MAX_ROWS"][bf16]:
            out.append(Finding(
                "kernels", "bound-loosened",
                f"{where}/MAX_ROWS[{'bf16' if bf16 else 'f32'}]",
                f"declared {rows} query rows a block exceeds the "
                f"{der['MAX_ROWS'][bf16]} its instance takes"))
    budget = caps["smem_bytes"] if smem_bytes is None else smem_bytes
    for dt, hc, chunk, rows, nbytes in k3_instances(
            caps, pak.MAX_HEAD_DIM, pak.MAX_ROWS):
        if nbytes > budget:
            out.append(Finding(
                "kernels", "smem-over-budget", f"{where}/{dt}/{hc}",
                f"the {dt} instance for head_dim <= {hc} (CHUNK {chunk}) "
                f"needs {nbytes} B of shared memory at {rows} rows, over "
                f"the {budget} B a block may have"))
    if op.accepts is None:
        return out + [Finding("kernels", "bound-missing", where,
                              "caps declared but no `accepts` on the op")]
    import torch
    for dtype in (torch.bfloat16, torch.float32):
        ok, _ = op.accepts(8, der["MAX_HEAD_DIM"] + 1, None, dtype)
        if ok:
            out.append(Finding(
                "kernels", "bound-missing", f"{where}/MAX_HEAD_DIM",
                f"accepts admits head_dim {der['MAX_HEAD_DIM'] + 1} in "
                f"{dtype}, past every instance"))
    return out


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

def audit_op(op) -> List[Finding]:
    """Verify one KernelOp's declared limits against its caps' derivation.
    Ops without caps return no findings (nothing declared to check)."""
    caps = getattr(op, "caps", None)
    if not caps:
        return []
    where = f"{op.op}/{op.method}/{op.backend}"
    kind = caps.get("kind")
    if kind == "fft_rows":
        return _audit_fft(op, caps, where)
    if kind == "paged_attention":
        return _audit_k3(op, caps, where)
    return [Finding(
        "kernels", "unknown-caps", where,
        f"unrecognized caps kind {kind!r}: the verifier cannot check this "
        "declaration; teach kernel_audit.py the new kind")]


def audit_registry(ops=None) -> List[Finding]:
    """Audit every registered KernelOp (or an explicit iterable: tests pass
    seeded-regression ops directly)."""
    if ops is None:
        from repro_torch.kernels import api
        ops = api.all_ops()
    out: List[Finding] = []
    for op in ops:
        out += audit_op(op)
    return out


def reference_findings(ops=None) -> List[Finding]:
    """`limit-below-reference` for every FFT-structured op whose accepted
    widths stop short of the JAX package's (REFERENCE_LIMITS: max(d1, d2)
    there; d2 <= MAX_D2 and d1 <= MAX_D1 here)."""
    if ops is None:
        from repro_torch.kernels import api
        ops = api.all_ops()
    declared = declared_fft_limits()
    out: List[Finding] = []
    for op in ops:
        caps = getattr(op, "caps", None) or {}
        if caps.get("kind") != "fft_rows":
            continue
        ref = REFERENCE_LIMITS[_PHASE_METHOD[caps["phase"]]]
        for name in ("MAX_D2", "MAX_D1"):
            if declared[name] < ref:
                axis = name[-2:].lower()
                out.append(Finding(
                    "kernels", "limit-below-reference",
                    f"{op.op}/{op.method}/{op.backend}/{name}",
                    f"accepts {axis} <= {declared[name]}, below the JAX "
                    f"package's {ref}: sites with {axis} in "
                    f"({declared[name]}, {ref}] are refused on the card"))
    return out


def declared_constants_findings(csrc: Path = CSRC) -> List[Finding]:
    """`constant-drift`: the Python constants and the caps records against
    the C sources they describe."""
    from repro_torch.kernels import fft_plan
    from repro_torch.kernels import fourier_deltaw as fdk
    from repro_torch.kernels import paged_attention as pak
    c = csrc_constants(csrc)
    fft, k3 = c["fft"], c["k3"]
    pairs = [
        ("fft_plan.SMEM_BYTES", fft_plan.SMEM_BYTES, "SMEM_MAX",
         fft.get("SMEM_MAX")),
        ("fft_plan.MAX_D1", fft_plan.MAX_D1, "MAX_D1", fft.get("MAX_D1")),
        ("fft_plan.MAX_N", fft_plan.MAX_N, "MAX_N", fft.get("MAX_N")),
        ("fft_plan.MAX_STAGES", fft_plan.MAX_STAGES, "FFT_MAX_STAGES",
         fft.get("FFT_MAX_STAGES")),
        ("fourier_deltaw.NC", fdk.NC, "NC", fft.get("NC")),
        ("paged_attention.MAX_HEAD_DIM", pak.MAX_HEAD_DIM, "dh > N",
         k3.get("max_head_dim")),
        ("paged_attention.MAX_SPLITS", pak.MAX_SPLITS, "splits > N",
         k3.get("max_splits")),
    ]
    for phase, caps in (("linear", fft_plan.FOURIER_CAPS),
                        ("half", fft_plan.DCT_CAPS)):
        tag = f"fft_plan.{_PHASE_METHOD[phase].upper()}_CAPS"
        pairs += [
            (f"{tag}.smem_bytes", caps["smem_bytes"], "SMEM_MAX",
             fft.get("SMEM_MAX")),
            (f"{tag}.odd_radix_regs", caps["odd_radix_regs"],
             "FFT_MAX_ODD", fft.get("FFT_MAX_ODD")),
            (f"{tag}.max_stages", caps["max_stages"], "FFT_MAX_STAGES",
             fft.get("FFT_MAX_STAGES")),
            (f"{tag}.entry_chunk", caps["entry_chunk"], "NC", fft.get("NC")),
            (f"{tag}.scatter_static_bytes", caps["scatter_static_bytes"],
             "4 * SORT_THREADS", 4 * fft["SORT_THREADS"]
             if "SORT_THREADS" in fft else None),
        ]
    pc = pak.CAPS
    pairs += [
        ("paged_attention.CAPS.threads", pc["threads"], "THREADS",
         k3.get("THREADS")),
        ("paged_attention.CAPS.off_slots", pc["off_slots"], "OFF_SLOTS",
         k3.get("OFF_SLOTS")),
        ("paged_attention.CAPS.smem_bytes", pc["smem_bytes"],
         "cudaFuncSetAttribute", k3.get("attr")),
        ("paged_attention.CAPS.smem_bytes", pc["smem_bytes"], "smem > N",
         k3.get("smem_max")),
        ("paged_attention.CAPS.max_splits", pc["max_splits"], "splits > N",
         k3.get("max_splits")),
        ("paged_attention.CAPS.classes", pc["classes"], "dispatch",
         k3.get("classes")),
        ("paged_attention.CAPS.f32_max_rows", (pc["f32_max_rows"],),
         "run_f32<.., MAXR>", k3.get("f32_max_rows")),
    ]
    out: List[Finding] = []
    seen = set()
    for where, declared, c_name, c_val in pairs:
        if declared != c_val and (where, c_name) not in seen:
            seen.add((where, c_name))
            out.append(Finding(
                "kernels", "constant-drift", where,
                f"declared {declared!r} != the C side's {c_name} "
                f"{c_val!r} (csrc/)"))
    if fft_plan.MAX_N % fdk.NC:
        out.append(Finding(
            "kernels", "constant-drift", "fft_plan.MAX_N",
            f"MAX_N {fft_plan.MAX_N} is not a multiple of the entry chunk "
            f"{fdk.NC}: the padded n the C side checks can pass it"))
    return out


def run() -> List[Finding]:
    """The full kernel pass (no card needed): registry audit, reference
    gaps and the constants against the C sources."""
    return audit_registry() + reference_findings() \
        + declared_constants_findings()


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

def device_smem_optin(device) -> int:
    """The card's opt-in shared memory per block: the most a kernel may
    request through cudaFuncSetAttribute, as torch's device properties
    report it."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"device_smem_optin needs a CUDA device, got "
                         f"{device}")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return int(torch.cuda.get_device_properties(index)
               .shared_memory_per_block_optin)


def audit_device(device) -> List[Finding]:
    """`smem-over-budget` for every shared-memory request and every
    derivation the card's opt-in shared memory per block cannot hold.
    Runs on the card only."""
    from repro_torch.kernels import fft_plan
    from repro_torch.kernels import paged_attention as pak
    optin = device_smem_optin(device)
    c = csrc_constants()
    requests = {"fft_plan.SMEM_BYTES": fft_plan.SMEM_BYTES,
                "csrc/fft_rows.cuh:SMEM_MAX": c["fft"].get("SMEM_MAX"),
                "csrc/paged_attention.cu:cudaFuncSetAttribute":
                    c["k3"].get("attr"),
                "paged_attention.CAPS.smem_bytes": pak.CAPS["smem_bytes"]}
    out: List[Finding] = []
    for where, req in requests.items():
        if req is None or req > optin:
            out.append(Finding(
                "kernels", "smem-over-budget", f"device/{where}",
                f"requests {req} B of shared memory a block; the card "
                f"allows {optin}"))
    from repro_torch.kernels import api
    declared = declared_fft_limits()
    for op in api.all_ops():
        caps = getattr(op, "caps", None) or {}
        where = f"device/{op.op}/{op.method}/{op.backend}"
        if caps.get("kind") == "fft_rows":
            lim = derived_fft_limits(caps, smem_bytes=optin)
            for name in ("MAX_D2", "MAX_N"):
                if declared[name] > lim[name]:
                    out.append(Finding(
                        "kernels", "smem-over-budget", f"{where}/{name}",
                        f"fft_plan.{name} {declared[name]} exceeds "
                        f"{lim[name]} at the card's {optin} B a block"))
        elif caps.get("kind") == "paged_attention":
            out += [Finding(f.section, f.rule, "device/" + f.where,
                            f.message)
                    for f in _audit_k3(op, caps, where[len("device/"):],
                                       smem_bytes=optin)
                    if f.rule == "smem-over-budget"]
    return out
