"""Static hot-path analyzer of the port (the JAX package's `analysis`).

Four passes over the tree and its hot paths, one baseline-gated CLI
(`python -m repro_torch.analysis`):

- `ast_lint`       — source lint for torch hazards (host syncs, in loops
                     too; truthiness of device values under capture or
                     autograd; draws from the global RNG stream)
- `kernel_audit`   — KernelOp capability verifier: the Hopper kernels'
                     declared limits re-derived from what their C side
                     assumes (phase-product widths, shared memory, the
                     scatter plan, register arrays, K3's instances), and
                     on the card against its shared memory
- `dispatch_lint`  — what the dispatcher runs on the train step and the
                     decode loop built by `graphs` (host transfers per
                     step, f32-literal upcasts, out-of-place updates,
                     the scheduler's signature budgets)
- `sharding_audit` — every leaf of every registered arch's params, and of
                     the serving caches, batches and bank rows, must
                     resolve through a named decision of the resolved
                     sharding plan (`dist/plan.PlanSource.decision`)

Findings diff against the committed `baseline.json`; only NEW findings
fail the gate (report.gate).
"""
from repro_torch.analysis.report import (        # noqa: F401
    DEFAULT_BASELINE, Finding, diff, gate, load_baseline, render,
    save_baseline, to_json,
)
