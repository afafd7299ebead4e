"""Carry the JAX package's params across to the port.

`from_jax_params(tree, device)` takes a params tree as `jax.device_get`
hands it back (nested dicts of numpy arrays) and returns the port's tree
with the same key paths. JAX's bf16 arrays arrive as `ml_dtypes.bfloat16`,
which `torch.from_numpy` rejects; their bytes are reinterpreted as uint16
and viewed as `torch.bfloat16` (exact). The dtype is detected by name, so
this module needs no `ml_dtypes` import. Integer leaves (FourierFT
`entries`) and f32 leaves (`c`, the random/orthogonal bases `b1`/`b2`)
carry over as they are, and so does a `full` run's base, every leaf of
which trains. The other families' leaves need nothing of their own: the
(L, E, d, f) experts and the codebook model's (CB, V, d) embedding and
(CB, d, V) head keep their shapes, a vlm tree has no `embed`, and the
hybrid's `shared` block is one more subtree. The leaves JAX keeps in f32
whatever `param_dtype` is (`F32_LEAVES`: the MoE `router`, the mamba
blocks' `dt_bias`, `A_log` and `Dp`) stay f32 even when `dtype=` casts
the rest.

The same walk carries the serving adapter bank's state: a tenant tree
`{site: {leaf: array}}` of any method (`c`, `lora_a`/`lora_b`, `kernel`,
`delta_b`; `from_jax_tenant` checks its shape) and the bank's rows
`{method: {"sites": {site: {leaf: (K+1, L, ...)}}, "aux": ...}}`.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def array_to_torch(a, device, dtype: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        if a.dtype.itemsize != 2:
            raise ValueError(f"unexpected bfloat16 itemsize {a.dtype.itemsize}")
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


# leaves the JAX package makes in f32 whatever param_dtype is
F32_LEAVES = ("router", "dt_bias", "A_log", "Dp")


def from_jax_params(tree: Dict, device, dtype: Optional[torch.dtype] = None
                    ) -> Dict:
    """Nested dict of arrays -> nested dict of torch tensors on `device`.
    `dtype`, when given, casts the floating leaves (integer leaves keep
    theirs, and `F32_LEAVES` stay f32)."""
    if isinstance(tree, dict):
        return {k: (array_to_torch(v, device) if k in F32_LEAVES
                    and not isinstance(v, dict)
                    else from_jax_params(v, device, dtype))
                for k, v in tree.items()}
    return array_to_torch(tree, device, dtype)


def from_jax_tenant(tree: Dict, device, dtype: Optional[torch.dtype] = None
                    ) -> Dict:
    """A tenant's adapter tree {site: {leaf: array}} (JAX's
    `init_adapters` or `import_adapter` output, through `jax.device_get`)
    -> the same tree of torch tensors on `device`, ready for
    `AdapterBank.load`. Raises on any other nesting."""
    for site, leaves in tree.items():
        if not isinstance(leaves, dict) or any(
                isinstance(v, dict) for v in leaves.values()):
            raise ValueError(f"tenant site {site!r} is not a "
                             "{leaf: array} dict")
    return from_jax_params(tree, device, dtype)
