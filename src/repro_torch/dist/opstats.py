"""Per-device op statistics of one traced step (the counterpart of the JAX
package's `dist/hlo.py`).

There is no compiled HLO to parse in eager PyTorch: `OpStats` is a
`TorchDispatchMode` that watches what one rank dispatches while a step
runs and reports what `hlo.py`'s `ModuleStats` reports for a compiled
module:

- `flops` — every op `torch.utils.flop_counter` prices, with its formulas
  (2·m·n·k for a matmul; the attention and convolution rules);
  `dot_flops` the matmuls' share;
- `bytes` — every op but a view reads its tensor inputs and writes its
  outputs once (the unfused upper bound); `bytes_min` counts only the
  materializing ops (matmuls, copies, gathers and scatters, index writes,
  collectives), the fused lower bound;
- `bytes_by_kind` / `count_by_kind` / `group_by_kind` — collectives by
  kind: all-reduce, all-gather, reduce-scatter, all-to-all and
  collective-permute (point-to-point send/recv) each in their own bucket,
  as in `hlo.py`; a collective's bytes are its output's, and its group
  is the process group it ran over;
- `kernel_counts` — calls of the hand-written kernels' custom ops
  (`kernels.custom_ops`, `repro_torch::*`): each is one op, priced by
  `custom_ops.COSTS` (the operations and bytes chip_smoke's bounds count),
  its operations into `flops` (not `dot_flops`: K1/K2/K4/K5 are
  transforms) and its bytes into both byte counts.

The mode sees what DTensor runs on the local shards: it declines ops whose
arguments are DTensors (`NotImplemented`), so DTensor's dispatch handles
them and the local ops and `_c10d_functional` collectives it issues come
back through the mode. Ops on meta tensors (sharding propagation) are not
counted. Everything is per device: the rank that records.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import custom_ops

# collective op name -> hlo.py's kind
_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast": "collective-broadcast", "broadcast_": "collective-broadcast",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d")
_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "matmul", "_scaled_mm"}
_MATERIALIZE = _MATMULS | {
    "convolution", "_convolution", "copy_", "_to_copy", "clone",
    "index_select", "gather", "scatter", "scatter_add", "index_put_",
    "index_put", "index_copy_", "index_add_", "embedding", "cat",
    "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_cudnn_attention",
}


@dataclasses.dataclass
class ModuleStats:
    flops: float = 0.0
    dot_flops: float = 0.0
    bytes: float = 0.0
    bytes_min: float = 0.0
    collective_bytes: float = 0.0
    bytes_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    count_by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)
    group_by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    # collective bytes by the size of the group they ran over (the dry run
    # prices each over its mesh axis's link)
    bytes_by_group: Dict[int, float] = dataclasses.field(
        default_factory=dict)

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _group_size(func, args, kwargs) -> Optional[int]:
    """The size of the process group a collective ran over (its
    `group_name` argument, or an explicit group_size)."""
    for v in list(args) + list(kwargs.values()):
        if isinstance(v, str):
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            try:
                return int(_resolve_process_group(v).size())
            except (KeyError, ValueError, RuntimeError):
                continue        # a string argument that names no group
    name = func.overloadpacket.__name__
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor") \
            and len(args) >= 2 and isinstance(args[1], int):
        return int(args[1])
    return None


class OpStats(TorchDispatchMode):
    """`with OpStats() as rec: step(...)`, then `rec.stats` (a
    ModuleStats) for what this rank dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.stats = ModuleStats()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs it; we see its locals
        out = func(*args, **kwargs)
        if any(t.device.type == "meta"
               for t in _tensors((args, kwargs, out))):
            return out
        self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out) -> None:
        st = self.stats
        packet = func.overloadpacket
        name = packet.__name__
        if func.namespace == custom_ops.NAMESPACE:
            ops, moved = custom_ops.COSTS[name](args, out)
            st.flops += ops
            st.bytes += moved
            st.bytes_min += moved
            st.kernel_counts[name] = st.kernel_counts.get(name, 0) + 1
            return
        kind = _COLLECTIVE_KIND.get(name)
        if kind is not None and func.namespace in _COLLECTIVE_NAMESPACES:
            n = _nbytes(args[0]) if name == "send" else _nbytes(out)
            st.collective_bytes += n
            st.bytes_by_kind[kind] = st.bytes_by_kind.get(kind, 0.0) + n
            st.count_by_kind[kind] = st.count_by_kind.get(kind, 0) + 1
            g = _group_size(func, args, kwargs)
            if kind == "collective-permute":
                g = 2
            if g is not None:
                st.group_by_kind[kind] = max(st.group_by_kind.get(kind, 0), g)
                st.bytes_by_group[g] = st.bytes_by_group.get(g, 0.0) + n
            st.bytes += n
            st.bytes_min += n
            return
        if func.is_view or name in ("wait_tensor", "_wrap_tensor_autograd",
                                    "empty", "empty_strided", "zeros_like",
                                    "empty_like", "detach", "lift_fresh"):
            return
        flop_fn = self._flops.get(packet)
        if flop_fn is not None:
            f = float(flop_fn(*args, **kwargs, out_val=out))
            st.flops += f
            if name in _MATMULS:
                st.dot_flops += f
        moved = _nbytes((args, kwargs)) + _nbytes(out)
        st.bytes += moved
        if name in _MATERIALIZE:
            st.bytes_min += moved
