"""Alpha-beta cluster cost model over the (pod, data, model) mesh (the JAX
package's `dist/cost_model.py`, with the H100's constants).

The planner (`dist/planner.py`) compares candidate placements WITHOUT
running anything, so this module prices the primitives a placement implies
— collectives per kind and axis, HBM traffic, resharding between layouts —
from a handful of per-axis link constants, alpa-style:

    cost(collective over axes A, n bytes)
        = alpha(A) + chunk_factor(kind, |A|) * n / beta(A)

where `alpha` is the per-launch latency (summed over the axes the replica
group spans — a (pod, data) group pays the cross-node hop), `beta` the
bandwidth of the SLOWEST link in the group, and `chunk_factor` the
textbook ring terms: 2(n-1)/n for all-reduce, (n-1)/n for all-gather /
reduce-scatter / all-to-all, 1 for collective-permute.

Constants (per device): the bf16 dense tensor-core peak and the HBM rate
are the NVIDIA H100 SXM data sheet's (989 TF/s, 3.35 TB/s, the numbers
`chip_smoke.py` bounds its kernels with); HBM capacity is read from the
card (`device_hbm_bytes`), else the data sheet's 80 GB. Links: `data` and
`model` are NVLink 4 inside a node (data sheet: 900 GB/s per GPU both ways,
450 GB/s each way), `pod` crosses nodes over InfiniBand NDR (data sheet:
400 Gb/s = 50 GB/s per GPU). One card cannot measure any link, so these
stay data-sheet values; the per-launch latencies (`alpha`) are assumed
orders of magnitude, not measurements. Tests that hold the planner to the
JAX package's decisions hand both packages one set of constants
explicitly (`ClusterEnv(mesh, links=..., hbm_bw=..., hbm_bytes=...,
peak_flops=...)`).

`MeshSpec` is an abstract mesh — axis names and sizes only, no devices — so
planning and scoring run anywhere (the 256-device production cells plan on
a laptop). It duck-types the two attributes the JAX package's rule engine
reads (`axis_names`, `devices.shape`), and `dist/sharding.py` reads a
DeviceMesh and a MeshSpec alike; placing a tree (`sharding.place`) needs a
real DeviceMesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np

# NVIDIA H100 SXM data-sheet constants, per device
PEAK_FLOPS = 989e12        # dense bf16 tensor-core rate, FLOP/s
HBM_BW = 3.35e12           # bytes/s
H100_HBM_BYTES = 80e9      # capacity when no card is there to ask
NVLINK_BW = 450e9          # NVLink 4, bytes/s each way per GPU
IB_BW = 50e9               # InfiniBand NDR 400 Gb/s per GPU, bytes/s
# assumed per-collective launch latencies (not data-sheet values)
NVLINK_ALPHA_S = 5e-6
IB_ALPHA_S = 2e-5


def device_hbm_bytes(device=None) -> float:
    """The card's memory (`total_memory` of `device`, default the current
    CUDA device); the H100 data sheet's 80 GB when there is no card."""
    import torch
    if not torch.cuda.is_available():
        return H100_HBM_BYTES
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        return H100_HBM_BYTES
    return float(torch.cuda.get_device_properties(dev).total_memory)


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One mesh axis's interconnect: per-collective launch latency and
    per-device link bandwidth."""
    alpha_s: float
    beta_bytes_s: float


DEFAULT_LINKS: Dict[str, LinkSpec] = {
    "pod": LinkSpec(alpha_s=IB_ALPHA_S, beta_bytes_s=IB_BW),
    "data": LinkSpec(alpha_s=NVLINK_ALPHA_S, beta_bytes_s=NVLINK_BW),
    "model": LinkSpec(alpha_s=NVLINK_ALPHA_S, beta_bytes_s=NVLINK_BW),
}

# chunk factors for ring algorithms, as a function of group size n
_CHUNK = {
    "all-reduce": lambda n: 2.0 * (n - 1) / n,
    "all-gather": lambda n: (n - 1) / n,
    "reduce-scatter": lambda n: (n - 1) / n,
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}


class _AbstractDevices:
    """Shape/size stand-in for `Mesh.devices` (never holds devices)."""

    __slots__ = ("shape", "size")

    def __init__(self, shape: Tuple[int, ...]):
        self.shape = tuple(int(s) for s in shape)
        self.size = int(np.prod(self.shape)) if self.shape else 1


class MeshSpec:
    """Abstract mesh: ordered {axis name: size}. Duck-types the subset of
    `jax.sharding.Mesh` that `dist/sharding.py` reads (`axis_names`,
    `devices.shape`/`.size`), so rule evaluation and planning never need
    real devices."""

    def __init__(self, axes: Dict[str, int]):
        self.axes = {str(k): int(v) for k, v in axes.items()}
        self.axis_names = tuple(self.axes)
        self.devices = _AbstractDevices(tuple(self.axes.values()))

    @classmethod
    def from_mesh(cls, mesh) -> "MeshSpec":
        """From a DeviceMesh (its dimension names and sizes) or another
        MeshSpec (idempotent)."""
        if isinstance(mesh, MeshSpec):
            return mesh
        if hasattr(mesh, "mesh_dim_names"):
            return cls(dict(zip(mesh.mesh_dim_names, mesh.shape)))
        return cls(dict(zip(mesh.axis_names, mesh.devices.shape)))

    @classmethod
    def from_string(cls, spec: str) -> "MeshSpec":
        """'16x16' -> (data 16, model 16); a 3-dim spec adds 'pod' — the
        same convention as launch/mesh.parse_mesh_shape."""
        dims = tuple(int(x) for x in spec.split("x"))
        if not 1 <= len(dims) <= 3:
            raise ValueError(f"mesh spec {spec!r}: want 1-3 dims")
        names = ("pod", "data", "model")[-len(dims):]
        return cls(dict(zip(names, dims)))

    def axis_size(self, axis: str) -> int:
        return self.axes.get(axis, 1)

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self) -> str:
        return f"MeshSpec({self.axes})"


def _axes_of(spec_entry) -> Tuple[str, ...]:
    """Axis names of one PartitionSpec dim entry (None | str | tuple)."""
    if spec_entry is None:
        return ()
    if isinstance(spec_entry, str):
        return (spec_entry,)
    return tuple(spec_entry)


def spec_axes(spec) -> Tuple[str, ...]:
    """All mesh axes a PartitionSpec shards over, in appearance order."""
    out = []
    for entry in tuple(spec):
        out.extend(_axes_of(entry))
    return tuple(out)


def shard_factor(spec, mesh: MeshSpec) -> int:
    """Product of mesh-axis sizes a spec shards over — how many ways the
    array is split (per-device bytes = total bytes / shard_factor)."""
    f = 1
    for a in spec_axes(spec):
        f *= mesh.axis_size(a)
    return f


class ClusterEnv:
    """Prices collectives, HBM traffic, and layout transitions on one
    abstract mesh. All costs are SECONDS PER PARTICIPATING DEVICE; byte
    arguments are the FULL logical payload unless noted."""

    def __init__(self, mesh: Union[MeshSpec, object],
                 links: Optional[Dict[str, LinkSpec]] = None,
                 hbm_bw: float = HBM_BW, hbm_bytes: Optional[float] = None,
                 peak_flops: float = PEAK_FLOPS):
        self.mesh = MeshSpec.from_mesh(mesh)
        self.links = dict(DEFAULT_LINKS)
        if links:
            self.links.update(links)
        self.hbm_bw = hbm_bw
        self.hbm_bytes = (device_hbm_bytes() if hbm_bytes is None
                          else hbm_bytes)
        self.peak_flops = peak_flops

    # ---- link aggregation --------------------------------------------------
    def group_size(self, axes: Iterable[str]) -> int:
        n = 1
        for a in axes:
            n *= self.mesh.axis_size(a)
        return n

    def _link(self, axes: Sequence[str]) -> LinkSpec:
        """Effective link for a replica group spanning `axes`: latencies sum
        (every hop is paid) and the slowest link bounds bandwidth."""
        axes = [a for a in axes if self.mesh.axis_size(a) > 1]
        if not axes:
            return LinkSpec(0.0, math.inf)
        specs = [self.links.get(a, DEFAULT_LINKS["data"]) for a in axes]
        return LinkSpec(sum(s.alpha_s for s in specs),
                        min(s.beta_bytes_s for s in specs))

    def collective_cost(self, kind: str, nbytes: float,
                        axes: Sequence[str]) -> float:
        """Seconds for one `kind` collective of `nbytes` (full payload per
        participating device) over the mesh axes `axes`. Groups of size 1
        are free — the collective compiles away."""
        n = self.group_size(axes)
        if n <= 1 or nbytes <= 0:
            return 0.0
        link = self._link(axes)
        chunk = _CHUNK.get(kind, _CHUNK["all-gather"])(n)
        return link.alpha_s + chunk * nbytes / link.beta_bytes_s

    def all_reduce_cost(self, nbytes: float, axes: Sequence[str]) -> float:
        return self.collective_cost("all-reduce", nbytes, axes)

    def all_gather_cost(self, nbytes: float, axes: Sequence[str]) -> float:
        """`nbytes` is the FULL gathered size (each device contributes
        nbytes/n and receives the rest)."""
        return self.collective_cost("all-gather", nbytes, axes)

    def reduce_scatter_cost(self, nbytes: float, axes: Sequence[str]) -> float:
        return self.collective_cost("reduce-scatter", nbytes, axes)

    def all_to_all_cost(self, nbytes: float, axes: Sequence[str]) -> float:
        """`nbytes` is the per-device buffer being exchanged."""
        return self.collective_cost("all-to-all", nbytes, axes)

    def collective_permute_cost(self, nbytes: float,
                                axes: Sequence[str]) -> float:
        return self.collective_cost("collective-permute", nbytes, axes)

    # ---- resharding ---------------------------------------------------------
    def resharding_cost(self, nbytes: float, src, dst) -> float:
        """Seconds to move an `nbytes` (full logical size) array from layout
        `src` to layout `dst` (PartitionSpecs). The usual alpa cases:

        - identical layouts: free;
        - sharded -> replicated on some axes: all-gather of the full bytes
          over the lost axes;
        - replicated -> sharded: free (a local slice);
        - same axes, different dims (e.g. column->row): all-to-all of the
          per-device shard over the moved axes.
        """
        src_t, dst_t = tuple(src), tuple(dst)
        if src_t == dst_t:
            return 0.0
        src_by_axis = {a: i for i, e in enumerate(src_t)
                       for a in _axes_of(e)}
        dst_by_axis = {a: i for i, e in enumerate(dst_t)
                       for a in _axes_of(e)}
        lost = [a for a in src_by_axis if a not in dst_by_axis]
        moved = [a for a in src_by_axis
                 if a in dst_by_axis and src_by_axis[a] != dst_by_axis[a]]
        cost = 0.0
        if lost:
            cost += self.all_gather_cost(nbytes, lost)
        if moved:
            per_dev = nbytes / max(self.group_size(src_by_axis), 1)
            cost += self.all_to_all_cost(per_dev, moved)
        return cost

    # ---- roofline terms -----------------------------------------------------
    def compute_s(self, flops_per_device: float) -> float:
        return flops_per_device / self.peak_flops

    def memory_s(self, bytes_per_device: float) -> float:
        return bytes_per_device / self.hbm_bw


@dataclasses.dataclass
class PlanCost:
    """End-to-end predicted cost of one placement for one workload step.
    Comparable across candidate plans of the same cell; `total_s` is the
    roofline max plus the collective term (collectives overlap poorly with
    compute on the hot paths we care about)."""
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    resident_bytes: float = 0.0        # per-device HBM residency
    collective_bytes: float = 0.0      # per-device, per step
    by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def total_s(self) -> float:
        return max(self.compute_s, self.memory_s) + self.collective_s

    def add_collective(self, kind: str, seconds: float, nbytes: float) -> None:
        self.collective_s += seconds
        self.collective_bytes += nbytes
        if nbytes:
            self.by_kind[kind] = self.by_kind.get(kind, 0.0) + nbytes

    def to_json(self) -> Dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "total_s": self.total_s,
            "resident_bytes": self.resident_bytes,
            "collective_bytes": self.collective_bytes,
            "collective_bytes_by_kind": dict(self.by_kind),
        }


def default_env(mesh) -> ClusterEnv:
    """The default: the H100's data-sheet rates, the card's capacity,
    NVLink inside a node and InfiniBand across nodes."""
    return ClusterEnv(mesh)
