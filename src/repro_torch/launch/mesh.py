"""Mesh construction — the one shared path for every launcher, the sharded
train step, the engine and the tests (the JAX package's
`launch/mesh.py`).

JAX drives every device from one process; PyTorch runs one process per
device (`torchrun`, or ranks spawned by a test). A mesh here is therefore
a `torch.distributed.device_mesh.DeviceMesh` over the ranks of the
initialized process group, with `repro`'s axis names (`pod`, `data`,
`model`) as its dimension names. Every rank builds the same mesh.

With no process group (a plain `python -m ...` run, an in-process test)
the mesh is the one device: `make_host_mesh` returns the abstract
`MeshSpec` of a 1x1 mesh, and placing a tree on it is the identity (plain
tensors, no DTensor) — the counterpart of JAX's "a 1x1 host mesh
degenerates to the single-device behavior".

`abstract_mesh` (axis names and sizes only, no devices) is what the
planner and the sharding audit use to plan the production 16x16 and
2x16x16 cells anywhere.
"""
from __future__ import annotations

import os
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.dist.cost_model import MeshSpec


def world_size() -> int:
    """Ranks in the initialized process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def init_from_env(device: torch.device) -> bool:
    """Join the process group `torchrun` describes in the environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), once: NCCL for a CUDA
    device (each rank on the card LOCAL_RANK names), gloo for the CPU.
    Returns whether a process group is initialized afterwards; without
    torchrun's environment it starts none."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return True


def mesh_device_type() -> str:
    """The device type of the group's ranks: cuda under NCCL, else cpu."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A DeviceMesh of `shape` named `axes` over the process group's
    ranks (their product must be the world size)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {shape} needs a process group (run under torchrun); "
            "abstract_mesh plans a mesh without one")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(mesh_device_type(), shape, mesh_dim_names=axes)


def abstract_mesh(shape: Sequence[int], axes: Sequence[str]) -> MeshSpec:
    """Axis names and sizes only: rules and planning evaluate against it,
    nothing can be placed on it."""
    return MeshSpec(dict(zip(tuple(axes), tuple(int(s) for s in shape))))


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The production cell's mesh, abstract (planning on any machine):
    (data 16, model 16), or (pod 2, data 16, model 16)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return abstract_mesh(shape, axes)


def parse_mesh_shape(spec: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """'4x2' -> ((4, 2), ('data', 'model')); a 3-dim spec adds 'pod'."""
    dims = tuple(int(x) for x in spec.split("x"))
    if not 1 <= len(dims) <= 3:
        raise ValueError(f"mesh spec {spec!r}: want 1-3 'x'-separated dims")
    axes = ("pod", "data", "model")[-len(dims):]
    return dims, axes


def make_host_mesh(model: int = 1):
    """(data, model) mesh over the process group's ranks, data = world /
    model. With no process group: the abstract 1x1 mesh of the one device
    (placement on it is the identity)."""
    n = world_size()
    if n % model:
        raise ValueError(f"model parallelism {model} does not divide "
                         f"device count {n}")
    if not dist.is_initialized():
        return abstract_mesh((1, 1), ("data", "model"))
    return make_mesh((n // model, model), ("data", "model"))


def mesh_size(mesh) -> int:
    """Devices in a DeviceMesh or an abstract mesh."""
    return MeshSpec.from_mesh(mesh).size


def describe(mesh) -> str:
    """'2x2' (data x model), the JAX launchers' mesh print."""
    from repro_torch.dist.sharding import mesh_axes
    return "x".join(str(s) for s in mesh_axes(mesh).values())


def rank0_print(*args, **kwargs) -> None:
    """print on rank 0 (every rank runs the same launcher)."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(*args, **kwargs, flush=True)


def shutdown() -> None:
    """Leave the process group, if the launcher joined one."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def spawn_cpu_ranks(fn, world: int, workdir: str, *args) -> None:
    """Run `fn(rank, world, *args)` in `world` CPU processes joined in a
    gloo group through a FileStore under `workdir` (no port to collide on:
    tests run side by side). Raises if any rank fails."""
    import torch.multiprocessing as mp
    store = os.path.join(workdir, f"store-{world}-{os.getpid()}")
    mp.spawn(_rank_main, args=(world, store, fn, args), nprocs=world,
             join=True)


def _rank_main(rank: int, world: int, store: str, fn, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
