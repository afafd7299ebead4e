"""Checkpointing: async, atomic, keep-k (the JAX package's
`checkpoint/manager.py`, same on-disk layout, so a train state crosses
between the packages).

On a mesh every leaf is stored as its full logical value: a DTensor is
gathered (`full_tensor`, a collective every rank joins) and rank 0 alone
writes the same files as a one-device run. `restore(..., placements=...,
mesh=...)` distributes the leaves onto any mesh — another rank count or
layout than the saver's (the elastic re-shard).

Layout:  <dir>/step_<N>/
             manifest.json   — tree skeleton + leaf metadata
             <leaf_id>.npy   — one file per tensor leaf
         <dir>/step_<N>.tmp-* during write; atomic os.replace on publish.

numpy has no bfloat16 or float8: such leaves are stored as a same-width
unsigned view and the manifest's `ext_dtypes` records the logical dtype,
exactly as the JAX package does with ml_dtypes. `restore` puts every leaf
on the device it is asked for.

Async: a worker thread drains a queue of (step, host arrays) snapshots; the
copy to the host happens on the caller's thread (a consistent snapshot),
file I/O off the critical path. `close()` flushes the queue.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

# logical dtype name -> (numpy storage dtype, torch storage dtype, dtype)
_EXT_DTYPES = {
    "bfloat16": (np.uint16, torch.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.uint8, torch.float8_e5m2),
}
_EXT_BY_TORCH = {v[2]: k for k, v in _EXT_DTYPES.items()}


def _encode(t: torch.Tensor):
    """-> (numpy array owning a host copy, ext dtype name or None)."""
    from repro_torch.dist.dtensor import to_plain
    # repro: allow(host-sync) — a checkpoint save writes host bytes
    t = to_plain(t.detach()).to("cpu", copy=True)
    name = _EXT_BY_TORCH.get(t.dtype)
    if name:
        return t.view(_EXT_DTYPES[name][1]).numpy(), name
    return t.numpy(), None


def _decode(arr: np.ndarray, name: Optional[str], device) -> torch.Tensor:
    if name:
        store, _, dtype = _EXT_DTYPES[name]
        arr = np.ascontiguousarray(arr).view(store)
        return torch.from_numpy(arr.copy()).view(dtype).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _flatten(tree, prefix=""):
    """-> (json-able skeleton, list[(path, leaf)]) of a nested dict."""
    if isinstance(tree, dict):
        skel, leaves = {}, []
        for k in sorted(tree):
            s, l = _flatten(tree[k], f"{prefix}{k}/")
            skel[k] = s
            leaves.extend(l)
        return skel, leaves
    path = prefix[:-1]
    return {"__leaf__": path}, [(path, tree)]


def _unflatten(skel, leaves: Dict[str, Any]):
    # lists and tuples occur in checkpoints the JAX package wrote
    if isinstance(skel, dict):
        if "__leaf__" in skel:
            return leaves[skel["__leaf__"]]
        if "__tuple__" in skel:
            return tuple(_unflatten(s, leaves) for s in skel["__tuple__"])
        return {k: _unflatten(v, leaves) for k, v in skel.items()}
    if isinstance(skel, list):
        return [_unflatten(s, leaves) for s in skel]
    raise TypeError(skel)


def _leaf_file(path: str) -> str:
    return path.replace("/", "__") + ".npy"


def _snapshot(tree):
    skel, leaves = _flatten(tree)
    return skel, [(p, *_encode(v)) for p, v in leaves]


def _is_writer() -> bool:
    """Rank 0 of the process group writes; every rank without one."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def save_sync(directory: str, step: int, tree) -> Optional[str]:
    """Blocking save with atomic publish. Returns the final path (None on
    a rank that does not write)."""
    skel, host = _snapshot(tree)
    if not _is_writer():
        return None
    return _write(directory, step, skel, host)


def _write(directory: str, step: int, skel, host_leaves) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp-", dir=directory)
    try:
        dtypes = {}
        for p, arr, name in host_leaves:
            if name:
                dtypes[p] = name
            np.save(os.path.join(tmp, _leaf_file(p)), arr)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "skeleton": skel,
                       "leaves": [p for p, _, _ in host_leaves],
                       "ext_dtypes": dtypes}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def available_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and ".tmp-" not in name:
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                out.append(int(name[5:]))
    return sorted(out)


def restore(directory: str, step: Optional[int] = None, *, device="cpu",
            placements=None, mesh=None):
    """Load a checkpoint (the newest when `step` is None) onto `device`.
    With `placements` (a tree of DTensor placements, `sharding.named`)
    and `mesh`, every leaf is distributed onto the mesh instead. Returns
    (tree, step)."""
    steps = available_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    step = steps[-1] if step is None else step
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    ext = manifest.get("ext_dtypes", {})
    leaves = {p: _decode(np.load(os.path.join(path, _leaf_file(p))),
                         ext.get(p), device)
              for p in manifest["leaves"]}
    tree = _unflatten(manifest["skeleton"], leaves)
    if placements is not None:
        from repro_torch.dist import sharding as shd
        tree = shd.distribute(tree, placements, mesh)
    return tree, step


class CheckpointManager:
    """Async keep-k manager with atomic publishes."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: queue.Queue = queue.Queue()
        self._err: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                step, skel, host_leaves = item
                _write(self.directory, step, skel, host_leaves)
                self._prune()
            except Exception as e:  # surfaced on next save/close
                self._err = e

    def _prune(self):
        steps = available_steps(self.directory)
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def save(self, step: int, tree):
        if self._err:
            raise self._err
        snap = _snapshot(tree)      # every rank gathers its DTensors
        if _is_writer():
            self._q.put((step, *snap))

    def close(self):
        self._q.put(None)
        self._worker.join(timeout=120)
        if self._err:
            raise self._err
