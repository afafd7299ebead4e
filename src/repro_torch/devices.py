"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device an entry point runs on: the caller's, else `cuda`.

    With no argument and no CUDA device this raises — the port never carries
    on on the CPU unless the caller asked for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the plain PyTorch versions on the CPU")
    return torch.device("cuda")


def to_device(data, device: Union[str, torch.device],
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Host data (a numpy array, a list, a CPU tensor) as a tensor on
    `device`. To a CUDA device the copy is queued from a pinned staging
    copy without making the host wait (PyTorch's caching host allocator
    keeps the staging block until the copy has landed), as the JAX
    package's transfers of host arrays are queued."""
    device = torch.device(device)
    t = torch.as_tensor(data, dtype=dtype)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def tree_to(tree, device: torch.device):
    """Move every tensor leaf of a nested dict to `device` (no copy when it
    is already there)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)
