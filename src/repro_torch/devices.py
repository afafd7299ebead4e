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


def tree_to(tree, device: torch.device):
    """Move every tensor leaf of a nested dict to `device` (no copy when it
    is already there)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)
