"""Portable adapter-only checkpoints (the JAX package's
`checkpoint/adapters.py`, same format, so an adapter crosses between the
packages in either direction).

One tenant = one `<dir>/<adapter_id>/` holding exactly the trainable leaves
(`adapter.npz`, keys "<site>::<leaf>") plus a JSON manifest carrying the
PEFTConfig. Frozen state (FourierFT spectral entries) is not stored: it is
keyed by method + entry seed and regenerates deterministically at import
through the method's `init_site`, so a FourierFT tenant is n·(2+L) numbers
on the wire (paper §3.2). Export is atomic (tmp + os.replace).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import tempfile
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import PEFTConfig
from repro_torch.core import adapter as adapter_api
from repro_torch.core.adapter import AdapterSite

_MANIFEST = "manifest.json"
_LEAVES = "adapter.npz"
_SEP = "::"          # site names contain "/", npz keys are "<site>::<leaf>"

# ids become directory names: one path component, no traversal, and no
# ".tmp-" (reserved for in-flight exports, filtered by list_adapters)
_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


def _check_id(adapter_id: str) -> str:
    if not _ID_RE.match(adapter_id) or ".tmp-" in adapter_id:
        raise ValueError(
            f"bad adapter_id {adapter_id!r}: must match {_ID_RE.pattern} "
            "and not contain '.tmp-'")
    return adapter_id


def export_adapter(directory: str, adapter_id: str, adapters: Dict,
                   peft: PEFTConfig) -> str:
    """Write `<directory>/<adapter_id>/` from a {site: {leaf: tensor}} tree.
    Only the method's trainable leaves are stored."""
    _check_id(adapter_id)
    trainable = set(adapter_api.resolve(peft.method).trainable_leaves(peft))
    arrays = {f"{site}{_SEP}{leaf}": v.detach().cpu().numpy()
              for site, tree in adapters.items()
              for leaf, v in tree.items() if leaf in trainable}
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, adapter_id)
    tmp = tempfile.mkdtemp(prefix=f"{adapter_id}.tmp-", dir=directory)
    try:
        np.savez(os.path.join(tmp, _LEAVES), **arrays)
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump({"adapter_id": adapter_id, "format": 1,
                       "peft": dataclasses.asdict(peft)}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _peft_from_manifest(d: Dict) -> PEFTConfig:
    d = dict(d)
    d["target_modules"] = tuple(d.get("target_modules", ("wq", "wv")))
    # manifests written before the kernel registry carry the legacy
    # `use_pallas` tri-state: migrate it onto kernel_backend silently
    legacy = d.pop("use_pallas", None)
    if legacy is not None and "kernel_backend" not in d:
        mapped = {"auto": "auto", "never": "einsum",
                  "interpret": "interpret"}.get(legacy)
        if mapped is None:
            raise ValueError(
                f"adapter manifest carries unknown legacy use_pallas="
                f"{legacy!r}; expected one of ('auto', 'never', 'interpret')")
        d["kernel_backend"] = mapped
    return PEFTConfig(**d)


def read_manifest(directory: str, adapter_id: str) -> PEFTConfig:
    """PEFTConfig of an export without touching its arrays."""
    path = os.path.join(directory, _check_id(adapter_id), _MANIFEST)
    with open(path) as f:
        return _peft_from_manifest(json.load(f)["peft"])


def import_adapter(directory: str, adapter_id: str,
                   sites: Optional[Sequence[AdapterSite]] = None,
                   device="cpu") -> Tuple[Dict, PEFTConfig]:
    """-> ({site: {leaf: tensor on device}}, PEFTConfig). With `sites`, the
    frozen leaves (entries) are regenerated per site so the tree is usable
    as params["peft"] directly; without, only the stored trainables."""
    path = os.path.join(directory, _check_id(adapter_id))
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    peft = _peft_from_manifest(manifest["peft"])
    method = adapter_api.resolve(peft.method)
    out: Dict[str, Dict] = {}
    with np.load(os.path.join(path, _LEAVES)) as z:
        for key in z.files:
            site, leaf = key.rsplit(_SEP, 1)
            out.setdefault(site, {})[leaf] = torch.from_numpy(
                np.array(z[key])).to(device)
    if sites is not None:
        trainable = set(method.trainable_leaves(peft))
        by_name = {s.name: s for s in sites}
        gen = torch.Generator(device=device)
        for site_name, tree in out.items():
            ref = method.init_site(gen, by_name[site_name], peft, device)
            for leaf, v in ref.items():
                if leaf not in trainable:
                    tree[leaf] = v
    return out, peft


def list_adapters(directory: str) -> Tuple[str, ...]:
    if not os.path.isdir(directory):
        return ()
    return tuple(name for name in sorted(os.listdir(directory))
                 if ".tmp-" not in name
                 and os.path.exists(os.path.join(directory, name, _MANIFEST)))
