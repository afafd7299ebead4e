"""A configuration file's adapter settings as the measured program's
`PEFTConfig`.

The adapter's settings, under `adapter`, are read the same way for every
family. The file's `ModelConfig`, and the weights the adapter targets, are
its family's (`model_config`, `adapted_sites` of
perfbench/families/<reference>.py; harness/spec.py), which also refuses
what the benchmark's weights and reference for it do not cover.
"""
from __future__ import annotations

from typing import Dict


def peft_config(cfg: Dict, **kw):
    from repro_torch.configs.base import PEFTConfig
    ad = cfg["adapter"]
    return PEFTConfig(method=ad["method"], n=ad["n"], alpha=ad["alpha"],
                      entry_seed=ad["entry_seed"],
                      target_modules=tuple(ad["target_modules"]), **kw)
