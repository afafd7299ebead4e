"""The two pieces of the package surface the reference's examples use,
against the JAX package: `data.synthetic.SyntheticClassification` (the
same numpy draw, so the same bits at the same seed, on the caller's
device) and `Model.explain_kernels(device)` (the same sites and ops as the
reference's `explain_kernels()`; only the backend names differ)."""
import re

import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.configs.base import PEFTConfig as JaxPEFT
from repro.data.synthetic import SyntheticClassification as JaxBlobs
from repro.models import build as jax_build
from repro_torch import configs
from repro_torch.configs.base import PEFTConfig
from repro_torch.data import SyntheticClassification
from repro_torch.models import build


@pytest.mark.parametrize("kw", [{}, {"num_classes": 5, "dim": 4,
                                     "noise": 0.1, "seed": 3}],
                         ids=["defaults", "dim4"])
def test_synthetic_classification_is_the_jax_draw_bitwise(kw):
    x, y = SyntheticClassification(**kw).dataset(32, device="cpu")
    jx, jy = JaxBlobs(**kw).dataset(32)
    assert x.dtype == torch.float32 and y.dtype == torch.int32
    assert x.device.type == "cpu"
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def test_synthetic_classification_runs_on_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticClassification().dataset(4)


_LINE = re.compile(r"^\s+(\S+) \((\d+)x(\d+)\) (\S+)(?: \[bank (\S+)\])? ->")


def _sites_and_ops(text):
    return [m.groups() for m in map(_LINE.match, text.splitlines()[1:]) if m]


@pytest.mark.parametrize("arch,method", [("yi-6b", "fourierft"),
                                         ("yi-6b", "dct"),
                                         ("qwen3-4b", "circulant"),
                                         ("olmoe-1b-7b", "lora")])
def test_explain_kernels_names_the_reference_sites(arch, method):
    jax_text = jax_build(jax_configs.reduced(jax_configs.get(arch)),
                         JaxPEFT(method=method, n=16)).explain_kernels()
    model = build(configs.reduced(configs.get(arch)),
                  PEFTConfig(method=method, n=16))
    want = _sites_and_ops(jax_text)
    assert want
    for device in ("cpu", "cuda"):      # resolution needs no card
        text = model.explain_kernels(device)
        assert text.splitlines()[0].endswith(f"device={device}")
        assert _sites_and_ops(text) == want
