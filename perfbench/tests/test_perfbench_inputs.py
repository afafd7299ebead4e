"""The harness's inputs: traffic and batches repeat by seed, every seed asks
for the same work, and the weights are the same for the same seed."""
import json

import numpy as np
import torch

import perfbench_testroot as tr
from harness import inputs, spec

MIX = json.loads((tr.DATA / "traffic" / "tiny-serve.json").read_text())
TINY = json.loads((tr.DATA / "configs" / "tiny-dense.json").read_text())
LAYOUT = spec.family(TINY, tr.REPO).base_layout(TINY)


def _key(reqs):
    return [(r.due, r.prompt.tobytes(), r.max_new, r.tenant) for r in reqs]


def test_serve_traffic_repeats_by_seed():
    a = inputs.serve_traffic(MIX, 30.0, 2 ** 31 + 5, 64000)
    b = inputs.serve_traffic(MIX, 30.0, 2 ** 31 + 5, 64000)
    c = inputs.serve_traffic(MIX, 30.0, 2 ** 31 + 6, 64000)
    assert _key(a) == _key(b)
    assert _key(a) != _key(c)


def test_every_seed_asks_for_the_same_work():
    a = inputs.serve_traffic(MIX, 30.0, 11, 64000)
    b = inputs.serve_traffic(MIX, 30.0, 12, 64000)
    assert len(a) == len(b) == round(MIX["rate_per_s"] * 30.0)
    assert [(r.due, len(r.prompt), r.max_new) for r in a] == \
        [(r.due, len(r.prompt), r.max_new) for r in b]
    assert a[0].due == 0.0
    for rs in (a, b):
        assert all(0.0 <= r.due < 30.0 for r in rs)
        assert all(MIX["prompt"]["min"] <= len(r.prompt)
                   <= MIX["prompt"]["max"] for r in rs)
        assert all(MIX["output"]["min"] <= r.max_new
                   <= MIX["output"]["max"] for r in rs)
        assert all(r.tenant is None or 0 <= r.tenant < MIX["tenants"]
                   for r in rs)
        assert all(int(r.prompt.max()) < 64000 for r in rs)


def test_base_share_and_zipf_skew():
    reqs = inputs.serve_traffic(MIX, 200.0, 3, 1000)
    base = sum(r.tenant is None for r in reqs) / len(reqs)
    assert abs(base - MIX["base_share"]) < 0.05
    counts = np.bincount([r.tenant for r in reqs if r.tenant is not None],
                         minlength=MIX["tenants"])
    zipf = 1.0 / np.arange(1, MIX["tenants"] + 1) ** MIX["zipf_a"]
    assert np.abs(counts / counts.sum() - zipf / zipf.sum()).max() < 0.05


def test_train_batches_repeat_by_seed_and_step():
    a = inputs.train_batch(99, 3, 4, 16, 256, "cpu")
    b = inputs.train_batch(99, 3, 4, 16, 256, "cpu")
    c = inputs.train_batch(99, 4, 4, 16, 256, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert a["tokens"].dtype == torch.int32


def test_weights_repeat_by_seed():
    a = inputs.make_base(LAYOUT, 5, "cpu")
    b = inputs.make_base(LAYOUT, 5, "cpu")
    c = inputs.make_base(LAYOUT, 6, "cpu")
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])
    assert a["layers"]["wq"].dtype == torch.bfloat16
    assert torch.all(a["final_norm"] == 1)
    std = a["embed"].float().std().item()
    assert 0.015 < std < 0.025


def test_subseed_takes_any_whole_number():
    for s in (0, 1, 2 ** 31 + 17, 2 ** 40, -3):
        assert 0 <= inputs.subseed(s, "x") < 2 ** 63
    assert inputs.subseed(7, "a") != inputs.subseed(7, "b")
