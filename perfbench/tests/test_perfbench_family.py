"""The family contract: a configuration's `reference` key selects the
harness's module (perfbench/families/<reference>.py) and the plain model
(perfbench/reference/<reference>.py). The decoder family reads what the
harness read before the contract (its values pinned here), and a second
family joins from new files alone."""
import hashlib
import json
import shutil
import time

import pytest
import torch

import perfbench_testroot as tr
import run as runner
from harness import checks, inputs, spec

TINY = json.loads((tr.DATA / "configs" / "tiny-dense.json").read_text())
YI = json.loads((tr.BENCH / "configs" / "yi-6b.json").read_text())
DECODER = spec.family(TINY, tr.REPO)
SEED = 2 ** 31 + 4242

# read with the harness of the tree before the contract (the functions then
# in harness/inputs.py, flops.py and modelcfg.py, and the reference keyed
# by the sites' last components), on this seed
GOLDEN = {
    "base_sha256":
        "0dbc846af1e814e543d29116d01aea50651336e021936cff6adfd57c4ee9bfe6",
    "tiny": {"train_4x32": 49283072.0, "train_8x1024": 9395240960.0,
             "prefill_20": 3084288.0, "prefill_768": 264273920.0,
             "decode": 611328.0,
             "sites": [("layers/wq", 64, 64, 2), ("layers/wv", 64, 32, 2)]},
    "yi": {"train_4x32": 2972117368832.0,
           "train_8x1024": 196606422941696.0,
           "prefill_20": 222088396800.0, "prefill_768": 8659178356736.0,
           "decode": 34864103424.0,
           "sites": [("layers/wq", 4096, 4096, 32),
                     ("layers/wv", 4096, 512, 32)]},
    "loss": 5.590421676635742,
    "grad_norms": {"layers/wq": [0.0024129552766680717,
                                 0.0008441496174782515],
                   "layers/wv": [0.01418247539550066,
                                 0.009723235853016376]},
}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def test_decoder_weights_are_the_parent_trees():
    base = inputs.make_base(DECODER.base_layout(TINY), SEED, "cpu")
    h = hashlib.sha256()
    for k, v in sorted(_leaves(base)):
        h.update(f"{k}:{v.dtype}:{tuple(v.shape)}".encode())
        h.update(v.contiguous().view(torch.int16).numpy().tobytes())
    assert h.hexdigest() == GOLDEN["base_sha256"]
    assert list(base) == ["layers", "embed", "lm_head", "final_norm"]


@pytest.mark.parametrize("name,cfg", [("tiny", TINY), ("yi", YI)])
def test_decoder_operations_and_sites_are_the_parent_trees(name, cfg):
    fam, want = spec.family(cfg, tr.REPO), GOLDEN[name]
    assert fam.train_step_ops(cfg, 4, 32) == want["train_4x32"]
    assert fam.train_step_ops(cfg, 8, 1024) == want["train_8x1024"]
    assert fam.prefill_ops(cfg, 20) == want["prefill_20"]
    assert fam.prefill_ops(cfg, 768) == want["prefill_768"]
    assert fam.decode_ops(cfg, [100, 1, 37]) == want["decode"]
    assert [tuple(s) for s in fam.adapted_sites(cfg)] == want["sites"]


def test_decoder_reference_first_step_is_the_parent_trees():
    model = spec.reference(TINY, tr.REPO)
    dims, entries = checks.reference_setup(model, TINY, "cpu")
    base = inputs.make_base(DECODER.base_layout(TINY), SEED, "cpu")
    sites = DECODER.adapted_sites(TINY)
    c0 = inputs.make_coeffs(sites, TINY["adapter"]["n"], SEED, "cpu")
    b = inputs.train_batch(SEED, 0, 4, 32, TINY["vocab_size"], "cpu")
    loss, g = model.loss_and_grads(base, c0, entries, b["tokens"],
                                   b["labels"], dims)
    assert loss == pytest.approx(GOLDEN["loss"], rel=1e-6)
    assert sorted(g) == sorted(GOLDEN["grad_norms"])
    for k, want in GOLDEN["grad_norms"].items():
        assert g[k].norm(dim=-1).tolist() == pytest.approx(want, rel=1e-6)


def test_the_family_is_found_by_the_reference_key_alone(tmp_path):
    root = tr.make_root(tmp_path)
    cfg = dict(TINY, reference="no-such-family")
    with pytest.raises(FileNotFoundError, match="no-such-family"):
        spec.family(cfg, root)
    assert spec.family(TINY, root) is spec.family(TINY, root)
    assert spec.family(TINY, root) is not DECODER
    assert spec.reference(TINY, root).Dims(TINY).sites == (
        "layers/wq", "layers/wv")


def test_the_harness_names_no_family():
    files = sorted((tr.BENCH / "harness").glob("*.py")) + [
        tr.BENCH / "reference" / "steps.py", tr.BENCH / "run.py",
        tr.BENCH / "calibrate.py", tr.BENCH / "sweep.py"]
    for f in files:
        assert "decoder" not in f.read_text(), f


QK_CELL = "tiny-qknorm-train"


def _qknorm_root(tmp, qk_norm: bool):
    """A test root plus the decoder-qknorm family, its configuration, cell
    and limits, as new files and new entries only."""
    root = tr.make_root(tmp)
    pb = root / "perfbench"
    shutil.copy(tr.DATA / "families" / "decoder-qknorm.py", pb / "families")
    ref = (tr.DATA / "reference" / "decoder-qknorm.py").read_text()
    if not qk_norm:
        assert ref.count("QK_NORM = True") == 1
        ref = ref.replace("QK_NORM = True", "QK_NORM = False")
    (pb / "reference" / "decoder-qknorm.py").write_text(ref)
    shutil.copy(tr.DATA / "configs" / "tiny-qknorm.json", pb / "configs")
    shutil.copy(tr.DATA / "limits" / f"{QK_CELL}.json", pb / "limits")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-qknorm", "source": "test",
                             "file": "perfbench/configs/tiny-qknorm.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": QK_CELL, "config": "tiny-qknorm",
                               "traffic": "tiny-train", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny-dense-train" in m.get("workloads", ()):
            m["workloads"].append(QK_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("qk_norm", [True, False],
                         ids=["with_qk_norm", "reference_without_qk_norm"])
def test_a_second_family_joins_from_new_files_alone(tmp_path, qk_norm):
    root = _qknorm_root(tmp_path, qk_norm)
    cell = spec.cell(root, QK_CELL)
    layout = cell.family.base_layout(cell.cfg)
    assert layout["layers/q_norm"] == ((2, 16), "ones")
    assert cell.family.model_config(cell.cfg).qk_norm is True
    res = runner.run_cell(root, QK_CELL, SEED, 0.5, False,
                          torch.device("cpu"), t_start=time.perf_counter())
    assert res["correct"] is qk_norm, res["checks"]
    if not qk_norm:
        g = res["checks"]["grad_gap"]
        assert g["value"] > 10 * g["limit"]
