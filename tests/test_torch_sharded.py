"""The port's sharded train and serve paths on a 2x2 mesh of CPU ranks
(gloo) against the JAX package's single-device run, in f32.

The JAX model's params (reduced yi-6b, vocab 64, FourierFT n 32, alpha 10)
are saved to numpy and loaded by every rank through
`repro_torch.convert.from_jax_params`; batches are the same numpy arrays.
One group of four ranks runs every case on DTensors placed by the rules
and by the searched plan, and rank 0 writes what it saw; the tests hold
that to JAX's single-device step (losses rtol 1e-5, c atol 1e-5, the
gradient tolerance of tests/test_torch_train.py; at `--microbatch 2` also
the gradient norms, rtol 1e-5: the placed batch's rows are ordered so that
each rank's every-other row is its share of JAX's contiguous
microbatches), to the rules (searched
plan: losses rtol 1e-5, logits atol 1e-4), to the unsharded port and to
JAX's greedy streams (the engine on the mesh, paged continuous batching
too), and to the checkpoint two ranks saved (elastic restore at four ranks
and at one).
"""
import os

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import PEFTConfig, ShapeConfig, TrainConfig
from repro_torch.core import adapter as adapter_mod
from repro_torch.convert import from_jax_params
from repro_torch.dist import plan as plan_mod
from repro_torch.dist import sharding as shd
from repro_torch.dist.dtensor import is_dtensor, to_plain
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import build
from repro_torch.train import step as ts
from repro_torch.tree import tree_leaves, tree_map

VOCAB = 64
N, ALPHA = 32, 10.0
SITES = ("layers/wq", "layers/wv")
STEPS = 3
TRAIN_KW = dict(learning_rate=1e-2, total_steps=STEPS, warmup_steps=1)


def _cfg():
    return configs.reduced(configs.get("yi-6b")).replace(
        vocab=VOCAB, param_dtype="float32", dtype="float32")


def _model():
    return build(_cfg(), PEFTConfig(method="fourierft", n=N, alpha=ALPHA))


def _batch(seed, B=4, S=16):
    toks = np.random.default_rng(seed).integers(
        0, VOCAB, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


_WQ = adapter_mod.AdapterSite("layers/wq", 64, 64, 2)


def _merge_site_case(params):
    """(name, method, weight, cotangent) of the merge_site case: the
    layers' wq and a fixed ramp as the merged weight's cotangent."""
    w = params["base"]["layers"]["wq"].detach()
    g = torch.linspace(-1.0, 1.0, w.numel()).reshape(w.shape)
    return [("fourier", "fourierft", w, g), ("dct", "dct", w, g)]


def _prompts():
    return [torch.tensor([3, 5, 7, 11], dtype=torch.int32),
            torch.tensor([2, 4, 6], dtype=torch.int32)]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _load_params(workdir):
    # site names hold a "/": keep the flat npz keys apart with "|"
    with np.load(os.path.join(workdir, "params.npz")) as z:
        flat = {k.replace("|", "/"): z[k] for k in z.files}
    params = _unflat({k: v for k, v in flat.items()
                      if not k.startswith("peft/")})
    params["peft"] = {}
    for k, v in flat.items():
        if k.startswith("peft/"):
            rest = k[len("peft/"):]
            site, leaf = rest.rsplit("/", 1)
            params["peft"].setdefault(site, {})[leaf] = v
    return from_jax_params(params, "cpu")


def _sharded_train(model, params, mesh, plan: str, **tkw):
    """STEPS steps on the mesh; -> (losses, {site: whole c}, logits of
    the first batch's forward with the placed params, the frozen tree's
    placement kinds, the state, the gradient norms)."""
    tcfg = TrainConfig(**TRAIN_KW, **tkw)
    state, frozen = ts.state_from_params(model, params, tcfg)
    src = plan_mod.resolve(plan, model=model, mesh=mesh,
                           shape=ShapeConfig("runtime", 16, 4, "train"),
                           workload="train")
    state, frozen, _, fr_sh = ts.shard_train_state(
        model, state, frozen, mesh, plan=src)
    step, b_sh = ts.make_sharded_train_step(
        model, tcfg, mesh, _t(_batch(10)), plan=src)
    placed = shd.place(params, src.state_specs(params, mesh, model.cfg,
                                               False), mesh)
    logits = to_plain(model.forward(
        placed, shd.distribute(_t(_batch(10)), b_sh, mesh)))
    losses, norms = [], []
    for i in range(STEPS):
        batch = ts.place_batch(_t(_batch(10 + i)), b_sh, mesh,
                               tcfg.microbatch)
        state, m = step(state, frozen, batch)
        losses.append(float(to_plain(m["loss"])))
        norms.append(float(to_plain(m["grad_norm"])))
    c = {s: to_plain(state["trainable"]["peft"][s]["c"]) for s in SITES}
    placed_kinds = sorted({type(p).__name__ for leaf in tree_leaves(fr_sh)
                           for p in leaf})
    return losses, c, logits, placed_kinds, state, norms


def _save_worker(rank, world, workdir):
    """Two ranks (1x2: model-parallel): three steps, then a checkpoint."""
    model = _model()
    mesh = mesh_mod.make_host_mesh(model=2)
    *_, state, _ = _sharded_train(model, _load_params(workdir), mesh,
                                  "rules")
    ckpt.save_sync(os.path.join(workdir, "ckpt"), 7, state)
    whole = tree_map(to_plain, state)
    if rank == 0:
        torch.save(whole, os.path.join(workdir, "saved.pt"))


def _mesh_worker(rank, world, workdir):
    from repro_torch.launch.serve import demo_trace
    from repro_torch.serve import ContinuousScheduler, Engine
    model = _model()
    params = _load_params(workdir)
    mesh = mesh_mod.make_host_mesh(model=2)
    out = {"mesh": tuple(mesh.shape)}
    for name, plan, kw in (("rules", "rules", {}),
                           ("int8_ef", "rules",
                            {"grad_compression": "int8_ef"}),
                           ("microbatch", "rules", {"microbatch": 2}),
                           ("search", "search", {})):
        losses, c, logits, kinds, _, norms = _sharded_train(
            model, params, mesh, plan, **kw)
        out[name] = {"losses": losses, "c": c, "logits": logits,
                     "placements": kinds, "grad_norms": norms}
    # the engine on the mesh: lockstep generate and paged continuous
    engine = Engine(model, params, batch_slots=2, max_len=32, device="cpu",
                    mesh=mesh)
    out["placed_params"] = all(
        is_dtensor(v) for v in tree_leaves(engine.params["base"]))
    out["generate"] = [o.tolist() for o in engine.generate(_prompts(),
                                                           max_new=6)]
    sched = ContinuousScheduler(engine, paged=True, page_size=8)
    out["pool_placed"] = is_dtensor(sched.cache["pk"])
    reqs, arrivals = demo_trace(_prompts(), 4, 6, 1.0)
    sched.serve(reqs, arrivals)
    out["continuous"] = [r.out for r in reqs]
    # the dense per-slot cache: its rows shard over `data`
    sched = ContinuousScheduler(engine, paged=False)
    reqs, arrivals = demo_trace(_prompts(), 4, 6, 1.0)
    sched.serve(reqs, arrivals)
    out["continuous_dense"] = [r.out for r in reqs]
    # elastic restore of the two-rank checkpoint at four ranks
    template, _ = ts.state_from_params(model, params)
    _, _, st_sh, _ = ts.shard_train_state(model, template, template, mesh)
    restored, at = ckpt.restore(os.path.join(workdir, "ckpt"),
                                placements=st_sh, mesh=mesh)
    out["restored_at"] = at
    out["restored"] = tree_map(to_plain, restored)
    out["restored_placed"] = is_dtensor(
        restored["trainable"]["peft"]["layers/wq"]["c"])
    # merge_site on a weight placed on the mesh, column-sharded over
    # `model`: the ΔW Functions behind K1/K2 and K4/K5 (their plain
    # versions here) run on the replicated leaves, and the ΔW's cotangent
    # comes back as a shard (zero-padded, a partial dc)
    for name, method, w, g in _merge_site_case(params):
        peft = PEFTConfig(method=method, n=N, alpha=ALPHA)
        rep = shd.place({"c": params["peft"]["layers/wq"]["c"],
                         "entries": params["peft"]["layers/wq"]["entries"],
                         "w": w},
                        {"c": shd.P(None, None), "entries": shd.P(None, None),
                         "w": shd.P(None, None, "model")}, mesh)
        ad = {"c": rep["c"].detach().requires_grad_(True),
              "entries": rep["entries"]}
        eff = {"wq": rep["w"]}
        adapter_mod.resolve(method).merge_site(eff, "wq", ad, _WQ, peft)
        merged = eff["wq"]
        (dgrad,) = torch.autograd.grad((to_plain(merged) * g).sum(),
                                       [ad["c"]])
        out[f"merge_site_{name}"] = (to_plain(merged), to_plain(dgrad),
                                     [p.dim if p.is_shard() else None
                                      for p in merged.placements])
    if rank == 0:
        torch.save(out, os.path.join(workdir, "mesh.pt"))


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """JAX's params (saved for the ranks), its three single-device steps
    (plain and int8_ef) and its greedy streams."""
    import jax
    import jax.numpy as jnp
    import repro.configs as jax_configs
    from repro.configs.base import PEFTConfig as JaxPEFT
    from repro.configs.base import TrainConfig as JaxTrain
    from repro.models import build as jax_build
    from repro.serve import Engine as JaxEngine
    from repro.train import step as jax_step
    workdir = str(tmp_path_factory.mktemp("sharded"))
    jcfg = jax_configs.reduced(jax_configs.get("yi-6b")).replace(
        vocab=VOCAB, param_dtype="float32", dtype="float32")
    jmodel = jax_build(jcfg, JaxPEFT(method="fourierft", n=N, alpha=ALPHA))
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    np.savez(os.path.join(workdir, "params.npz"),
             **{k.replace("/", "|"): np.asarray(v)
                for k, v in _flat(jparams).items()})
    ref = {}
    for name, kw in (("rules", {}), ("int8_ef",
                                     {"grad_compression": "int8_ef"}),
                     ("microbatch", {"microbatch": 2})):
        tc = JaxTrain(**TRAIN_KW, **kw)
        state, frozen = jax_step.init_state(jmodel, tc,
                                            jax.random.PRNGKey(0))
        fn = jax.jit(jax_step.make_train_step(jmodel, tc))
        losses, norms = [], []
        for i in range(STEPS):
            state, m = fn(state, frozen, {k: jnp.asarray(v) for k, v
                                          in _batch(10 + i).items()})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        ref[name] = {"losses": losses, "grad_norms": norms,
                     "c": {s: np.asarray(state["trainable"]["peft"][s]["c"])
                           for s in SITES}}
    jeng = JaxEngine(jmodel, jmodel.init(jax.random.PRNGKey(0)),
                     batch_slots=2, max_len=32)
    ref["generate"] = [np.asarray(o).tolist() for o in jeng.generate(
        [jnp.asarray(p.numpy()) for p in _prompts()], max_new=6)]
    return workdir, ref


@pytest.fixture(scope="module")
def mesh_run(jax_reference):
    """Two ranks save a checkpoint, then four ranks (2x2) run every case;
    rank 0's record."""
    workdir, _ = jax_reference
    mesh_mod.spawn_cpu_ranks(_save_worker, 2, workdir, workdir)
    mesh_mod.spawn_cpu_ranks(_mesh_worker, 4, workdir, workdir)
    return (torch.load(os.path.join(workdir, "mesh.pt")),
            torch.load(os.path.join(workdir, "saved.pt")))


@pytest.mark.parametrize("name", ["rules", "int8_ef", "microbatch"])
def test_train_on_a_2x2_mesh_tracks_jax(mesh_run, jax_reference, name):
    out, _ = mesh_run
    _, ref = jax_reference
    assert out["mesh"] == (2, 2)
    # the rules shard the frozen projections over `model`
    assert "Shard" in out[name]["placements"]
    np.testing.assert_allclose(out[name]["losses"], ref[name]["losses"],
                               rtol=1e-5)
    if name == "microbatch":
        # JAX's contiguous microbatches, not another grouping of the rows
        np.testing.assert_allclose(out[name]["grad_norms"],
                                   ref[name]["grad_norms"], rtol=1e-5)
    for s in SITES:
        np.testing.assert_allclose(out[name]["c"][s].numpy(),
                                   ref[name]["c"][s], atol=1e-5)


@pytest.mark.parametrize("k", [2, 4])
def test_microbatch_order_makes_the_strided_split_contiguous(k):
    """`place_batch`'s row order: every k-th row of the ordered batch (the
    placed step's split, each rank's share a run of its rows) is JAX's
    contiguous microbatch i, rows in order, for tokens and for axis 1 of
    the (3, B, S) positions; the order is a permutation (its inverse
    gives the batch back) and the identity at k <= 1."""
    B = 8
    batch = {"tokens": torch.arange(B * 5).reshape(B, 5),
             "positions": torch.arange(3 * B * 5).reshape(3, B, 5)}
    placed = ts.microbatch_order(batch, k)

    def strided(key, x, i):
        # the placed step's split (train/step.py::_microbatch of a DTensor)
        if key == "positions":
            return x.reshape(3, B // k, k, 5)[:, :, i]
        return x.reshape(B // k, k, 5)[:, i]
    for i in range(k):
        for key, x in batch.items():
            torch.testing.assert_close(strided(key, placed[key], i),
                                       ts._microbatch(key, x, k, i),
                                       rtol=0, atol=0)
    inv = torch.argsort(torch.arange(B).reshape(k, B // k).T.reshape(-1))
    torch.testing.assert_close(placed["tokens"][inv], batch["tokens"],
                               rtol=0, atol=0)
    torch.testing.assert_close(placed["positions"][:, inv],
                               batch["positions"], rtol=0, atol=0)
    assert ts.microbatch_order(batch, 1) is batch
    assert ts.microbatch_order(batch, 0) is batch
    with pytest.raises(ValueError, match="multiple"):
        ts.microbatch_order({"tokens": torch.zeros((6, 2))}, 4)


def test_searched_plan_matches_the_rules(mesh_run):
    """tests/test_sharding_plan.py's equivalence on the port: the searched
    plan (replicate-everywhere at this scale) trains and forwards as the
    rule table does."""
    out, _ = mesh_run
    np.testing.assert_allclose(out["search"]["losses"],
                               out["rules"]["losses"], rtol=1e-5)
    torch.testing.assert_close(out["search"]["logits"],
                               out["rules"]["logits"], atol=1e-4, rtol=0)
    for s in SITES:
        torch.testing.assert_close(out["search"]["c"][s],
                                   out["rules"]["c"][s], atol=1e-5, rtol=0)


def test_sharded_logits_equal_the_unsharded_forward(mesh_run,
                                                    jax_reference):
    out, _ = mesh_run
    workdir, _ = jax_reference
    model = _model()
    plain = model.forward(_load_params(workdir), _t(_batch(10)))
    torch.testing.assert_close(out["rules"]["logits"], plain, atol=1e-4,
                               rtol=0)


def test_engine_on_a_2x2_mesh_matches_unsharded_and_jax(mesh_run,
                                                         jax_reference):
    from repro_torch.launch.serve import demo_trace
    from repro_torch.serve import ContinuousScheduler, Engine
    out, _ = mesh_run
    workdir, ref = jax_reference
    assert out["placed_params"] and out["pool_placed"]
    engine = Engine(_model(), _load_params(workdir), batch_slots=2,
                    max_len=32, device="cpu")
    plain = [o.tolist() for o in engine.generate(_prompts(), max_new=6)]
    assert out["generate"] == plain == ref["generate"]
    sched = ContinuousScheduler(engine, paged=True, page_size=8)
    reqs, arrivals = demo_trace(_prompts(), 4, 6, 1.0)
    sched.serve(reqs, arrivals)
    assert out["continuous"] == [r.out for r in reqs]
    assert out["continuous_dense"] == [r.out for r in reqs]


def test_checkpoint_from_two_ranks_restores_at_four_and_one(mesh_run,
                                                           jax_reference):
    out, saved = mesh_run
    workdir, _ = jax_reference
    assert out["restored_at"] == 7 and out["restored_placed"]
    one, at = ckpt.restore(os.path.join(workdir, "ckpt"))
    assert at == 7
    for tree in (out["restored"], one):
        got, want = _flat(tree), _flat(saved)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_deltaw_functions_take_dtensor_coefficients(mesh_run,
                                                    jax_reference):
    """merge_site on a weight placed column-sharded over `model` keeps the
    weight's placement and gives the unplaced merge and its gradient (the
    fourierft and dct ΔW Functions)."""
    out, _ = mesh_run
    workdir, _ = jax_reference
    params = _load_params(workdir)
    for name, method, w, g in _merge_site_case(params):
        peft = PEFTConfig(method=method, n=N, alpha=ALPHA)
        ad = {"c": params["peft"]["layers/wq"]["c"].detach()
              .requires_grad_(True),
              "entries": params["peft"]["layers/wq"]["entries"]}
        eff = {"wq": w}
        adapter_mod.resolve(method).merge_site(eff, "wq", ad, _WQ, peft)
        (dgrad,) = torch.autograd.grad((eff["wq"] * g).sum(), [ad["c"]])
        got_w, got_grad, placements = out[f"merge_site_{name}"]
        assert placements == [None, 2], placements     # (data, model)
        torch.testing.assert_close(got_w, eff["wq"], atol=1e-6, rtol=0)
        torch.testing.assert_close(got_grad, dgrad, atol=1e-5, rtol=1e-5)