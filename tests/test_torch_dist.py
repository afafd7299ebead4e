"""The port's distributed layer against the JAX package's: int8
error-feedback compression (bitwise), the op-statistics recorder (exact
flops, every collective kind in its own bucket), and a 4x2 mesh of eight
CPU ranks (gloo) with FSDP on.

The 4x2 case trains reduced yi-6b (width 64) in f32 three steps on
DTensors with FSDP on, with and without int8_ef, and holds the losses
(rtol 1e-5) and c (atol 1e-5) to JAX's single-device step on the same
params and batches. FSDP's size gate (65536 elements: below it a weight's
gather costs more than its memory saves) would leave every reduced weight
whole, so the ranks lower it to 4096 elements: wq, wi, wg and wo_mlp then
scatter over `data` as well as `model`, the adapter leaves stay
replicated. (A wider model is no way round it: at width 256 the unsharded
port's c already parts from JAX's by 1.8e-5 after one step — Adam's first
update is g/(|g|+eps), which turns 1e-10 rounding differences of a
near-zero gradient into lr-sized ones.)

The same ranks record one train step and one decode step under the rules
and under the searched plan: the searched plan's collective bytes are
lower in both (the JAX package's test_searched_plan_compiled_smoke, part
1).
"""
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch import configs
from repro_torch.configs.base import PEFTConfig, ShapeConfig, TrainConfig
from repro_torch.convert import from_jax_params
from repro_torch.dist import compression, opstats
from repro_torch.dist import plan as plan_mod
from repro_torch.dist import sharding as shd
from repro_torch.dist.dtensor import to_plain
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import build
from repro_torch.train import step as ts
from repro_torch.tree import tree_leaves

VOCAB = 64
WIDTH = 64
FSDP_MIN_ELEMS = 4096
N, ALPHA = 32, 10.0
SITES = ("layers/wq", "layers/wv")
STEPS = 3
TRAIN_KW = dict(learning_rate=1e-2, total_steps=STEPS, warmup_steps=1)


# ---------------------------------------------------------------------------
# int8 error feedback
# ---------------------------------------------------------------------------

def _grad_tree(seed, dtype):
    rng = np.random.default_rng(seed)
    return {"peft": {"layers/wq": {"c": rng.normal(size=(2, 32)) * 1e-3},
                     "layers/wv": {"c": rng.normal(size=(2, 32)) * 5.0}},
            "head": rng.normal(size=(16, 8)).astype(np.float32)}, dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_with_feedback_is_bitwise_jax(dtype):
    import jax
    import jax.numpy as jnp
    from repro.dist import compression as jax_compression
    tree, _ = _grad_tree(0, dtype)
    jgrads = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32)
                          .astype(dtype), tree)
    tgrads = from_jax_params(jax.device_get(jgrads), "cpu")
    jres = jax_compression.init_residual(jgrads)
    tres = compression.init_residual(tgrads)
    for step in range(3):       # the residual carries across steps
        jsent, jres = jax_compression.compress_with_feedback(jgrads, jres)
        tsent, tres = compression.compress_with_feedback(tgrads, tres)
        for a, b in ((jsent, tsent), (jres, tres)):
            ja = jax.tree.leaves(jax.device_get(a))
            tb = tree_leaves(b)
            assert len(ja) == len(tb)
            for x, y in zip(ja, tb):
                want = from_jax_params({"x": x}, "cpu")["x"]
                assert y.dtype == want.dtype
                assert torch.equal(y, want), step
    assert compression.payload_bytes(tgrads) == \
        jax_compression.payload_bytes(jgrads)


def test_quantize_roundtrip_bound():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=1000)
                         .astype(np.float32))
    q, s = compression.quantize_int8(x)
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    err = (compression.dequantize(q, s) - x).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-6


def test_quantize_rounds_half_to_even():
    # y / scale lands exactly on .5 codes: ties go to the even code
    y = torch.tensor([127.0, 0.5, 1.5, 2.5, -2.5], dtype=torch.float32)
    q, s = compression.quantize_int8(y)
    assert float(s) == 1.0
    assert q.tolist() == [127, 0, 2, 2, -2]


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 100))
def test_error_feedback_converges(seed):
    """Accumulated EF-compressed sums converge to the true sum: the
    residual stays bounded while the signal accumulates (the JAX
    package's property, on the port's compress_with_feedback)."""
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=64)
                         .astype(np.float32))
    tree = {"g": x}
    res = compression.init_residual(tree)
    acc = torch.zeros_like(x)
    for _ in range(64):
        sent, res = compression.compress_with_feedback(tree, res)
        acc += sent["g"]
    np.testing.assert_allclose((acc / 64).numpy(), x.numpy(),
                               atol=float(x.abs().max()) / 50 + 1e-3)


# ---------------------------------------------------------------------------
# op statistics
# ---------------------------------------------------------------------------

def test_opstats_counts_exact_matmul_flops():
    a, b = torch.ones(4, 6), torch.ones(6, 5)
    with opstats.OpStats() as rec:
        c = a @ b
        torch.relu(c)
    st_ = rec.stats
    assert st_.flops == st_.dot_flops == 2 * 4 * 6 * 5
    # the matmul reads a and b and writes c once; relu adds its own
    assert st_.bytes_min == 4 * (4 * 6 + 6 * 5 + 4 * 5)
    assert st_.bytes == st_.bytes_min + 2 * 4 * (4 * 5)
    assert st_.collective_bytes == 0 and not st_.bytes_by_kind


# ---------------------------------------------------------------------------
# eight ranks: 4x2 with FSDP, opstats of rules vs search
# ---------------------------------------------------------------------------

def _cfg():
    return configs.reduced(configs.get("yi-6b"), width=WIDTH).replace(
        vocab=VOCAB, param_dtype="float32", dtype="float32")


def _batch(seed, B=4, S=16):
    toks = np.random.default_rng(seed).integers(
        0, VOCAB, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _collective_kinds(rank):
    """Every collective kind once, recorded."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    g = dist.group.WORLD
    x = torch.ones(8)
    with opstats.OpStats() as rec:
        outs = [funcol.all_reduce(x, "sum", g),
                funcol.all_gather_tensor(x, 0, g),
                funcol.reduce_scatter_tensor(x, "sum", 0, g),
                funcol.all_to_all_single(x, None, None, g)]
        if rank % 2 == 0:
            dist.send(x, rank + 1)
        else:
            dist.recv(x, rank - 1)
        [o + 0 for o in outs]
    return rec.stats


def _train_record(model, params, mesh, plan, **tkw):
    tcfg = TrainConfig(**TRAIN_KW, **tkw)
    state, frozen = ts.state_from_params(model, params, tcfg)
    src = plan_mod.resolve(plan, model=model, mesh=mesh,
                           shape=ShapeConfig("runtime", 16, 4, "train"),
                           workload="train")
    state, frozen, _, fr_sh = ts.shard_train_state(
        model, state, frozen, mesh, fsdp=True, plan=src)
    step, b_sh = ts.make_sharded_train_step(
        model, tcfg, mesh, _t(_batch(10)), plan=src)
    losses, stats = [], None
    for i in range(STEPS):
        batch = shd.distribute(_t(_batch(10 + i)), b_sh, mesh)
        if i == STEPS - 1:      # a warm step, recorded
            with opstats.OpStats() as rec:
                state, m = step(state, frozen, batch)
            stats = rec.stats
        else:
            state, m = step(state, frozen, batch)
        losses.append(float(to_plain(m["loss"])))
    fsdp_leaves = sum(1 for leaf in tree_leaves(fr_sh)
                      if sum(p.is_shard() for p in leaf) == 2)
    return {"losses": losses, "stats": stats, "fsdp_leaves": fsdp_leaves,
            "c": {s: to_plain(state["trainable"]["peft"][s]["c"])
                  for s in SITES}}


def _decode_record(model, params, mesh, plan):
    from repro_torch.serve import Engine
    engine = Engine(model, params, batch_slots=4, max_len=32, device="cpu",
                    mesh=mesh, plan=plan)
    prompts = [torch.arange(3 + i, dtype=torch.int32) + i for i in range(4)]
    p, extra = engine._batch_extra(None)
    last, cache = engine.model.prefill(
        p, engine._fresh_cache(), {"tokens": engine._padded_tokens(prompts)})
    engine.model.decode_step(p, cache, {"tokens": last[:, None]})   # warm
    with opstats.OpStats() as rec:
        nxt, _ = engine.model.decode_step(p, cache, {"tokens": last[:, None]})
    return {"stats": rec.stats, "tokens": nxt.tolist()}


def _mesh_worker(rank, world, workdir):
    with np.load(os.path.join(workdir, "params.npz")) as z:
        flat = {k: z[k] for k in z.files}
    params = {"base": {}, "peft": {}}
    for k, v in flat.items():
        sect, *rest = k.split("|")
        node = params[sect]
        if sect == "peft":
            node = node.setdefault(rest[0], {})
            rest = rest[1:]
        for part in rest[:-1]:
            node = node.setdefault(part, {})
        node[rest[-1]] = v
    params = from_jax_params(params, "cpu")
    model = build(_cfg(), PEFTConfig(method="fourierft", n=N, alpha=ALPHA))
    mesh = mesh_mod.make_host_mesh(model=2)
    shd.FSDP_MIN_ELEMS = FSDP_MIN_ELEMS       # module docstring
    out = {"mesh": tuple(mesh.shape), "kinds": _collective_kinds(rank)}
    for name, plan, kw in (("rules", "rules", {}),
                           ("int8_ef", "rules",
                            {"grad_compression": "int8_ef"}),
                           ("search", "search", {})):
        out[name] = _train_record(model, params, mesh, plan, **kw)
    serve_model = build(_cfg(), PEFTConfig(method="fourierft", n=N,
                                           alpha=ALPHA))
    out["decode"] = {plan: _decode_record(serve_model, params, mesh, plan)
                     for plan in ("rules", "search")}
    if rank == 0:
        torch.save(out, os.path.join(workdir, "mesh.pt"))


def _flat_jax(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_jax(v, f"{prefix}{k}|"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.fixture(scope="module")
def run_4x2(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import repro.configs as jax_configs
    from repro.configs.base import PEFTConfig as JaxPEFT
    from repro.configs.base import TrainConfig as JaxTrain
    from repro.models import build as jax_build
    from repro.train import step as jax_step
    workdir = str(tmp_path_factory.mktemp("dist4x2"))
    jcfg = jax_configs.reduced(jax_configs.get("yi-6b"), width=WIDTH).replace(
        vocab=VOCAB, param_dtype="float32", dtype="float32")
    jmodel = jax_build(jcfg, JaxPEFT(method="fourierft", n=N, alpha=ALPHA))
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    np.savez(os.path.join(workdir, "params.npz"), **_flat_jax(jparams))
    ref = {}
    for name, kw in (("rules", {}),
                     ("int8_ef", {"grad_compression": "int8_ef"})):
        tc = JaxTrain(**TRAIN_KW, **kw)
        state, frozen = jax_step.init_state(jmodel, tc,
                                            jax.random.PRNGKey(0))
        fn = jax.jit(jax_step.make_train_step(jmodel, tc))
        losses = []
        for i in range(STEPS):
            state, m = fn(state, frozen, {k: jnp.asarray(v) for k, v
                                          in _batch(10 + i).items()})
            losses.append(float(m["loss"]))
        ref[name] = {"losses": losses,
                     "c": {s: np.asarray(state["trainable"]["peft"][s]["c"])
                           for s in SITES}}
    mesh_mod.spawn_cpu_ranks(_mesh_worker, 8, workdir, workdir)
    return torch.load(os.path.join(workdir, "mesh.pt"),
                      weights_only=False), ref


def test_every_collective_kind_has_its_own_bucket(run_4x2):
    out, _ = run_4x2
    kinds = out["kinds"]
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        assert kinds.count_by_kind[kind] == 1, kind
        assert kinds.bytes_by_kind[kind] > 0
    assert kinds.bytes_by_kind["all-gather"] == 4 * 8 * 8     # 8 ranks
    assert kinds.bytes_by_kind["reduce-scatter"] == 4 * 8 // 8
    assert kinds.group_by_kind["all-reduce"] == 8
    assert kinds.group_by_kind["collective-permute"] == 2
    assert kinds.collective_bytes == sum(kinds.bytes_by_kind.values())


@pytest.mark.parametrize("name", ["rules", "int8_ef"])
def test_fsdp_on_a_4x2_mesh_tracks_jax(run_4x2, name):
    out, ref = run_4x2
    assert out["mesh"] == (4, 2)
    # FSDP scattered the projections over `data` besides `model`
    assert out[name]["fsdp_leaves"] >= 4
    np.testing.assert_allclose(out[name]["losses"], ref[name]["losses"],
                               rtol=1e-5)
    for s in SITES:
        np.testing.assert_allclose(out[name]["c"][s].numpy(),
                                   ref[name]["c"][s], atol=1e-5)


def test_search_moves_fewer_collective_bytes_than_rules(run_4x2):
    """At smoke scale every collective is launch latency, so the planner
    replicates and the searched plan's recorded traffic is lower for a
    train step and for a decode step alike."""
    out, _ = run_4x2
    for kind in ("rules", "search"):
        assert out[kind]["stats"].flops > 0
    assert out["search"]["stats"].collective_bytes \
        < out["rules"]["stats"].collective_bytes
    dec = out["decode"]
    assert dec["search"]["stats"].collective_bytes \
        < dec["rules"]["stats"].collective_bytes
    assert dec["search"]["tokens"] == dec["rules"]["tokens"]
    np.testing.assert_allclose(out["search"]["losses"],
                               out["rules"]["losses"], rtol=1e-5)
