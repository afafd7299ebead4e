"""Every family on the mesh path: moe (olmoe, expert-parallel), audio
(musicgen's codebooks), vlm (qwen2-vl's embeds and M-RoPE), ssm (mamba2,
the mixer on local heads) and hybrid (zamba2) train on a 2x2 mesh of gloo
CPU ranks, held to the JAX package's single-device steps on the same
weights and batches at the tolerance of the dense case
(tests/test_torch_sharded.py: losses rtol 1e-5), and their gradient
norms at the same tolerance (the coefficients after AdamW are not compared:
its first steps turn float noise in a near-zero gradient entry into a whole
learning-rate step);
olmoe's continuous and mamba2's lockstep serving on the mesh equal the
unsharded port's streams.

The JAX side builds each reduced model (vocab 64, f32, FourierFT n 24,
alpha 10), exports its params through `repro_torch.convert` for the ranks
and runs two single-device steps; one group of four ranks runs every
family and rank 0 writes what it saw.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import PEFTConfig, TrainConfig
from repro_torch.dist import sharding as shd
from repro_torch.dist.dtensor import to_plain
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import build
from repro_torch.train import step as ts

ARCHS = ("olmoe-1b-7b", "musicgen-medium", "qwen2-vl-72b", "mamba2-2.7b",
         "zamba2-7b")
VOCAB = 64
N, ALPHA = 24, 10.0
STEPS = 2
TRAIN_KW = dict(learning_rate=1e-2, total_steps=STEPS, warmup_steps=1)


def _cfg(arch):
    return configs.reduced(configs.get(arch)).replace(
        vocab=VOCAB, param_dtype="float32", dtype="float32")


def _batch(cfg, seed, B=4, S=16):
    """A seeded batch in the family's layout (tests/test_torch_families.py's
    recipe): tokens (B, S[, CB]), or vlm embeds and (3, B, S) positions."""
    rng = np.random.default_rng(seed)
    lbl = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    labels = rng.integers(0, cfg.vocab, size=lbl).astype(np.int32)
    if not cfg.embed_inputs:
        t = np.arange(S, dtype=np.int32)
        pos = np.stack([t, t // 2, t % 3])[:, None, :].repeat(B, axis=1)
        return {"embeds": (rng.standard_normal((B, S, cfg.d_model))
                           * 0.5).astype(np.float32),
                "positions": np.ascontiguousarray(pos), "labels": labels}
    toks = rng.integers(0, cfg.vocab, size=lbl).astype(np.int32)
    return {"tokens": toks, "labels": labels}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _prompts():
    return [torch.tensor([3, 5, 7, 11], dtype=torch.int32),
            torch.tensor([2, 4, 6], dtype=torch.int32)]


def _sites(params):
    return sorted(params["peft"])


def _worker(rank, world, workdir):
    """Four ranks (2x2): every family's two sharded steps, then olmoe's
    continuous and mamba2's lockstep serving on the mesh."""
    from repro_torch.launch.serve import demo_trace
    from repro_torch.serve import ContinuousScheduler, Engine
    mesh = mesh_mod.make_host_mesh(model=2)
    out = {"mesh": tuple(mesh.shape)}
    for arch in ARCHS:
        cfg = _cfg(arch)
        model = build(cfg, PEFTConfig(n=N, alpha=ALPHA))
        params = torch.load(os.path.join(workdir, f"{arch}.pt"))
        tcfg = TrainConfig(**TRAIN_KW)
        state, frozen = ts.state_from_params(model, params, tcfg)
        state, frozen, _, _ = ts.shard_train_state(model, state, frozen,
                                                   mesh)
        step, b_sh = ts.make_sharded_train_step(model, tcfg, mesh,
                                                _t(_batch(cfg, 10)))
        losses, norms = [], []
        for i in range(STEPS):
            batch = shd.distribute(_t(_batch(cfg, 10 + i)), b_sh, mesh)
            state, m = step(state, frozen, batch)
            losses.append(float(to_plain(m["loss"])))
            norms.append(float(to_plain(m["grad_norm"])))
        out[arch] = {"losses": losses, "grad_norms": norms,
                     "sites": _sites(params)}
        if cfg.moe is not None:
            # the experts shard over `model` (the _EXPERT rule)
            out[arch]["we_i"] = [p.dim if p.is_shard() else None for p in
                                 frozen["base"]["layers"]["we_i"].placements]
    smodel = build(_cfg("olmoe-1b-7b"), PEFTConfig(method="none"))
    sparams = torch.load(os.path.join(workdir, "olmoe-1b-7b.pt"))
    eng = Engine(smodel, {"base": sparams["base"], "peft": {}},
                 batch_slots=2, max_len=32, device="cpu", mesh=mesh)
    sched = ContinuousScheduler(eng, paged=True, page_size=8)
    reqs, arrivals = demo_trace(_prompts(), 4, 6, 1.0)
    sched.serve(reqs, arrivals)
    out["olmoe_continuous"] = [r.out for r in reqs]
    mmodel = build(_cfg("mamba2-2.7b"), PEFTConfig(method="none"))
    mparams = torch.load(os.path.join(workdir, "mamba2-2.7b.pt"))
    eng = Engine(mmodel, {"base": mparams["base"], "peft": {}},
                 batch_slots=2, max_len=32, device="cpu", mesh=mesh)
    out["mamba2_generate"] = [o.tolist() for o in eng.generate(
        _prompts(), max_new=6)]
    out["circulant"] = _circulant_on_rows(mesh)
    if rank == 0:
        torch.save(out, os.path.join(workdir, "families.pt"))


def _circulant_case():
    """x (4, 3, 16), a per-row kernel (4, 1, 16) and a shared one (16,)."""
    g = torch.Generator().manual_seed(3)
    return (torch.randn((4, 3, 16), generator=g),
            torch.randn((4, 1, 16), generator=g),
            torch.randn((16,), generator=g))


def _circulant_on_rows(mesh):
    """circulant's FFT apply through `dtensor.batch_local` (the card's
    route: the FFT has no DTensor strategy in torch 2.11) on x sharded
    over `data`: the per-row (bank) form's output, and the shared
    (factored) kernel's output and gradient, as plain tensors."""
    from repro_torch.dist.dtensor import batch_local
    from repro_torch.kernels import ops as kops
    x, rows, shared = _circulant_case()
    xs = shd.place({"x": x}, {"x": shd.P("data", None, None)}, mesh)["x"]

    def fn(a, k):
        return kops.circulant_apply_fft(a, k, 16, 12, 5.0)
    bank = to_plain(batch_local(fn, xs, rows, rows=True))
    k = shd.place({"k": shared}, {"k": shd.P(None)}, mesh)["k"] \
        .requires_grad_(True)
    y = batch_local(fn, xs, k, rows=False)
    (gk,) = torch.autograd.grad((y * y).sum(), [k])
    return bank, to_plain(y).detach(), to_plain(gk)


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """Each family's JAX params (exported for the ranks) and its two
    single-device steps' losses and coefficients."""
    import jax
    import jax.numpy as jnp
    import repro.configs as jax_configs
    from repro.configs.base import PEFTConfig as JaxPEFT
    from repro.configs.base import TrainConfig as JaxTrain
    from repro.models import build as jax_build
    from repro.train import step as jax_step
    from repro_torch.convert import from_jax_params
    workdir = str(tmp_path_factory.mktemp("mesh_families"))
    ref = {}
    for arch in ARCHS:
        jcfg = jax_configs.reduced(jax_configs.get(arch)).replace(
            vocab=VOCAB, param_dtype="float32", dtype="float32")
        jmodel = jax_build(jcfg, JaxPEFT(n=N, alpha=ALPHA))
        jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
        torch.save(from_jax_params(jparams, "cpu"),
                   os.path.join(workdir, f"{arch}.pt"))
        tc = JaxTrain(**TRAIN_KW)
        state, frozen = jax_step.init_state(jmodel, tc,
                                            jax.random.PRNGKey(0))
        fn = jax.jit(jax_step.make_train_step(jmodel, tc))
        losses, norms = [], []
        for i in range(STEPS):
            batch = {k: jnp.asarray(v)
                     for k, v in _batch(_cfg(arch), 10 + i).items()}
            state, m = fn(state, frozen, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        ref[arch] = {"losses": losses, "grad_norms": norms,
                     "sites": sorted(state["trainable"]["peft"])}
    return workdir, ref


@pytest.fixture(scope="module")
def mesh_run(jax_reference):
    workdir, _ = jax_reference
    mesh_mod.spawn_cpu_ranks(_worker, 4, workdir, workdir)
    return torch.load(os.path.join(workdir, "families.pt"))


@pytest.mark.parametrize("arch", ARCHS)
def test_family_trains_on_a_2x2_mesh_like_jax(mesh_run, jax_reference, arch):
    """Two steps of the sharded train step on DTensors (moe experts over
    `model`, the ssm mixer on local heads) give JAX's single-device
    losses and gradient norms on the same adapter sites."""
    _, ref = jax_reference
    assert mesh_run["mesh"] == (2, 2)
    got = mesh_run[arch]
    if arch == "olmoe-1b-7b":
        assert got["we_i"] == [None, 1]         # (data, model)
    assert got["sites"] == ref[arch]["sites"]
    np.testing.assert_allclose(got["losses"], ref[arch]["losses"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], ref[arch]["grad_norms"],
                               rtol=1e-5)


def test_moe_and_ssm_serve_on_the_mesh_like_one_device(mesh_run,
                                                       jax_reference):
    """olmoe's paged continuous serving and mamba2's lockstep generation on
    the 2x2 mesh stream what the unsharded engine streams."""
    from repro_torch.launch.serve import demo_trace
    from repro_torch.serve import ContinuousScheduler, Engine
    workdir, _ = jax_reference
    params = torch.load(os.path.join(workdir, "olmoe-1b-7b.pt"))
    eng = Engine(build(_cfg("olmoe-1b-7b"), PEFTConfig(method="none")),
                 {"base": params["base"], "peft": {}}, batch_slots=2,
                 max_len=32, device="cpu")
    sched = ContinuousScheduler(eng, paged=True, page_size=8)
    reqs, arrivals = demo_trace(_prompts(), 4, 6, 1.0)
    sched.serve(reqs, arrivals)
    assert mesh_run["olmoe_continuous"] == [r.out for r in reqs]
    params = torch.load(os.path.join(workdir, "mamba2-2.7b.pt"))
    eng = Engine(build(_cfg("mamba2-2.7b"), PEFTConfig(method="none")),
                 {"base": params["base"], "peft": {}}, batch_slots=2,
                 max_len=32, device="cpu")
    want = [o.tolist() for o in eng.generate(_prompts(), max_new=6)]
    assert mesh_run["mamba2_generate"] == want


def test_circulant_fft_apply_runs_on_local_rows(mesh_run):
    """The FFT apply on each rank's batch rows equals the plain apply,
    per-row kernels and a shared kernel alike, and the shared kernel's
    gradient sums every rank's rows."""
    from repro_torch.kernels import ops as kops
    x, rows, shared = _circulant_case()
    bank, y, gk = mesh_run["circulant"]
    torch.testing.assert_close(bank, kops.circulant_apply_fft(
        x, rows, 16, 12, 5.0), atol=1e-6, rtol=0)
    k = shared.clone().requires_grad_(True)
    want = kops.circulant_apply_fft(x, k, 16, 12, 5.0)
    (wk,) = torch.autograd.grad((want * want).sum(), [k])
    torch.testing.assert_close(y, want.detach(), atol=1e-6, rtol=0)
    torch.testing.assert_close(gk, wk, atol=1e-5, rtol=1e-5)
