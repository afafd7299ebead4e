"""The port's multi-tenant adapter bank against the JAX package and against
itself, on a reduced yi-6b (vocab 64, f32).

- A three-tenant (fourierft, lora, circulant) bank: logits equal JAX's
  (atol 1e-5 / rtol 1e-4) and Engine.generate streams equal JAX's.
- Within the port: a heterogeneous batch is bitwise its single-tenant
  runs, a `None` row is bitwise the bare base, LRU eviction and
  checkpoint reloads round-trip, a failed load leaks no slot, profile
  mismatches and partial sites are rejected, and a reused slot carries no
  stale rows (tests/test_adapter_bank.py's dense cases).
- Adapter-only exports of every method cross between the packages.
- The bank-aware ContinuousScheduler: streams equal the serial engine's
  with five methods mixed and with a tenant evicted mid-stream, live
  tenants pinned (BankFullError when every resident is), and a slot whose
  EOS is drained late keeps its tenant until then.
- Engine.generate_requests: chunking, and the EOS early exit (2 decode
  calls, not 9).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.checkpoint import adapters as jax_ckpt
from repro.configs.base import PEFTConfig as JaxPEFT
from repro.core import peft as jax_peft
from repro.models import build as jax_build
from repro.serve import AdapterBank as JaxBank
from repro.serve import Engine as JaxEngine
from repro_torch import configs
from repro_torch.checkpoint import adapters as adapter_ckpt
from repro_torch.configs.base import PEFTConfig
from repro_torch.convert import from_jax_params, from_jax_tenant
from repro_torch.core import peft as peft_mod
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build
from repro_torch.serve import (
    AdapterBank, BankFullError, ContinuousScheduler, Engine, PagedKVCache,
    Request,
)

TENANTS = ("tenant-fft", "tenant-lora", "tenant-circ")
METHODS = ("fourierft", "lora", "circulant")
ALL = ("fourierft", "dct", "lora", "circulant", "bitfit")


def _kw(method):
    return {"fourierft": dict(n=16, alpha=25.0),
            "dct": dict(n=16, alpha=25.0),
            "lora": dict(lora_r=2),
            "circulant": dict(alpha=25.0),
            "bitfit": {}}[method] | dict(method=method, param_dtype="float32")


def _cfgs():
    kw = dict(vocab=64, param_dtype="float32", dtype="float32")
    return (jax_configs.reduced(jax_configs.get("yi-6b")).replace(**kw),
            configs.reduced(configs.get("yi-6b")).replace(**kw))


def _jax_tenant(jmodel, method, i):
    """A JAX adapter tree for `method`, its floating leaves moved by seeded
    numpy noise (so zero-initialised leaves serve something)."""
    tree = jax.device_get(jax_peft.init_adapters(
        jax.random.PRNGKey(10 + i), jmodel.sites, JaxPEFT(**_kw(method))))
    rng = np.random.default_rng(100 + i)
    scale = {"circulant": 20.0, "bitfit": 0.5}.get(method, 0.3)
    for ad in tree.values():
        for leaf, v in ad.items():
            if np.issubdtype(v.dtype, np.floating):
                ad[leaf] = (v + scale * rng.normal(size=v.shape)).astype(
                    v.dtype)
    return tree


@pytest.fixture(scope="module")
def world():
    """JAX base params and tenant trees, and their port copies."""
    jcfg, tcfg = _cfgs()
    jmodel = jax_build(jcfg, JaxPEFT(method="none"))
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    model = build(tcfg, PEFTConfig(method="none"))
    params = from_jax_params(jparams, "cpu")
    jtrees = {m: _jax_tenant(jmodel, m, i) for i, m in enumerate(ALL)}
    trees = {m: from_jax_tenant(t, "cpu") for m, t in jtrees.items()}
    return jmodel, jparams, model, params, jtrees, trees


def _profiles(methods=METHODS):
    return {m: PEFTConfig(**_kw(m)) for m in methods}


def _bank(world, capacity=4, methods=METHODS, tenants=TENANTS,
          checkpoint_dir=None):
    _, _, model, _, _, trees = world
    bank = AdapterBank(model, _profiles(methods), capacity=capacity,
                       checkpoint_dir=checkpoint_dir, device="cpu")
    for tid, m in zip(tenants, methods):
        bank.load(tid, trees[m], PEFTConfig(**_kw(m)))
    return bank


def _engine(world, bank=None, slots=3, max_len=32):
    _, _, model, params, _, _ = world
    return Engine(model, params, batch_slots=slots, max_len=max_len,
                  bank=bank, device="cpu")


PROMPTS = [torch.tensor([1, 2, 3, 4]), torch.tensor([5, 6, 7]),
           torch.tensor([9, 8])]


def _lists(outs):
    return [o.tolist() for o in outs]


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

def test_three_tenant_bank_matches_jax(world):
    jmodel, jparams, model, params, jtrees, _ = world
    jprof = {m: JaxPEFT(**_kw(m)) for m in METHODS}
    jbank = JaxBank(jmodel, jprof, capacity=4)
    for tid, m in zip(TENANTS, METHODS):
        jbank.load(tid, jtrees[m], jprof[m])
    bank = _bank(world)
    toks = np.random.default_rng(2).integers(0, 64, size=(3, 8)).astype(
        np.int32)
    ids = list(TENANTS)
    import dataclasses
    jm = dataclasses.replace(jmodel, bank_profiles=dict(jbank.profiles))
    jl, _ = jm.forward({**jparams, "bank": jbank.params},
                       {"tokens": jnp.asarray(toks),
                        "adapter_slots": jbank.slot_rows(ids, 3)})
    tm = dataclasses.replace(model, bank_profiles=dict(bank.profiles))
    tl = tm.forward({**params, "bank": bank.params},
                    {"tokens": torch.from_numpy(toks),
                     "adapter_slots": bank.slot_rows(ids, 3)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-4)
    jouts = JaxEngine(jmodel, jparams, batch_slots=3, max_len=32,
                      bank=jbank).generate([jnp.asarray(p.numpy())
                                            for p in PROMPTS], max_new=6,
                                           adapter_ids=ids)
    outs = _engine(world, bank).generate(PROMPTS, max_new=6, adapter_ids=ids)
    assert _lists(outs) == [np.asarray(o).tolist() for o in jouts]


@pytest.mark.parametrize("method", ALL)
def test_adapter_exports_cross_between_packages(world, method, tmp_path):
    """A JAX export loads into the port unchanged (trees and config), and
    a port export loads into JAX."""
    jmodel, _, model, _, jtrees, trees = world
    jax_ckpt.export_adapter(str(tmp_path / "j"), "t", jtrees[method],
                            JaxPEFT(**_kw(method)))
    tree, peft = adapter_ckpt.import_adapter(str(tmp_path / "j"), "t",
                                             sites=model.sites)
    assert peft == PEFTConfig(**_kw(method))
    assert set(tree) == set(jtrees[method])
    for site, ad in jtrees[method].items():
        assert set(tree[site]) == set(ad)
        for leaf, v in ad.items():
            np.testing.assert_array_equal(tree[site][leaf].numpy(),
                                          np.asarray(v))
    adapter_ckpt.export_adapter(str(tmp_path / "t"), "t", trees[method],
                                PEFTConfig(**_kw(method)))
    jtree, jpeft = jax_ckpt.import_adapter(str(tmp_path / "t"), "t")
    assert jpeft == JaxPEFT(**_kw(method))
    for site, ad in jtree.items():
        for leaf, v in ad.items():
            np.testing.assert_array_equal(np.asarray(v),
                                          trees[method][site][leaf].numpy())


def test_tenant_conversion_checks_the_tree(world):
    with pytest.raises(ValueError, match="not a"):
        from_jax_tenant({"layers/wq": {"c": {"x": np.zeros(2)}}}, "cpu")
    tree = world[5]["lora"]
    assert set(tree["layers/wq"]) == {"lora_a", "lora_b"}
    assert tree["layers/wq"]["lora_a"].dtype == torch.float32


# ---------------------------------------------------------------------------
# Heterogeneous batches within the port
# ---------------------------------------------------------------------------

def test_heterogeneous_batch_bitwise_single_tenant(world):
    _, _, model, params, _, trees = world
    bank = _bank(world)
    het = _engine(world, bank).generate(PROMPTS, max_new=6,
                                        adapter_ids=list(TENANTS))
    for i, (tid, m) in enumerate(zip(TENANTS, METHODS)):
        b1 = AdapterBank(model, _profiles(), capacity=4, device="cpu")
        b1.load(tid, trees[m], PEFTConfig(**_kw(m)))
        single = _engine(world, b1).generate(PROMPTS, max_new=6,
                                             adapter_ids=[tid] * 3)
        assert torch.equal(het[i], single[i])
    # the same at the logits, through the whole forward
    import dataclasses
    tm = dataclasses.replace(model, bank_profiles=dict(bank.profiles))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 64, size=(3, 8)).astype(np.int32))
    p = {**params, "bank": bank.params}
    het = tm.forward(p, {"tokens": toks,
                         "adapter_slots": bank.slot_rows(list(TENANTS), 3)})
    for i, tid in enumerate(TENANTS):
        single = tm.forward(p, {"tokens": toks,
                                "adapter_slots": bank.slot_rows([tid] * 3,
                                                                3)})
        assert torch.equal(het[i], single[i])


def test_none_row_is_bitwise_the_bare_base(world):
    bank = _bank(world, capacity=5, methods=ALL,
                 tenants=[f"t-{m}" for m in ALL])
    mixed = _engine(world, bank).generate(
        PROMPTS, max_new=6, adapter_ids=["t-fourierft", None, None])
    bare = _engine(world).generate(PROMPTS, max_new=6)
    assert torch.equal(mixed[1], bare[1]) and torch.equal(mixed[2], bare[2])
    assert not torch.equal(mixed[0], bare[0])
    with pytest.raises(ValueError, match="adapter_ids"):
        _engine(world, bank).generate(PROMPTS, max_new=2,
                                      adapter_ids=["t-dct"])


def test_request_front_end_matches_generate(world):
    bank = _bank(world)
    eng = _engine(world, bank)
    reqs = [Request(PROMPTS[i], max_new=4, adapter_id=tid)
            for i, tid in enumerate(TENANTS)]
    eng.generate_requests(reqs)
    ref = eng.generate(PROMPTS, max_new=4, adapter_ids=list(TENANTS))
    assert [r.out for r in reqs] == _lists(ref)
    plain = _engine(world, slots=2)
    reqs = [Request(PROMPTS[0], max_new=4), Request(PROMPTS[1], max_new=4)]
    plain.generate_requests(reqs)
    assert [r.out for r in reqs] == _lists(plain.generate(PROMPTS[:2],
                                                          max_new=4))
    with pytest.raises(ValueError, match="no bank"):
        plain.generate(PROMPTS[:2], max_new=2,
                       adapter_ids=["tenant-fft", None])


def test_engine_does_not_change_the_callers_model(world):
    _, _, model, _, _, _ = world
    eng = _engine(world, _bank(world), slots=2)
    assert model.bank_profiles is None
    assert eng.model is not model and eng.model.bank_profiles is not None
    a = _engine(world, slots=2).generate(PROMPTS[:2], max_new=4)
    b = _engine(world, slots=2).generate(PROMPTS[:2], max_new=4)
    assert _lists(a) == _lists(b)


def test_frozen_tables_are_built_once_per_site(world):
    """fourierft keeps four f32 (d, n) tables per site, dct two; circulant,
    lora and bitfit none."""
    _, _, model, _, _, _ = world
    bank = AdapterBank(model, _profiles(ALL), capacity=2, device="cpu")
    n = 16
    # f32: fourierft 2n(d_in + d_out) values per site, dct n(d_in + d_out)
    expect = sum(3 * n * (s.d_in + s.d_out) for s in model.sites
                 if s.name in ("layers/wq", "layers/wv")) * 4
    assert bank.table_bytes == expect
    aux = bank.params["fourierft"]["aux"]["layers/wq"]
    assert set(aux) == {"entries", "cos_t", "sin_t", "cos_p", "sin_p"}
    assert set(bank.params["dct"]["aux"]["layers/wv"]) == {"entries", "c1",
                                                           "c2"}
    assert bank.params["lora"]["aux"] == {}


# ---------------------------------------------------------------------------
# Residency
# ---------------------------------------------------------------------------

def _export(world, directory, tenants=TENANTS, methods=METHODS):
    trees = world[5]
    for tid, m in zip(tenants, methods):
        adapter_ckpt.export_adapter(str(directory), tid, trees[m],
                                    PEFTConfig(**_kw(m)))


def test_lru_eviction_and_checkpoint_reload_roundtrip(world, tmp_path):
    _export(world, tmp_path)
    bank = AdapterBank(world[2], _profiles(), capacity=2,
                       checkpoint_dir=str(tmp_path), device="cpu")
    bank.load_from_checkpoint("tenant-fft")
    bank.load_from_checkpoint("tenant-lora")
    eng = _engine(world, bank)
    before = eng.generate(PROMPTS, max_new=5, adapter_ids=["tenant-fft"] * 3)
    eng.generate(PROMPTS, max_new=2, adapter_ids=["tenant-fft"] * 3)
    bank.load_from_checkpoint("tenant-circ")     # evicts lora (LRU)
    assert set(bank.resident_ids) == {"tenant-fft", "tenant-circ"}
    with pytest.raises(KeyError, match="not resident"):
        eng.generate(PROMPTS, max_new=2, adapter_ids=["tenant-lora"] * 3)
    bank.load_from_checkpoint("tenant-lora")
    bank.load_from_checkpoint("tenant-fft")
    after = eng.generate(PROMPTS, max_new=5, adapter_ids=["tenant-fft"] * 3)
    assert _lists(before) == _lists(after)
    assert bank.loads == 5


def test_profile_mismatch_and_partial_site_rejected(world):
    bank = _bank(world)
    trees = world[5]
    with pytest.raises(ValueError, match="does not match bank group"):
        bank.load("bad", trees["fourierft"],
                  PEFTConfig(**_kw("fourierft"), entry_seed=999))
    with pytest.raises(KeyError, match="no bank group"):
        bank.load("bad", {}, PEFTConfig(method="bitfit"))
    partial = {s: {k: v for k, v in d.items() if k != "lora_b"}
               for s, d in trees["lora"].items()}
    with pytest.raises(ValueError, match="missing trainable leaves"):
        bank.load("partial", partial, PEFTConfig(**_kw("lora")))
    other = {"layers/wo": trees["lora"]["layers/wq"]}
    with pytest.raises(ValueError, match="outside the bank group"):
        bank.load("stray", other, PEFTConfig(**_kw("lora")))
    assert bank.resident_ids == TENANTS and bank.matches(
        PEFTConfig(**_kw("lora"), kernel_backend="einsum"))


def test_failed_load_leaks_no_slot(world):
    _, _, model, _, _, trees = world
    bank = AdapterBank(model, _profiles(), capacity=1, device="cpu")
    bank.load("tenant-fft", trees["fourierft"], PEFTConfig(**_kw("fourierft")))
    eng = _engine(world, bank, slots=2, max_len=24)
    before = eng.generate(PROMPTS[:2], max_new=4,
                          adapter_ids=["tenant-fft", None])
    bad = {s: {k: v[..., :1] for k, v in d.items()}
           for s, d in trees["lora"].items()}
    for _ in range(3):
        with pytest.raises(ValueError, match="bank row"):
            bank.load("bad-tenant", bad, PEFTConfig(**_kw("lora")))
    assert bank.resident_ids == ("tenant-fft",)
    after = eng.generate(PROMPTS[:2], max_new=4,
                         adapter_ids=["tenant-fft", None])
    assert _lists(before) == _lists(after)
    bank.load("tenant-lora", trees["lora"], PEFTConfig(**_kw("lora")))
    assert bank.resident_ids == ("tenant-lora",)


def test_slot_reuse_clears_stale_rows(world):
    _, _, model, _, _, trees = world
    bank = AdapterBank(model, _profiles(), capacity=1, device="cpu")
    bank.load("tenant-fft", trees["fourierft"], PEFTConfig(**_kw("fourierft")))
    bank.load("tenant-lora", trees["lora"], PEFTConfig(**_kw("lora")))
    assert not any(v[0].any() for leaves in
                   bank.params["fourierft"]["sites"].values()
                   for v in leaves.values())
    outs = _engine(world, bank, slots=2, max_len=24).generate(
        PROMPTS[:2], max_new=4, adapter_ids=["tenant-lora", None])
    b1 = AdapterBank(model, _profiles(), capacity=1, device="cpu")
    b1.load("tenant-lora", trees["lora"], PEFTConfig(**_kw("lora")))
    ref = _engine(world, b1, slots=2, max_len=24).generate(
        PROMPTS[:2], max_new=4, adapter_ids=["tenant-lora", None])
    assert _lists(outs) == _lists(ref)


# ---------------------------------------------------------------------------
# The bank-aware continuous scheduler
# ---------------------------------------------------------------------------

TRACE = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12], [3, 1, 4, 1, 5, 9],
         [2, 7, 1, 8], [6, 6, 6], [9, 8, 7, 6, 5, 4, 3], [5, 5]]


def _trace(max_news, ids):
    return [Request(prompt=torch.tensor(TRACE[i % len(TRACE)]), max_new=mn,
                    adapter_id=ids[i]) for i, mn in enumerate(max_news)]


def _serial(eng, req, eos=None):
    """The request alone through Engine.generate, cut after its first EOS."""
    if req.adapter_id is not None and \
            req.adapter_id not in eng.bank.resident_ids:
        eng.bank.load_from_checkpoint(req.adapter_id)
    out = eng.generate([req.prompt], max_new=req.max_new,
                       adapter_ids=[req.adapter_id])[0].tolist()
    return out[:out.index(eos) + 1] if eos in out else out


def test_continuous_five_methods_bitwise_vs_serial(world, tmp_path):
    tids = [f"t-{m}" for m in ALL]
    _export(world, tmp_path, tids, ALL)
    bank = AdapterBank(world[2], _profiles(ALL), capacity=3,
                       checkpoint_dir=str(tmp_path), device="cpu")
    eng = _engine(world, bank, slots=3, max_len=48)
    ids = [tids[i % 5] if i % 6 != 5 else None for i in range(10)]
    reqs = _trace([5, 3, 6, 2, 4, 3, 5, 2, 4, 3], ids)
    sched = ContinuousScheduler(eng, page_size=8)
    sched.serve(reqs, arrivals=[0, 0, 0, 1, 3, 4, 5, 6, 8, 9])
    assert bank.loads >= 6                 # capacity 3 for 5 tenants
    assert sched.resource_gauges()["bank_resident_adapters"] == 3.0
    for r in reqs:
        assert r.out == _serial(eng, r)


def test_lru_eviction_mid_stream(world, tmp_path):
    """A tenant arriving against a full bank of live (pinned) tenants
    waits for one to drain, then evicts it; running streams are
    unaffected."""
    _export(world, tmp_path, ("t-a", "t-b", "t-c"),
            ("fourierft", "fourierft", "lora"))
    bank = AdapterBank(world[2], _profiles(("fourierft", "lora")),
                       capacity=2, checkpoint_dir=str(tmp_path),
                       device="cpu")
    eng = _engine(world, bank, slots=3, max_len=48)
    reqs = _trace([8, 2, 3], ["t-a", "t-b", "t-c"])
    sched = ContinuousScheduler(eng, page_size=8)
    for r, t in zip(reqs, (0, 0, 1)):
        sched.submit(r, t)
    events = list(sched.events())
    admit_t = {e[1]: e[3] for e in events if e[0] == "admit"}
    done_t = {e[1]: e[3] for e in events if e[0] == "done"}
    assert admit_t[2] >= done_t[1]
    assert "t-b" not in bank.resident_ids
    assert {"t-a", "t-c"} <= set(bank.resident_ids)
    for r in reqs:
        assert r.out == _serial(eng, r)


def test_load_refuses_to_evict_pinned(world, tmp_path):
    _export(world, tmp_path, ("t-a", "t-b", "t-c"), ("fourierft",) * 3)
    bank = AdapterBank(world[2], _profiles(("fourierft",)), capacity=2,
                       checkpoint_dir=str(tmp_path), device="cpu")
    bank.load_from_checkpoint("t-a")
    bank.load_from_checkpoint("t-b")
    with pytest.raises(BankFullError):
        bank.load_from_checkpoint("t-c", pinned=["t-a", "t-b"])
    assert set(bank.resident_ids) == {"t-a", "t-b"}
    bank.load_from_checkpoint("t-c", pinned=["t-b"])
    assert set(bank.resident_ids) == {"t-b", "t-c"}


def _eos_prompt(eng, tenant, budget):
    """(prompt, eos): a trace prompt whose stream under `tenant` first
    shows some token at step 2, and that token."""
    for p in TRACE:
        out = eng.generate([torch.tensor(p)], max_new=budget,
                           adapter_ids=[tenant])[0].tolist()
        if out[2] not in out[:2]:
            return torch.tensor(p), out[2]
    raise AssertionError("no trace prompt has a new token at step 2")


def test_late_drained_eos_keeps_its_tenant_until_the_drain(world, tmp_path):
    """Slot 0's tenant emits EOS at decode step 2; the buffered drain finds
    it one step later. Until then the slot stays live and its tenant pinned
    (the third tenant, arriving meanwhile against a full bank, waits);
    after it, the slot is re-primed for the third tenant, whose stream —
    and every other — equals the serial engine's."""
    _export(world, tmp_path, ("t-a", "t-b", "t-c"),
            ("fourierft", "lora", "circulant"))
    bank = AdapterBank(world[2], _profiles(), capacity=2,
                       checkpoint_dir=str(tmp_path), device="cpu")
    # three slots: the third tenant finds a free slot at once and waits on
    # the bank only
    eng = _engine(world, bank, slots=3, max_len=48)
    bank.load_from_checkpoint("t-a")
    prompt, eos = _eos_prompt(eng, "t-a", 10)
    reqs = [Request(prompt, max_new=10, adapter_id="t-a"),
            Request(torch.tensor(TRACE[3]), max_new=12, adapter_id="t-b"),
            Request(torch.tensor(TRACE[4]), max_new=6, adapter_id="t-c")]
    sched = ContinuousScheduler(eng, eos_id=eos, page_size=8,
                                eos_sync_every=4)
    gathers = []
    real = eng._batch_extra

    def spy(ids, batch=None):
        if batch is None:                  # a decode dispatch
            gathers.append((sched.t, list(ids)))
        return real(ids, batch)

    eng._batch_extra = spy
    for r, t in zip(reqs, (0, 0, 1)):
        sched.submit(r, t)
    events = list(sched.events())
    eng._batch_extra = real
    done_t = {e[1]: e[3] for e in events if e[0] == "done"}
    admit = {e[1]: (e[2], e[3]) for e in events if e[0] == "admit"}
    assert reqs[0].out[-1] == eos and len(reqs[0].out) == 3
    slot_c, t_c = admit[2]
    assert slot_c == admit[0][0] and t_c >= done_t[0]
    # the drain found the EOS after the step that emitted it: the slot
    # gathered t-a for that extra step, then t-c once re-primed
    seq = [ids[slot_c] for _, ids in gathers]
    assert seq[:3] == ["t-a"] * 3
    assert "t-a" not in seq[seq.index("t-c"):]
    for r in reqs:
        assert r.out == _serial(eng, r, eos)


def test_tenants_share_no_prefix_page():
    """The prefix chain key is seeded with the tenant: the same prompt
    under two tenants maps to disjoint pages; under one tenant it shares."""
    pager = PagedKVCache(n_slots=3, max_len=48, page_size=8, device="cpu")
    prompt = np.arange(17, dtype=np.int32)            # two full pages + 1
    plans = []
    for slot, tenant in enumerate(("t-a", "t-b", "t-a")):
        plan = pager.plan_admit(slot, prompt, 4, adapter_id=tenant)
        pager.register_prompt(plan)
        plans.append(plan)
    a, b, a2 = plans
    assert b.prefix_len == 0 and a2.prefix_len == 16
    assert not set(a.block_row[:2]) & set(b.block_row[:2])
    assert list(a2.block_row[:2]) == list(a.block_row[:2])


# ---------------------------------------------------------------------------
# Engine.generate_requests
# ---------------------------------------------------------------------------

def test_budgets_and_chunking(world):
    """More requests than slots, each exactly its budget, equal to the
    padded generate() of its chunk truncated (and to JAX's)."""
    jmodel, jparams = world[0], world[1]
    eng = _engine(world, slots=3, max_len=48)
    budgets = [4, 7, 2, 5, 1, 6, 3, 8]
    reqs = _trace(budgets, [None] * 8)
    eng.generate_requests(reqs)
    for at in range(0, len(reqs), 3):
        chunk = reqs[at:at + 3]
        outs = eng.generate([r.prompt for r in chunk],
                            max_new=max(r.max_new for r in chunk))
        for r, o in zip(chunk, outs):
            assert r.out == o[:r.max_new].tolist()
    from repro.serve import Request as JaxRequest
    jreqs = [JaxRequest(prompt=jnp.asarray(r.prompt.numpy()),
                        max_new=r.max_new) for r in reqs]
    JaxEngine(jmodel, jparams, batch_slots=3,
              max_len=48).generate_requests(jreqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]


def test_eos_stops_contribution_and_decoding(world):
    """Once every slot hits EOS or its budget the chunk's decode loop
    exits: with an EOS first emitted at step 2, two decode calls, not 9,
    and nothing recorded past the EOS."""
    eng = _engine(world, slots=2, max_len=48)
    prompt, eos = _eos_prompt(eng, None, 10)
    probe = [Request(prompt=prompt, max_new=10)]
    eng.generate_requests(probe)
    calls = [0]
    real = eng.model.decode_step

    def counting(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    eng.model.decode_step = counting
    reqs = [Request(prompt=prompt, max_new=10)]
    eng.generate_requests(reqs, eos_id=eos)
    del eng.model.decode_step
    assert reqs[0].out == probe[0].out[:3]
    assert calls[0] == 2


def test_generate_requests_checks_every_chunk_first(world):
    eng = _engine(world, slots=2, max_len=12)
    reqs = [Request(torch.tensor([1, 2]), max_new=3),
            Request(torch.tensor([1, 2]), max_new=3),
            Request(torch.tensor([1] * 8), max_new=6)]
    with pytest.raises(ValueError, match="lockstep chunk at 2"):
        eng.generate_requests(reqs)
    assert all(r.out is None for r in reqs)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launcher_serves_a_bank(world, tmp_path, capsys):
    """`launch.serve --bank-dir --bank-capacity --continuous` over the
    clean base: every request completes, tenants load and evict."""
    from repro_torch.core.adapter import resolve
    model = build(configs.reduced(configs.get("yi-6b")).replace(vocab=512),
                  PEFTConfig(method="none"))
    gen = torch.Generator()
    gen.manual_seed(5)
    for m in ("fourierft", "lora", "bitfit"):
        prof = PEFTConfig(**_kw(m))
        tree = peft_mod.init_adapters(gen, model.sites, prof, "cpu")
        names = resolve(m).trainable_leaves(prof)
        tree = {s: {k: torch.randn(v.shape, generator=gen)
                    for k, v in d.items() if k in names}
                for s, d in tree.items()}
        adapter_ckpt.export_adapter(str(tmp_path), f"t-{m}", tree, prof)
    launch_serve.main(["--arch", "yi-6b", "--reduced", "--bank-dir",
                       str(tmp_path), "--bank-capacity", "2",
                       "--continuous", "--trace-n", "6", "--max-new", "4",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "bank: 2 of 3 tenants resident" in out
    assert "[bank lora] -> einsum" in out
    assert "continuous: 6 requests" in out
    loads = int(out.split("bank: ")[-1].split(" loads")[0])
    assert loads >= 4                      # 2 resident + reloads mid-trace


# ---------------------------------------------------------------------------
# The bank on a mesh
# ---------------------------------------------------------------------------

def _mesh_bank_worker(rank, world_size, workdir):
    """Two ranks (1x2, model-parallel): the three-tenant bank engine on a
    DTensor mesh, lockstep generate and paged continuous serving."""
    import os
    from repro_torch.launch import mesh as mesh_mod
    saved = torch.load(os.path.join(workdir, "bank_world.pt"))
    model = build(_cfgs()[1], PEFTConfig(method="none"))
    bank = AdapterBank(model, _profiles(), capacity=4, device="cpu")
    for tid, m in zip(TENANTS, METHODS):
        bank.load(tid, saved["trees"][m], PEFTConfig(**_kw(m)))
    eng = Engine(model, saved["params"], batch_slots=3, max_len=32,
                 bank=bank, device="cpu", mesh=mesh_mod.make_host_mesh(2))
    outs = eng.generate(PROMPTS, max_new=6, adapter_ids=list(TENANTS))
    sched = ContinuousScheduler(eng, page_size=8)
    reqs = [Request(PROMPTS[i], max_new=4, adapter_id=tid)
            for i, tid in enumerate(TENANTS)]
    sched.serve(reqs)
    if rank == 0:
        torch.save({"generate": _lists(outs),
                    "continuous": [r.out for r in reqs],
                    "placed": type(eng.params["base"]["layers"]["wq"])
                    .__name__},
                   os.path.join(workdir, "bank_mesh.pt"))


def test_mesh_sharded_bank_engine_matches(world, tmp_path):
    """tests/test_adapter_bank.py's mesh case on two gloo ranks: the bank
    engine on a model-parallel DTensor mesh (the bank's rows replicated)
    streams JAX's unsharded bank engine's tokens and the port's, and its
    continuous serving the port's unsharded scheduler's."""
    import os
    from repro_torch.launch import mesh as mesh_mod
    jmodel, jparams, model, params, jtrees, trees = world
    torch.save({"params": params, "trees": trees},
               str(tmp_path / "bank_world.pt"))
    mesh_mod.spawn_cpu_ranks(_mesh_bank_worker, 2, str(tmp_path),
                             str(tmp_path))
    got = torch.load(os.path.join(str(tmp_path), "bank_mesh.pt"))
    assert got["placed"] == "DTensor"
    jprof = {m: JaxPEFT(**_kw(m)) for m in METHODS}
    jbank = JaxBank(jmodel, jprof, capacity=4)
    for tid, m in zip(TENANTS, METHODS):
        jbank.load(tid, jtrees[m], jprof[m])
    jouts = JaxEngine(jmodel, jparams, batch_slots=3, max_len=32,
                      bank=jbank).generate([jnp.asarray(p.numpy())
                                            for p in PROMPTS], max_new=6,
                                           adapter_ids=list(TENANTS))
    plain = _engine(world, _bank(world))
    assert got["generate"] == [np.asarray(o).tolist() for o in jouts] \
        == _lists(plain.generate(PROMPTS, max_new=6,
                                 adapter_ids=list(TENANTS)))
    sched = ContinuousScheduler(_engine(world, _bank(world)), page_size=8)
    reqs = [Request(PROMPTS[i], max_new=4, adapter_id=tid)
            for i, tid in enumerate(TENANTS)]
    sched.serve(reqs)
    assert got["continuous"] == [r.out for r in reqs]
