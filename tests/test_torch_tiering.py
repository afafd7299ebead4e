"""The port's tiered serving against the JAX package, on a reduced yi-6b
(vocab 64, f32, CPU).

Every case of tests/test_serve_tiering.py, run on the port:
- priority/fair queue ordering, the host pools (LRU prefix entries and
  pinned snapshots under one page budget, the adapter tier), and the
  victim/mode policy, whose verdicts equal JAX's on a grid;
- preempt-and-resume (swap, recompute, auto, a swap degraded to recompute
  by a full host pool, heterogeneous tenants, speculation, a preemption
  storm), the host tiers through the runtime (adapter rows spilled and
  refilled, prefix pages demoted and promoted, a fill displaced by its own
  plan's demotions), and tiered against deferral-only admission. Each
  asserts that the port's streams equal the JAX tiered scheduler's and
  JAX's serial `Engine.generate`'s on the same params (crossed by
  `convert.from_jax_params`), and that the port's metrics summary equals
  JAX's key for key, wall-clock keys aside.

Within the port: a swap-resume restores the spilled pages bitwise; an
evicted tenant's rows come back from the host tier bitwise the
checkpoint's (the bank clones a row before it clears the slot — a view
would spill zeros); a scheduler dropped with the cyclic garbage collector
off frees its page pool; the serve launcher preempts with `--preempt`."""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.checkpoint import adapters as jax_ckpt
from repro.configs.base import PEFTConfig as JaxPEFT
from repro.core import adapter as jax_adapter_api
from repro.core import peft as jax_peft
from repro.models import build as jax_build
from repro.serve import AdapterBank as JaxBank
from repro.serve import ContinuousScheduler as JaxScheduler
from repro.serve import Engine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import TieringConfig as JaxTiering
from repro.serve.spec import NGramDrafter as JaxNGram
from repro.serve.tiering import VictimInfo as JaxVictim
from repro.serve.tiering import choose_mode as jax_choose_mode
from repro.serve.tiering import choose_victim as jax_choose_victim
from repro_torch import configs
from repro_torch.checkpoint import adapters as adapter_ckpt
from repro_torch.configs.base import PEFTConfig
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build
from repro_torch.serve import (
    AdapterBank, ContinuousScheduler, Engine, HostAdapterTier, HostPagePool,
    NGramDrafter, Request, SelfDrafter, TieringConfig,
)
from repro_torch.serve.scheduler.queue import RequestQueue
from repro_torch.serve.tiering import VictimInfo, choose_mode, choose_victim

TENANTS = ("tenant-fft", "tenant-lora")
METHODS = ("fourierft", "lora")
# keys of ServingMetrics.summary() read off the host clock
WALL_KEYS = ("wall_s", "tokens_per_s", "prime_s_mean", "prime_s_p90")


def _cfgs():
    kw = dict(vocab=64, param_dtype="float32", dtype="float32")
    return (jax_configs.reduced(jax_configs.get("yi-6b")).replace(**kw),
            configs.reduced(configs.get("yi-6b")).replace(**kw))


@pytest.fixture(scope="module")
def world():
    """The JAX base model and params (method none), and their port copies."""
    jcfg, tcfg = _cfgs()
    jmodel = jax_build(jcfg, JaxPEFT(method="none"))
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    model = build(tcfg, PEFTConfig(method="none"))
    return jmodel, jparams, model, from_jax_params(jparams, "cpu")


def _profile_kw():
    return {"fourierft": dict(method="fourierft", n=16, alpha=25.0,
                              param_dtype="float32"),
            "lora": dict(method="lora", lora_r=2, param_dtype="float32")}


@pytest.fixture(scope="module")
def tenant_dir(world, tmp_path_factory):
    """Two tenants exported by the JAX package (the reference's seeds); both
    packages' banks load them from here."""
    jmodel = world[0]
    directory = tmp_path_factory.mktemp("tenants")
    for i, (tid, m) in enumerate(zip(TENANTS, METHODS)):
        prof = JaxPEFT(**_profile_kw()[m])
        tree = jax_peft.init_adapters(jax.random.PRNGKey(10 + i),
                                      jmodel.sites, prof)
        tree = jax.tree.map(
            lambda x: x + 0.05 if jnp.issubdtype(x.dtype, jnp.floating)
            else x, tree)
        trainable = set(jax_adapter_api.resolve(m).trainable_leaves(prof))
        tree = {s: {k: v for k, v in d.items() if k in trainable}
                for s, d in tree.items()}
        jax_ckpt.export_adapter(str(directory), tid, tree, prof)
    return str(directory)


def _req(prompt, max_new, priority="batch", adapter_id=None):
    return Request(prompt=torch.tensor(prompt, dtype=torch.int32),
                   max_new=max_new, priority=priority, adapter_id=adapter_id)


def _jreq(prompt, max_new, priority="batch", adapter_id=None):
    return JaxRequest(prompt=jnp.asarray(prompt, jnp.int32), max_new=max_new,
                      priority=priority, adapter_id=adapter_id)


def _jserial(engine, req):
    if req.adapter_id is not None and \
            req.adapter_id not in engine.bank.resident_ids:
        engine.bank.load_from_checkpoint(req.adapter_id)
    out = engine.generate([req.prompt], max_new=req.max_new,
                          adapter_ids=[req.adapter_id]
                          if engine.bank is not None else None)[0]
    return [int(t) for t in np.asarray(out).reshape(-1)]


def _assert_clean(sched):
    """Post-drain invariants: no leaked pages, slots, pins or snapshots."""
    assert not sched.slots.any_active()
    if sched.pager is not None:
        sched.pager.assert_no_leaks()
    if sched.host_kv is not None:
        assert not sched.host_kv._snapshots
    if sched.bank is not None:
        assert all(a is None for a in sched.slots.adapter_ids())


def _steady(summary):
    return {k: v for k, v in summary.items() if k not in WALL_KEYS}


def _run_both(world, trace, tiering, pool, slots=3, max_len=48,
              drafter=None, bank_dir=None, capacity=3):
    """Serve `trace` ((prompt, max_new, priority, adapter_id) rows and their
    arrivals) through JAX's tiered scheduler and the port's on the same
    params, tenants and TieringConfig; hold the port's streams to JAX's
    scheduler's and serial engine's and its summary to JAX's. Returns the
    port's scheduler."""
    jmodel, jparams, model, params = world
    rows, arrivals = trace
    jbank = bank = None
    if bank_dir is not None:
        jbank = JaxBank(jmodel, {m: JaxPEFT(**kw)
                                 for m, kw in _profile_kw().items()},
                        capacity=capacity, checkpoint_dir=bank_dir)
        bank = AdapterBank(model, {m: PEFTConfig(**kw)
                                   for m, kw in _profile_kw().items()},
                           capacity=capacity, checkpoint_dir=bank_dir,
                           device="cpu")
    jeng = JaxEngine(jmodel, jparams, batch_slots=slots, max_len=max_len,
                     bank=jbank)
    eng = Engine(model, params, batch_slots=slots, max_len=max_len,
                 bank=bank, device="cpu")
    jsched = JaxScheduler(jeng, tiering=JaxTiering(**tiering),
                          drafter=JaxNGram(k=drafter) if drafter else None,
                          **pool)
    sched = ContinuousScheduler(eng, tiering=TieringConfig(**tiering),
                                drafter=NGramDrafter(k=drafter)
                                if drafter else None, **pool)
    jreqs = [_jreq(*r) for r in rows]
    reqs = [_req(*r) for r in rows]
    jsched.serve(jreqs, arrivals)
    sched.serve(reqs, arrivals)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    # before the serial runs: their bank loads spill into JAX's tier
    assert _steady(sched.metrics.summary()) \
        == _steady(jsched.metrics.summary())
    for r in jreqs:
        assert r.out == _jserial(jeng, r)
    _assert_clean(sched)
    return sched


# ---- queue ordering ---------------------------------------------------------
class TestPriorityQueue:
    def test_priority_classes_order_every_policy(self):
        for policy in RequestQueue.POLICIES:
            q = RequestQueue(policy)
            q.push(_req([1], 1, "best_effort"), arrival=0.0)
            q.push(_req([2], 1, "interactive"), arrival=0.0)
            q.push(_req([3], 1, "batch"), arrival=0.0)
            got = [q.pop_next(0.0, lambda sr: True).request.priority
                   for _ in range(3)]
            assert got == ["interactive", "batch", "best_effort"], policy

    def test_single_class_keeps_pre_tiering_order(self):
        q = RequestQueue("fcfs")
        rids = [q.push(_req([i], 1), arrival=float(i % 2)) for i in range(6)]
        got = [q.pop_next(5.0, lambda sr: True).rid for _ in range(6)]
        assert got == sorted(rids, key=lambda r: (r % 2 == 1, r))

    def test_fair_share_prefers_quiet_tenant(self):
        q = RequestQueue("fair")
        q.push(_req([1], 1, adapter_id="chatty"), arrival=0.0)
        q.push(_req([2], 1, adapter_id="quiet"), arrival=0.0)
        q.note_usage("chatty", 100)
        q.note_usage("quiet", 3)
        assert q.peek_next(0.0).request.adapter_id == "quiet"
        q.push(_req([3], 1, "interactive", adapter_id="chatty"), arrival=0.0)
        assert q.peek_next(0.0).request.priority == "interactive"

    def test_usage_tracked_only_under_fair_policy(self):
        for policy in ("fcfs", "resident_first"):
            q = RequestQueue(policy)
            q.note_usage("tenant", 5)
            assert q.usage("tenant") == 0 and not q._usage, policy

    def test_fair_usage_decays_and_stays_bounded(self):
        q = RequestQueue("fair")
        q.note_usage("quiet", 1)
        q.note_usage("chatty", q.USAGE_HALF_AT)
        assert q.usage("chatty") == q.USAGE_HALF_AT // 2
        assert q.usage("quiet") == 0
        assert "quiet" not in q._usage

    def test_requeue_keeps_rid_and_position(self):
        q = RequestQueue("fcfs")
        r0 = q.push(_req([1], 1), arrival=0.0)
        q.push(_req([2], 1), arrival=5.0)
        sr = q.pop_next(9.0, lambda sr: True)
        assert sr.rid == r0
        q.requeue(sr)
        nxt = q.peek_next(9.0)
        assert nxt.rid == r0 and nxt is sr

    def test_unknown_priority_rejected_at_submit(self, world):
        _, _, model, params = world
        eng = Engine(model, params, batch_slots=2, max_len=32, device="cpu")
        sched = ContinuousScheduler(eng)
        with pytest.raises(ValueError, match="priority"):
            sched.submit(_req([1, 2], 2, priority="urgent"))

    def test_one_definition_of_the_classes(self):
        """The queue and the runtime take the classes from
        serve/tiering/config.py, the module the gateway validates with."""
        from repro_torch.serve.gateway import protocol
        from repro_torch.serve.scheduler import queue, runtime
        from repro_torch.serve.tiering import config
        assert queue.priority_rank is config.priority_rank
        assert runtime.PRIORITIES is config.PRIORITIES
        assert protocol.PRIORITIES is config.PRIORITIES
        assert not hasattr(queue, "PRIORITIES")


# ---- host tiers (unit) ------------------------------------------------------
class TestHostPools:
    def _page(self, tag):
        k = torch.full((2, 1, 4, 2, 3), float(tag))
        return k, -k

    def test_prefix_lru_and_capacity(self):
        pool = HostPagePool(capacity_pages=2)
        for i in range(3):
            assert pool.put_prefix(bytes([i]), *self._page(i))
        assert not pool.has_prefix(b"\x00")
        assert pool.has_prefix(b"\x01") and pool.has_prefix(b"\x02")
        k, _ = pool.get_prefix(b"\x01")
        assert float(k[0, 0, 0, 0, 0]) == 1.0
        assert pool.put_prefix(bytes([9]), *self._page(9))
        assert pool.has_prefix(b"\x01")
        assert not pool.has_prefix(b"\x02")

    def test_touch_prefix_refreshes_lru(self):
        pool = HostPagePool(capacity_pages=2)
        assert pool.put_prefix(b"a", *self._page(1))
        assert pool.put_prefix(b"b", *self._page(2))
        assert pool.touch_prefix(b"a")
        assert not pool.touch_prefix(b"nope")
        assert pool.put_prefix(b"c", *self._page(3))
        assert pool.has_prefix(b"a")
        assert not pool.has_prefix(b"b")

    def test_snapshots_are_pinned_and_charged(self):
        pool = HostPagePool(capacity_pages=3)
        k = torch.zeros((2, 2, 4, 2, 3))
        assert pool.put_snapshot(7, k, k.clone(), n_pages=1)
        assert pool.used_pages == 2
        assert pool.put_prefix(b"p", *self._page(1))
        assert not pool.put_snapshot(8, k, k.clone(), n_pages=2)
        with pytest.raises(KeyError):
            pool.put_snapshot(7, k, k.clone(), n_pages=1)
        _, _, n = pool.pop_snapshot(7)
        assert n == 1 and pool.used_pages == 1
        assert not pool.has_snapshot(7)
        assert pool.put_snapshot(9, k, k.clone(), n_pages=2)
        assert pool.drop_snapshot(9) and not pool.drop_snapshot(9)
        assert pool.used_pages == 1

    def test_adapter_tier_spill_callback_and_lru(self):
        spills = []
        tier = HostAdapterTier(2, on_spill=lambda: spills.append(1))
        for i, aid in enumerate(("a", "b", "c")):
            tier.put(aid, "lora", {"s": {"w": torch.full((2,), float(i))}})
            assert len(spills) == i + 1
        assert "a" not in tier and len(tier) == 2
        method, tree = tier.get("b")
        assert method == "lora" and float(tree["s"]["w"][0]) == 1.0
        assert tier.drop("b") and "b" not in tier


# ---- victim/mode policy (unit) ---------------------------------------------
class TestPreemptPolicy:
    def test_victim_strictly_lower_class_only(self):
        occ = [VictimInfo(0, 1, 8, 4, 2), VictimInfo(1, 1, 8, 9, 2)]
        assert choose_victim(0, occ).slot == 0
        assert choose_victim(1, occ) is None

    def test_mode_forcing_and_swap_requires_host(self):
        v = VictimInfo(0, 1, 8, 4, 2)
        cfg = TieringConfig(mode="swap", host_kv_pages=8)
        assert choose_mode(cfg, v, 8, host_can_swap=True) == "swap"
        assert choose_mode(cfg, v, 8, host_can_swap=False) == "recompute"
        cfg = TieringConfig(mode="recompute")
        assert choose_mode(cfg, v, 8, host_can_swap=True) == "recompute"
        with pytest.raises(ValueError, match="mode"):
            TieringConfig(mode="sometimes")

    def test_auto_mode_tracks_cost_estimate(self):
        cheap_swap = VictimInfo(0, 1, prompt_len=100, emitted=100,
                                used_pages=1)
        cheap_recompute = VictimInfo(0, 1, prompt_len=2, emitted=1,
                                     used_pages=8)
        cfg = TieringConfig(host_kv_pages=64)
        assert choose_mode(cfg, cheap_swap, 8, True) == "swap"
        assert choose_mode(cfg, cheap_recompute, 8, True) == "recompute"

    @pytest.mark.parametrize("mode", ["auto", "swap", "recompute"])
    def test_verdicts_equal_the_reference(self, mode):
        """On a grid of occupants and candidates, the port's victim and mode
        are JAX's."""
        rng = np.random.default_rng(3)
        for _ in range(60):
            rows = [(s, int(rng.integers(0, 4)), int(rng.integers(1, 40)),
                     int(rng.integers(0, 40)), int(rng.integers(1, 8)))
                    for s in range(int(rng.integers(1, 6)))]
            cand = int(rng.integers(0, 3))
            mine = choose_victim(cand, [VictimInfo(*r) for r in rows])
            ref = jax_choose_victim(cand, [JaxVictim(*r) for r in rows])
            assert (mine is None) == (ref is None)
            if mine is None:
                continue
            assert mine.slot == ref.slot
            for host in (True, False):
                assert choose_mode(TieringConfig(mode=mode), mine, 8, host) \
                    == jax_choose_mode(JaxTiering(mode=mode), ref, 8, host)


# ---- preempt-and-resume exactness ------------------------------------------
# pool sizing: 3 slots, pps=6 -> 9 pages total, 6 allocatable; each batch
# long (5 prompt + 20 new -> 24 positions) owns 3 pages, so two longs own
# the entire pool and any interactive arrival must preempt to run
POOL = dict(page_size=8, n_pages=9)


def _overload_trace(n_interactive=3, adapter_ids=(None, None, None)):
    rows = [([1, 2, 3, 4, 5], 20, "batch", adapter_ids[0]),
            ([7, 8, 9], 18, "batch", adapter_ids[1])]
    arrivals = [0.0, 0.0]
    for i in range(n_interactive):
        rows.append(([11 + i, 12], 4, "interactive", adapter_ids[2]))
        arrivals.append(3.0 + 4.0 * i)
    return rows, arrivals


class TestPreemptExactness:
    def test_swap_resume_bit_identical(self, world):
        s = _run_both(world, _overload_trace(),
                      dict(mode="swap", host_kv_pages=32), POOL
                      ).metrics.summary()
        assert s["preempt_swap_total"] >= 1
        assert s["resumed_total"] >= 1
        assert s["kv_pages_spilled_total"] >= 1
        assert s["kv_pages_filled_total"] >= 1

    def test_recompute_resume_bit_identical(self, world):
        s = _run_both(world, _overload_trace(), dict(mode="recompute"),
                      POOL).metrics.summary()
        assert s["preempt_recompute_total"] >= 1
        assert s["resumed_total"] >= 1
        assert s["kv_pages_spilled_total"] == 0

    def test_auto_resume_bit_identical(self, world):
        s = _run_both(world, _overload_trace(),
                      dict(mode="auto", host_kv_pages=32), POOL
                      ).metrics.summary()
        assert s["preemptions_total"] >= 1
        assert s["resumed_total"] >= 1

    def test_swap_degrades_to_recompute_when_host_full(self, world):
        rows = [([1, 2, 3, 4, 5], 20, "batch", None),
                ([7, 8, 9], 18, "batch", None),
                ([11, 12], 4, "interactive", None)]
        s = _run_both(world, (rows, [0.0, 0.0, 12.0]),
                      dict(mode="swap", host_kv_pages=1), POOL
                      ).metrics.summary()
        assert s["preemptions_total"] >= 1
        assert s["preempt_recompute_total"] >= 1

    def test_heterogeneous_tenants_preempt_exact(self, world, tenant_dir):
        trace = _overload_trace(
            adapter_ids=("tenant-fft", None, "tenant-lora"))
        sched = _run_both(world, trace, dict(host_kv_pages=32), POOL,
                          bank_dir=tenant_dir)
        assert sched.metrics.summary()["preemptions_total"] >= 1

    def test_speculative_preempt_exact(self, world):
        sched = _run_both(world, _overload_trace(),
                          dict(mode="swap", host_kv_pages=32), POOL,
                          drafter=3)
        assert sched.metrics.summary()["preemptions_total"] >= 1

    def test_preemption_storm_no_leaks(self, world):
        s = _run_both(world, _overload_trace(n_interactive=8),
                      dict(host_kv_pages=4), POOL).metrics.summary()
        assert s["preemptions_total"] >= 2
        assert s["requests_finished_total"] == 10

    def test_self_drafter_preempt_matches_the_plain_run(self, world):
        """The self-drafter probes through the slots' pages: a preempted,
        swapped and resumed slot drafts from the restored pages, and the
        streams stay the unpreempted plain scheduler's."""
        _, _, model, params = world
        eng = Engine(model, params, batch_slots=3, max_len=48, device="cpu")
        rows, arrivals = _overload_trace()
        plain = [_req(*r) for r in rows]
        ContinuousScheduler(eng).serve(plain, arrivals)
        reqs = [_req(*r) for r in rows]
        sched = ContinuousScheduler(
            eng, drafter=SelfDrafter(k=3),
            tiering=TieringConfig(mode="swap", host_kv_pages=32), **POOL)
        sched.serve(reqs, arrivals)
        assert [r.out for r in reqs] == [r.out for r in plain]
        assert sched.metrics.summary()["preempt_swap_total"] >= 1
        _assert_clean(sched)

    def test_swap_fill_restores_spilled_pages_bitwise(self, world):
        """Read the pool right after each swap-resume's fill: the filled
        pages are bitwise the pages the preemption gathered."""
        _, _, model, params = world
        eng = Engine(model, params, batch_slots=3, max_len=48, device="cpu")
        sched = ContinuousScheduler(
            eng, tiering=TieringConfig(mode="swap", host_kv_pages=32), **POOL)
        spilled, checked = {}, []
        real_fill = sched._fill_pages
        real_put = sched.host_kv.put_snapshot

        def put(rid, k, v, n):
            spilled[rid] = (k.clone(), v.clone(), n)
            return real_put(rid, k, v, n)

        def fill(k, v, idx):
            real_fill(k, v, idx)
            for rid, (sk, sv, n) in spilled.items():
                if sk.shape == k.shape and torch.equal(sk, k):
                    i = torch.as_tensor(idx[:n])
                    assert torch.equal(sched.cache["pk"][:, i], sk[:, :n])
                    assert torch.equal(sched.cache["pv"][:, i], sv[:, :n])
                    checked.append(rid)

        sched.host_kv.put_snapshot = put
        sched._fill_pages = fill
        reqs = [_req(*r) for r in _overload_trace()[0]]
        sched.serve(reqs, _overload_trace()[1])
        assert checked and set(checked) <= set(spilled)
        _assert_clean(sched)


class TestTieredThroughput:
    def test_tiered_admits_strictly_more_within_horizon(self, world):
        """Under the constrained pool, preempt-and-resume admits strictly
        more requests inside a fixed step horizon than deferral-only
        scheduling of the same trace — and as many as JAX's."""
        jmodel, jparams, model, params = world
        eng = Engine(model, params, batch_slots=3, max_len=48, device="cpu")
        jeng = JaxEngine(jmodel, jparams, batch_slots=3, max_len=48)
        horizon = 15.0
        admits = {}
        for name, tiering in (("deferral", None),
                              ("tiered", dict(host_kv_pages=32))):
            for pkg, e, mk_req, sched_cls, cfg_cls in (
                    ("torch", eng, _req, ContinuousScheduler,
                     TieringConfig),
                    ("jax", jeng, _jreq, JaxScheduler, JaxTiering)):
                sched = sched_cls(e, tiering=cfg_cls(**tiering)
                                  if tiering else None, **POOL)
                rows, arrivals = _overload_trace()
                reqs = [mk_req(*r) for r in rows]
                for r, at in zip(reqs, arrivals):
                    sched.submit(r, arrival=at)
                admits[name, pkg] = sum(
                    1 for ev in sched.events()
                    if ev[0] == "admit" and ev[-1] <= horizon)
                if pkg == "torch":
                    _assert_clean(sched)
        assert admits["tiered", "torch"] > admits["deferral", "torch"]
        assert admits["tiered", "torch"] == admits["tiered", "jax"]
        assert admits["deferral", "torch"] == admits["deferral", "jax"]


# ---- host tiers through the runtime ----------------------------------------
class TestHostTierRuntime:
    def test_adapter_rows_spill_and_refill_from_host(self, world, tenant_dir):
        """Capacity-1 bank, two tenants arriving serially: the LRU victim
        spills to the host tier, and the tenant's return admission refills
        from it (a hit, not a checkpoint re-read)."""
        rows = [([1, 2, 3], 4, "batch", "tenant-fft"),
                ([4, 5, 6], 4, "batch", "tenant-lora"),
                ([1, 2, 3], 4, "batch", "tenant-fft")]
        s = _run_both(world, (rows, [0.0, 30.0, 60.0]),
                      dict(host_adapter_slots=4, preempt=False),
                      dict(page_size=8), slots=2, bank_dir=tenant_dir,
                      capacity=1).metrics.summary()
        assert s["adapter_spills_total"] >= 1
        assert s["adapter_host_hits_total"] >= 1

    def test_prefix_pages_demote_to_host_and_promote_back(self, world):
        shared = list(range(1, 10))
        rows = [(shared, 4, "batch", None),
                ([21, 22, 23, 24, 25], 24, "batch", None),
                (shared, 4, "batch", None)]
        sched = _run_both(world, (rows, [0.0, 20.0, 60.0]),
                          dict(host_kv_pages=16),
                          dict(page_size=4, n_pages=10), slots=2,
                          max_len=32)
        s = sched.metrics.summary()
        assert s["kv_pages_spilled_total"] >= 1
        assert s["prefix_host_hits_total"] >= 1
        assert s["kv_pages_filled_total"] >= 1

    def test_fill_displaced_by_own_demotions_degrades_exact(self, world):
        shared = list(range(1, 10))
        rows = [(shared, 4, "batch", None),
                ([21, 22, 23, 24, 25], 4, "batch", None),
                (shared, 4, "batch", None)]
        s = _run_both(world, (rows, [0.0, 20.0, 60.0]),
                      dict(host_kv_pages=1, preempt=False),
                      dict(page_size=4, n_pages=5), slots=2,
                      max_len=12).metrics.summary()
        assert s["kv_fills_degraded_total"] >= 1
        assert s["kv_pages_spilled_total"] >= 1

    def test_evicted_rows_reload_bitwise_the_checkpoint(self, world,
                                                        tenant_dir):
        """An evicted tenant's rows come back from the host tier bitwise
        the checkpoint's. The bank must clone a row before it clears the
        slot: a view of the row would spill the zeros the clear writes."""
        _, _, model, _ = world
        bank = AdapterBank(model, {m: PEFTConfig(**kw)
                                   for m, kw in _profile_kw().items()},
                           capacity=1, checkpoint_dir=tenant_dir,
                           device="cpu")
        bank.host_tier = HostAdapterTier(4)
        bank.load_from_checkpoint("tenant-fft")
        bank.load_from_checkpoint("tenant-lora")       # evicts tenant-fft
        assert "tenant-fft" in bank.host_tier
        _, tree = bank.host_tier.get("tenant-fft")
        ckpt, _ = adapter_ckpt.import_adapter(tenant_dir, "tenant-fft",
                                              device="cpu")
        for site, leaves in ckpt.items():
            for leaf, v in leaves.items():
                assert torch.equal(tree[site][leaf], v), (site, leaf)
                assert bool(v.abs().sum() > 0)
        assert bank.load_from_host("tenant-fft") is not None
        assert "tenant-fft" not in bank.host_tier      # a load supersedes
        _, slot = bank._resident["tenant-fft"]
        rows = bank.params["fourierft"]["sites"]
        for site, leaves in ckpt.items():
            for leaf, v in leaves.items():
                assert torch.equal(rows[site][leaf][slot], v)
        assert bank.load_from_host("tenant-fft-missing") is None


# ---- scheduler lifetime -----------------------------------------------------
@pytest.mark.parametrize("kind", ["plain", "drafter", "tiering"])
def test_dropped_scheduler_frees_its_pool(world, tenant_dir, kind):
    """With the cyclic garbage collector off, `del` of a scheduler that has
    served a trace frees its page pool: the hooks it hands to objects it
    owns (on_release, the drafter's back-reference, on_evict, on_spill)
    hold it weakly."""
    _, _, model, params = world
    bank = None
    kw = {}
    if kind == "drafter":
        kw["drafter"] = SelfDrafter(k=2)
    if kind == "tiering":
        bank = AdapterBank(model, {m: PEFTConfig(**p)
                                   for m, p in _profile_kw().items()},
                           capacity=1, checkpoint_dir=tenant_dir,
                           device="cpu")
        kw["tiering"] = TieringConfig(host_kv_pages=8, host_adapter_slots=2)
    eng = Engine(model, params, batch_slots=3, max_len=48, bank=bank,
                 device="cpu")
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        sched = ContinuousScheduler(eng, **kw, **POOL)
        ids = ("tenant-fft", "tenant-lora") if bank is not None else (None,)
        rows, arrivals = _overload_trace(adapter_ids=(ids[0], None, ids[-1]))
        sched.serve([_req(*r) for r in rows], arrivals)
        pool = weakref.ref(sched.cache["pk"])
        alive = weakref.ref(sched)
        del sched
        assert alive() is None and pool() is None
        if bank is not None:       # the tier's hook outlives it harmlessly
            bank.load_from_checkpoint("tenant-fft")
    finally:
        if was_enabled:
            gc.enable()


# ---- the launcher -----------------------------------------------------------
def test_launcher_preempts_on_the_cpu(capsys):
    """`--preempt` with a constrained pool and interactive requests in the
    trace: the launcher prints the preemption counters, and every request's
    stream is the one the same trace gets without tiering."""
    common = ["--arch", "yi-6b", "--reduced", "--continuous", "--page-size",
              "8", "--max-len", "64", "--arrival-every", "1", "--trace-n",
              "6", "--interactive-every", "3", "--device", "cpu"]
    launch_serve.main(common)
    plain = capsys.readouterr().out
    launch_serve.main(common + ["--preempt", "--preempt-mode", "swap",
                                "--n-pages", "10", "--host-kv-pages", "16"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("tiering:"))
    counts = dict(tok.split("=") for tok in line.split()[1:])
    assert int(counts["preemptions"]) >= 1
    assert int(counts["preempt_swap"]) >= 1
    assert int(counts["resumed"]) >= 1
    assert int(counts["kv_pages_spilled"]) >= 1

    def streams(text):
        return [ln for ln in text.splitlines() if ln.startswith("request ")]
    assert len(streams(out)) == 6
    assert streams(out) == streams(plain)
