"""The port's speculative decoding (draft-then-verify) and dense per-slot
cache against the JAX package and against the port's own plain loop, on a
reduced yi-6b (vocab 64, f32, CPU).

Every case of tests/test_serve_spec.py, run on the port:
- window accounting (`SlotManager.note_window`) and the n-gram lookup;
- greedy speculative streams token-identical to the plain scheduler and to
  JAX's serial `Engine.generate` — self-drafter on the paged and the dense
  cache, the n-gram drafter, EOS inside a window, and mixed tenants
  (fourierft, lora, None) over the adapter bank with the self-drafter;
- the acceptance counters, and the buffered EOS of the plain loop.

Parity with JAX on the same converted params, cache and drafts:
- `verify_step` tokens equal JAX's and the written K/V within atol 1e-4
  (the decode tolerance of tests/test_torch_serve.py), paged (the plain
  paged attention) and dense, with windows past a slot's owned pages and
  past the block table;
- `write_slot_cache` and `advance_pos` equal JAX's exactly.

Within the port: `verify_logits` equals W sequential `decode_logits`
within atol 1e-5 (f32), a window that runs past max_len keeps the
streams, a verify step makes exactly one device-to-host transfer, and the
launcher serves `--speculative --drafter ngram --dense-cache` on the CPU.

JAX's serial `Engine.generate` is the stream reference, not its continuous
scheduler (ROADMAP, notes on the reference)."""
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
from repro.models import transformer as jax_tf
from repro.serve import AdapterBank as JaxBank
from repro.serve import Engine as JaxEngine
from repro_torch import configs
from repro_torch.configs.base import PEFTConfig
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build
from repro_torch.models import transformer as tf
from repro_torch.serve import (
    AdapterBank, ContinuousScheduler, Engine, NGramDrafter, Request,
    SelfDrafter, TieringConfig,
)
from repro_torch.serve.scheduler.slots import SlotManager

MAX_LEN = 48
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12], [3, 1, 4, 1, 5, 9],
           [2, 7, 1, 8], [6, 6, 6], [9, 8, 7, 6, 5, 4, 3], [5, 5]]


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


def _stream(tokens):
    return [int(t) for t in np.asarray(tokens).reshape(-1)]


def _cut(stream, eos_id):
    if eos_id is not None and eos_id in stream:
        return stream[:stream.index(eos_id) + 1]
    return stream


@pytest.fixture(scope="module")
def jax_serial(world):
    """stream(prompt, max_new, eos_id=None): JAX's serial Engine.generate
    for one prompt, cut at its first EOS. Greedy streams are prefixes of
    each other, so each prompt is generated once at the longest budget."""
    jmodel, jparams, _, _ = world
    eng = JaxEngine(jmodel, jparams, batch_slots=3, max_len=MAX_LEN)
    memo = {}

    def stream(prompt, max_new, eos_id=None):
        key = tuple(int(t) for t in prompt)
        if len(memo.get(key, ())) < max_new:
            memo[key] = _stream(eng.generate(
                [jnp.asarray(key, jnp.int32)], max_new=max(max_new, 10))[0])
        return _cut(memo[key][:max_new], eos_id)

    return stream


def _engine(world, slots=3, bank=None):
    _, _, model, params = world
    return Engine(model, params, batch_slots=slots, max_len=MAX_LEN,
                  bank=bank, device="cpu")


def _trace(max_news, adapter_ids=None):
    return [Request(prompt=torch.tensor(PROMPTS[i % len(PROMPTS)],
                                        dtype=torch.int32),
                    max_new=mn,
                    adapter_id=adapter_ids[i] if adapter_ids else None)
            for i, mn in enumerate(max_news)]


def _serve(eng, reqs, arrivals=None, **kw):
    sched = ContinuousScheduler(eng, page_size=8, **kw)
    sched.serve(reqs, arrivals)
    assert sched._pending == []
    return sched


# ---------------------------------------------------------------------------
# unit: window accounting + drafters
# ---------------------------------------------------------------------------

class TestNoteWindow:
    def test_budget_clamps_inside_window(self):
        slots = SlotManager(2)
        slots.acquire(0, budget=3)
        assert slots.note_window(0, [5, 6, 7, 8, 9]) == (3, True)

    def test_eos_clamps_inside_window(self):
        slots = SlotManager(2, eos_id=7)
        slots.acquire(0, budget=10)
        assert slots.note_window(0, [5, 7, 6, 6]) == (2, True)
        slots.release(0)

    def test_full_window_not_done(self):
        slots = SlotManager(1, eos_id=7)
        slots.acquire(0, budget=10)
        assert slots.note_window(0, [1, 2, 3]) == (3, False)
        assert slots.state(0).budget == 7
        assert slots.state(0).taken == 3

    def test_window_is_n_sequential_note_tokens(self):
        a, b = SlotManager(1, eos_id=9), SlotManager(1, eos_id=9)
        a.acquire(0, budget=5)
        b.acquire(0, budget=5)
        a.note_window(0, [1, 2, 3])
        for t in [1, 2, 3]:
            b.note_token(0, t)
        assert a.state(0) == b.state(0)

    def test_empty_window_rejected(self):
        slots = SlotManager(1)
        slots.acquire(0, budget=5)
        with pytest.raises(ValueError):
            slots.note_window(0, [])


class TestNGramDrafter:
    def _drafter(self, k=4, ngram=3):
        d = NGramDrafter(k=k, ngram=ngram)
        d.bind(None)
        return d

    def test_lookup_continues_most_recent_match(self):
        d = self._drafter()
        assert d._lookup([1, 2, 3, 9, 8, 7, 6, 1, 2, 3]) == [9, 8, 7, 6]

    def test_lookup_prefers_recent_occurrence(self):
        d = self._drafter(k=1)
        assert d._lookup([5, 2, 0, 5, 4, 5]) == [4]

    def test_lookup_falls_back_to_shorter_ngram(self):
        d = self._drafter(k=2, ngram=3)
        assert d._lookup([4, 8, 1, 2, 3, 4]) == [8, 1]

    def test_lookup_pads_short_continuation(self):
        d = self._drafter(k=4, ngram=2)
        assert d._lookup([1, 2, 7, 1, 2]) == [7, 1, 2, 2]

    def test_no_match_repeats_last_token(self):
        d = self._drafter(k=3)
        assert d._lookup([1, 2, 3]) == [3, 3, 3]

    def test_history_lifecycle(self):
        d = self._drafter(k=2)
        d.on_prime(1, np.array([1, 2, 3]), 4)
        d.on_tokens(1, [5, 6])
        assert d._hist[1] == [1, 2, 3, 4, 5, 6]
        d.on_release(1)
        assert 1 not in d._hist

    def test_history_capped(self):
        d = NGramDrafter(k=2, max_history=8)
        d.bind(None)
        d.on_prime(0, np.arange(6), 6)
        d.on_tokens(0, list(range(7, 12)))
        assert len(d._hist[0]) == 8
        assert d._hist[0][-1] == 11

    def test_invalid_params(self):
        with pytest.raises(ValueError):
            NGramDrafter(k=0)
        with pytest.raises(ValueError):
            NGramDrafter(ngram=0)
        with pytest.raises(ValueError):
            SelfDrafter(k=0)


# ---------------------------------------------------------------------------
# exactness: speculative == plain scheduler == JAX serial
# ---------------------------------------------------------------------------

class TestSpecExactness:
    @pytest.mark.parametrize("paged", [True, False])
    def test_self_drafter_token_identical(self, world, jax_serial, paged):
        """Greedy speculative output is token-identical to the plain
        scheduler on the staggered trace, paged and dense, and to JAX's
        serial engine."""
        eng = _engine(world)
        arrivals = [0, 0, 1, 2, 3, 5, 8, 9]
        budgets = [4, 7, 2, 5, 1, 6, 3, 8]
        base = _trace(budgets)
        _serve(eng, base, arrivals, paged=paged)
        spec = _trace(budgets)
        _serve(eng, spec, arrivals, paged=paged, drafter=SelfDrafter(k=3))
        assert [r.out for r in spec] == [r.out for r in base]
        for r in spec:
            assert r.out == jax_serial(r.prompt.tolist(), r.max_new)

    def test_ngram_drafter_token_identical(self, world, jax_serial):
        eng = _engine(world)
        budgets = [6, 4, 8, 3, 5]
        base = _trace(budgets)
        _serve(eng, base)
        spec = _trace(budgets)
        _serve(eng, spec, drafter=NGramDrafter(k=4))
        assert [r.out for r in spec] == [r.out for r in base]
        for r in spec:
            assert r.out == jax_serial(r.prompt.tolist(), r.max_new)

    def test_spec_with_eos_token_identical(self, world, jax_serial):
        """EOS anywhere inside the verify window truncates exactly like the
        per-token loop: learn a token the trace emits, replay with it as
        eos_id on both paths."""
        eng = _engine(world, slots=2)
        probe = _trace([8, 8])
        _serve(eng, probe)
        eos = probe[0].out[3]
        base = _trace([8, 8, 8, 8])
        _serve(eng, base, eos_id=eos)
        spec = _trace([8, 8, 8, 8])
        _serve(eng, spec, eos_id=eos, drafter=SelfDrafter(k=3))
        assert [r.out for r in spec] == [r.out for r in base]
        assert any(len(r.out) < 8 for r in spec)   # EOS actually truncated
        for r in spec:
            assert r.out == jax_serial(r.prompt.tolist(), 8, eos)

    def test_heterogeneous_adapters_spec_token_identical(self, world,
                                                         tmp_path):
        """Mixed tenants (fourierft + lora + the bare base) under the self
        drafter: drafts come from the zero bank row, verify gathers each
        slot's tenant row. Every stream equals JAX's serial engine over a
        JAX bank of the same exports, and the port's serial engine."""
        jmodel, jparams, model, _ = world
        kws = {"fourierft": dict(n=16, alpha=25.0), "lora": dict(lora_r=2)}
        for i, (tid, m) in enumerate(zip(("tenant-fft", "tenant-lora"),
                                         ("fourierft", "lora"))):
            prof = JaxPEFT(method=m, param_dtype="float32", **kws[m])
            tree = jax_peft.init_adapters(jax.random.PRNGKey(10 + i),
                                          jmodel.sites, prof)
            tree = jax.tree.map(
                lambda x: x + 0.05 if jnp.issubdtype(x.dtype, jnp.floating)
                else x, tree)
            trainable = set(jax_adapter_api.resolve(m).trainable_leaves(prof))
            tree = {s: {k: v for k, v in d.items() if k in trainable}
                    for s, d in tree.items()}
            jax_ckpt.export_adapter(str(tmp_path), tid, tree, prof)
        bank = AdapterBank(model, {m: PEFTConfig(method=m,
                                                 param_dtype="float32",
                                                 **kws[m]) for m in kws},
                           capacity=4, checkpoint_dir=str(tmp_path),
                           device="cpu")
        eng = _engine(world, bank=bank)
        ids = ["tenant-fft", "tenant-lora", None, "tenant-fft",
               "tenant-lora", None]
        reqs = _trace([5, 3, 6, 2, 4, 3], adapter_ids=ids)
        _serve(eng, reqs, [0, 0, 0, 1, 3, 4], drafter=SelfDrafter(k=3))
        jbank = JaxBank(jmodel, {m: JaxPEFT(method=m, param_dtype="float32",
                                            **kws[m]) for m in kws},
                        capacity=4, checkpoint_dir=str(tmp_path))
        jeng = JaxEngine(jmodel, jparams, batch_slots=3, max_len=MAX_LEN,
                         bank=jbank)
        moved = 0
        for r in reqs:
            for b in (jbank, bank):
                if r.adapter_id is not None and \
                        r.adapter_id not in b.resident_ids:
                    b.load_from_checkpoint(r.adapter_id)
            jout = _stream(jeng.generate(
                [jnp.asarray(r.prompt.numpy())], max_new=r.max_new,
                adapter_ids=[r.adapter_id])[0])
            tout = _stream(eng.generate([r.prompt], max_new=r.max_new,
                                        adapter_ids=[r.adapter_id])[0])
            assert r.out == jout == tout
            bare = _stream(eng.generate([r.prompt], max_new=r.max_new,
                                        adapter_ids=[None])[0])
            moved += r.out != bare
        assert moved >= 1            # the tenants decode other tokens

    @pytest.mark.parametrize("paged", [True, False])
    def test_window_past_max_len_and_owned_pages(self, world, jax_serial,
                                                 paged):
        """Requests that fill max_len exactly (S + max_new - 1 == max_len),
        k = 4: the last windows run past the slot's owned pages, past the
        block table (paged: into the scratch page) and past the dense
        rows (dropped). Streams equal the plain loop's and JAX's; no page
        leaks."""
        _, _, model, params = world
        eng = Engine(model, params, batch_slots=3, max_len=24, device="cpu")
        budgets = [24 - len(PROMPTS[i]) + 1 for i in range(5)]
        base = _trace(budgets)
        ContinuousScheduler(eng, paged=paged, page_size=8).serve(base)
        spec = _trace(budgets)
        sched = ContinuousScheduler(eng, paged=paged, page_size=8,
                                    drafter=SelfDrafter(k=4))
        sched.serve(spec, [0, 0, 0, 2, 4])
        assert [r.out for r in spec] == [r.out for r in base]
        assert [len(r.out) for r in spec] == budgets
        for r in spec:
            assert r.out == jax_serial(r.prompt.tolist(), r.max_new)
        if paged:
            sched.pager.assert_no_leaks()


# ---------------------------------------------------------------------------
# acceptance counters
# ---------------------------------------------------------------------------

class TestSpecMetrics:
    def test_self_drafter_accepts_more_than_one_per_step(self, world):
        """On base-model traffic the self-drafter's drafts ARE the target's
        argmax: more than 1.0 emitted token per slot-step (only budget and
        EOS clamping reject)."""
        eng = _engine(world)
        sched = _serve(eng, _trace([8, 8, 8, 8, 8, 8]), [0, 0, 0, 1, 2, 3],
                       drafter=SelfDrafter(k=3))
        s = sched.metrics.summary()
        assert s["spec_tokens_per_step"] > 1.0
        assert s["spec_accept_rate"] > 0.5
        assert s["spec_slot_steps"] > 0
        # the histogram totals the emitted tokens; primes emit 1 each
        emitted = sum(n * c for n, c in sched.metrics.accepted_hist.items())
        assert emitted + 6 == s["total_tokens"]

    def test_per_request_accept_rate_recorded(self, world):
        eng = _engine(world, slots=2)
        sched = _serve(eng, _trace([6, 5]), drafter=SelfDrafter(k=2))
        for rm in sched.metrics.requests.values():
            assert rm.drafted > 0
            assert rm.accept_rate is not None
            assert 0.0 <= rm.accept_rate <= 1.0
        assert sched.metrics.summary()["spec_drafts_wasted"] >= 0

    def test_no_spec_counters_without_drafter(self, world):
        eng = _engine(world, slots=2)
        sched = _serve(eng, _trace([3, 2]))
        assert "spec_accept_rate" not in sched.metrics.summary()


# ---------------------------------------------------------------------------
# the buffered EOS of the plain loop
# ---------------------------------------------------------------------------

class TestBufferedEOS:
    def test_eos_traffic_exact_vs_serial_reference(self, world):
        """The buffered loop (device done-flag, drains every eos_sync_every
        steps) truncates exactly where the serial generate_requests EOS
        path does."""
        eng = _engine(world)
        probe = _trace([10])
        _serve(eng, probe)
        eos = probe[0].out[2]
        reqs = _trace([10, 10, 10, 10, 10, 10])
        _serve(eng, reqs, [0, 0, 0, 1, 2, 4], eos_id=eos)
        for r in reqs:
            ref = [Request(prompt=r.prompt, max_new=r.max_new)]
            eng.generate_requests(ref, eos_id=eos)
            assert r.out == ref[0].out

    def test_eos_sync_every_one_matches_default(self, world):
        eng = _engine(world, slots=2)
        probe = _trace([10])
        _serve(eng, probe)
        eos = probe[0].out[2]
        a = _trace([10, 10, 10])
        _serve(eng, a, [0, 0, 3], eos_id=eos, eos_sync_every=1)
        b = _trace([10, 10, 3])
        _serve(eng, b, [0, 0, 3], eos_id=eos, eos_sync_every=4)
        assert [r.out for r in a[:2]] == [r.out for r in b[:2]]

    def test_budget_only_traffic_unaffected_by_buffering(self, world):
        eng = _engine(world, slots=2)
        reqs = _trace([4, 6, 3, 5])
        sched = _serve(eng, reqs, [0, 0, 2, 3])
        assert all(r.out is not None for r in reqs)
        m = sched.metrics
        for rm in m.requests.values():
            assert rm.finished is not None
            assert rm.first_token is not None
        assert m.total_tokens == sum(len(r.out) for r in reqs)


# ---------------------------------------------------------------------------
# parity with JAX: verify_step, write_slot_cache, advance_pos
# ---------------------------------------------------------------------------

PS, PPS, W = 8, 4, 5


def _paged_setup(cfg, rng):
    """A 3-slot page pool of seeded random K/V and a verify window per
    slot: slot 0 well inside its pages, slot 1 running past its 2 owned
    pages (table entries 2, 3 are its scratch page 1), slot 2 running
    past the table (positions 32..34 go to its scratch page 2)."""
    B = 3
    n_pages = B + B * PPS
    shape = (cfg.num_layers, n_pages, PS, cfg.n_kv, cfg.head_dim)
    pk, pv = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    bt = (B + np.arange(B * PPS, dtype=np.int32).reshape(B, PPS))
    bt[1, 2:] = 1
    pos = np.array([5, 14, 30], np.int32)
    tokens = rng.integers(0, 64, size=(B, W)).astype(np.int32)
    return pk, pv, bt, pos, tokens


def _paged_writes(bt, pos):
    """{(page, offset)} the verify windows may write."""
    out = set()
    for b, p in enumerate(pos):
        for j in range(W):
            q = int(p) + j
            out.add((int(bt[b, q // PS]), q % PS) if q < PPS * PS
                    else (b, j % PS))
    return out


def test_verify_step_paged_matches_jax(world):
    jmodel, jparams, model, params = world
    pk, pv, bt, pos, tokens = _paged_setup(model.cfg,
                                           np.random.default_rng(0))
    scratch = np.arange(3, dtype=np.int32)
    jcache = {"pk": jnp.asarray(pk), "pv": jnp.asarray(pv),
              "pos": jnp.asarray(pos)}
    jtok, jcache = jmodel.verify_step(
        jparams, jcache, {"tokens": jnp.asarray(tokens),
                          "block_table": jnp.asarray(bt),
                          "scratch_pages": jnp.asarray(scratch)})
    tcache = {"pk": torch.from_numpy(pk.copy()),
              "pv": torch.from_numpy(pv.copy()),
              "pos": torch.from_numpy(pos.copy())}
    ttok, tcache = model.verify_step(
        params, tcache, {"tokens": torch.from_numpy(tokens),
                         "block_table": torch.from_numpy(bt),
                         "scratch_pages": torch.from_numpy(scratch)})
    assert ttok.shape == (3, W) and ttok.dtype == torch.int32
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert tcache["pos"].tolist() == pos.tolist()      # pos not advanced
    written = _paged_writes(bt, pos)
    for key, before in (("pk", pk), ("pv", pv)):
        mine = tcache[key].numpy()
        np.testing.assert_allclose(mine, np.asarray(jcache[key]), atol=1e-4)
        for page in range(before.shape[1]):
            for off in range(PS):
                if (page, off) not in written:
                    np.testing.assert_array_equal(mine[:, page, off],
                                                  before[:, page, off])


def test_verify_step_dense_matches_jax(world):
    """Dense per-slot cache of 24 rows: slot 2's window (21..25) runs past
    max_len; its rows 24 and 25 are dropped, the rest written."""
    jmodel, jparams, model, params = world
    cfg = model.cfg
    rng = np.random.default_rng(1)
    shape = (cfg.num_layers, 3, 24, cfg.n_kv, cfg.head_dim)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    pos = np.array([3, 10, 21], np.int32)
    tokens = rng.integers(0, 64, size=(3, W)).astype(np.int32)
    jtok, jcache = jmodel.verify_step(
        jparams, {"k": jnp.asarray(k), "v": jnp.asarray(v),
                  "pos": jnp.asarray(pos)}, {"tokens": jnp.asarray(tokens)})
    tcache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
              "pos": torch.from_numpy(pos.copy())}
    ttok, tcache = model.verify_step(params, tcache,
                                     {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for key, before in (("k", k), ("v", v)):
        mine = tcache[key].numpy()
        np.testing.assert_allclose(mine, np.asarray(jcache[key]), atol=1e-4)
        for b, p in enumerate(pos):
            untouched = [r for r in range(24) if not p <= r < p + W]
            np.testing.assert_array_equal(mine[:, b, untouched],
                                          before[:, b, untouched])


@pytest.mark.parametrize("paged", [True, False])
def test_verify_logits_equal_sequential_decode(world, paged):
    """verify_logits over W window tokens == W decode_logits calls fed the
    same tokens one at a time (f32, atol 1e-5), and both write the same
    K/V rows."""
    _, _, model, params = world
    rng = np.random.default_rng(2)
    if paged:
        pk, pv, bt, _, tokens = _paged_setup(model.cfg, rng)
        pos = np.array([5, 9, 20], np.int32)       # every window in-table
        cache = {"pk": pk, "pv": pv}
        extra = {"block_table": torch.from_numpy(bt),
                 "scratch_pages": torch.arange(3, dtype=torch.int32)}
    else:
        shape = (model.cfg.num_layers, 3, 24, model.cfg.n_kv,
                 model.cfg.head_dim)
        cache = {key: rng.normal(size=shape).astype(np.float32)
                 for key in ("k", "v")}
        pos = np.array([0, 7, 19], np.int32)
        tokens = rng.integers(0, 64, size=(3, W)).astype(np.int32)
        extra = {}

    def fresh():
        return {**{k_: torch.from_numpy(a.copy()) for k_, a in cache.items()},
                "pos": torch.from_numpy(pos.copy())}

    vc = fresh()
    vlog, vc = model.verify_logits(
        params, vc, {"tokens": torch.from_numpy(tokens), **extra})
    dc = fresh()
    for j in range(W):
        dlog, dc = model.decode_logits(
            params, dc, {"tokens": torch.from_numpy(tokens[:, j:j + 1]),
                         **extra})
        np.testing.assert_allclose(vlog[:, j].numpy(), dlog[:, 0].numpy(),
                                   atol=1e-5)
    for key in cache:
        np.testing.assert_allclose(vc[key].numpy(), dc[key].numpy(),
                                   atol=1e-5)


def test_write_slot_cache_and_advance_pos_match_jax(world):
    jmodel, _, model, _ = world
    cfg = model.cfg
    rng = np.random.default_rng(3)
    shape = (cfg.num_layers, 3, 16, cfg.n_kv, cfg.head_dim)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    pos = np.array([4, 0, 9], np.int32)
    sk, sv = (rng.normal(size=(cfg.num_layers, 1, 8, cfg.n_kv,
                               cfg.head_dim)).astype(np.float32)
              for _ in range(2))
    jc = jax_tf.write_slot_cache({"k": jnp.asarray(k), "v": jnp.asarray(v),
                                  "pos": jnp.asarray(pos)},
                                 {"k": jnp.asarray(sk), "v": jnp.asarray(sv)},
                                 1, 6)
    tc = tf.write_slot_cache({"k": torch.from_numpy(k.copy()),
                              "v": torch.from_numpy(v.copy()),
                              "pos": torch.from_numpy(pos.copy())},
                             {"k": torch.from_numpy(sk),
                              "v": torch.from_numpy(sv)}, 1, 6)
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
    assert tc["pos"].dtype == torch.int32
    for delta in (np.array([2, 0, 5], np.int32), -3, -12):
        jp = jax_tf.advance_pos(jc, delta)["pos"]
        tp = tf.advance_pos(tc, delta)["pos"]
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        assert tp.dtype == torch.int32
    assert tf.advance_pos(tc, -12)["pos"].tolist() == [0, 0, 0]
    assert model.advance_pos(tc, 1)["pos"].tolist() == [5, 7, 10]


# ---------------------------------------------------------------------------
# host transfers, the constructor, the launcher
# ---------------------------------------------------------------------------

_TO_HOST = ("cpu", "item", "tolist", "numpy", "__array__", "__int__",
            "__index__", "__float__", "__bool__")


@pytest.mark.parametrize("drafter", ["self", "ngram"])
@pytest.mark.parametrize("paged", [True, False])
def test_one_host_transfer_per_verify_step(world, monkeypatch, paged,
                                           drafter):
    """Each verify step reads the device once: one `.cpu()` of the window
    and its scores together, and no other read of a tensor's values
    (`.item()`, `.tolist()`, `int()`, `bool()`, ... would each sync)."""
    eng = _engine(world)
    sched = ContinuousScheduler(
        eng, paged=paged, page_size=8,
        drafter=SelfDrafter(k=3) if drafter == "self" else NGramDrafter(k=3))
    reads = []
    for name in _TO_HOST:
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **kw):
            reads.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, counted)
    per_step = []
    spec_once = sched._spec_decode_once

    def watched():
        del reads[:]
        evs = list(spec_once())
        # the numpy view of the one host copy is no transfer
        per_step.append([r for r in reads if r != "numpy"])
        assert reads.count("numpy") <= 1
        yield from evs
    sched._spec_decode_once = watched
    sched.serve(_trace([6, 4, 7, 3]), [0, 0, 1, 2])
    monkeypatch.undo()
    assert per_step and all(r == ["cpu"] for r in per_step), per_step


def test_constructor_takes_drafter_and_dense_cache_not_tiering(world):
    eng = _engine(world, slots=2)
    dense = ContinuousScheduler(eng, paged=False, drafter=NGramDrafter(k=2))
    assert dense.pager is None and "k" in dense.cache
    assert dense.cache["pos"].shape == (2,)
    assert "kv_pages_free" not in dense.resource_gauges()
    # tiering is ported; the dense cache takes no KV host tier (preemption
    # and the page tier need the paged cache)
    tiered = ContinuousScheduler(eng, paged=False,
                                 tiering=TieringConfig(host_kv_pages=4))
    assert tiered.host_kv is None and tiered.pager is None


def test_launcher_speculative_ngram_dense_cache(capsys):
    launch_serve.main(["--arch", "yi-6b", "--reduced", "--continuous",
                       "--speculative", "--drafter", "ngram",
                       "--dense-cache", "--draft-k", "3", "--device", "cpu",
                       "--trace-n", "4", "--n", "64"])
    out = capsys.readouterr().out
    assert "continuous: 4 requests" in out
    assert "speculative (ngram, k=3):" in out
    assert "tokens/step/slot" in out
