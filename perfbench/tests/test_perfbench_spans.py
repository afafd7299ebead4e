"""The program's spans in a traced stretch (harness/spans.py) and the four
readers that charge device time to them: on a real CPU profile of a tiny
train step with remat full, on synthetic traces with known answers, and
the existing readers unchanged by spans in the trace."""
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import perfbench_testroot as tr
from harness import flops, spans, spec, trace
from harness.record import Run
from harness.trace import Trace

H100 = flops.peaks("H100")
NEW = ("attention_ms.train", "adapter_ms.train", "recompute_ms.train",
       "idle_in_step_ms.train")
OLD = ("step_ms_p50.train", "mfu.train", "k1_roofline.train",
       "k2_roofline.train", "peak_mem_gib.train", "device_idle_share.train")
P = spans.PREFIX


def read(name, run):
    return spec.reader(tr.REPO, name)(run)


def _profiled(fn):
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    t0 = time.time_ns()
    out = fn()
    t1 = time.time_ns()
    prof.stop()
    return trace.capture(prof, t0, t1), out


def _chain(ranges, t):
    return spans.chains_at(ranges, [t])[0]


@pytest.fixture(scope="module")
def cpu_step():
    """The Trace of one profiled step of a tiny dense model (remat full)."""
    from repro_torch import configs
    from repro_torch.configs.base import PEFTConfig, TrainConfig
    from repro_torch.models import build
    from repro_torch.train import step as ts
    cfg = configs.reduced(configs.get("yi-6b"), layers=2).replace(
        vocab=64, param_dtype="float32", dtype="float32")
    model = build(cfg, PEFTConfig(method="fourierft", n=32, alpha=10.0),
                  remat="full")
    state, frozen = ts.init_state(model, TrainConfig(), 0, device="cpu")
    step = ts.make_train_step(model, TrainConfig())
    toks = torch.randint(0, 64, (2, 17),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    state, _ = step(state, frozen, batch)
    t, _ = _profiled(lambda: step(state, frozen, batch))
    return t


def test_cpu_profile_resolves_ops_to_their_spans(cpu_step):
    t = cpu_step
    ranges = spans.program_ranges(t)
    names = {r.name for r in ranges}
    assert {P + "step", P + "adapter", P + "layer",
            P + "attention/direct"} <= names
    assert sum(r.recompute for r in ranges) == 2      # a layer each

    def chains(op):
        return [_chain(ranges, a) for n, a, _ in t.host if n == op]

    def holds(chain, name, recompute=None):
        return any(r.name == name and (recompute is None
                                       or r.recompute == recompute)
                   for r in chain)
    # the backward's softmax and its einsums' batched products
    for op in ("aten::_softmax_backward_data", "BmmBackward0"):
        got = chains(op)
        assert got and all(holds(c, P + "attention/direct") for c in got)
        assert not any(spans.recomputed(c) for c in got)
    # forward softmax: once in each forward layer, once in its recompute
    fwd = chains("aten::_softmax")
    assert len(fwd) == 4
    assert sum(spans.recomputed(c) for c in fwd) == 2
    assert all(holds(c, P + "attention/direct") and holds(c, P + "layer")
               for c in fwd)
    # every op of the step lies under `step`
    assert all(holds(_chain(ranges, a), P + "step") for n, a, _ in t.host
               if n.startswith("aten::"))


def test_cpu_profile_resolves_the_dc_transform_to_the_merge():
    from repro_torch.core import fourierft
    from repro_torch.core.spans import span
    from repro_torch.kernels import ops
    c = torch.randn(32, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    entries = fourierft.sample_entries(16, 24, 32, seed=0)

    def run():
        with span("adapter") as sp:
            dw = ops.fourier_deltaw_forward(c, entries, 16, 24, 10.0)
            sp.backward(dw)
        return torch.autograd.grad(dw.square().sum(), c)
    t, _ = _profiled(run)
    ranges = spans.program_ranges(t)
    dc = [a for n, a, _ in t.host if n == "DeltaWBackward"]
    assert len(dc) == 1
    assert [r.name for r in _chain(ranges, dc[0])] == [P + "adapter"]


def _with_ids(t):
    """The trace with correlation ids: the k-th launch call of a kind and
    the k-th operation of that kind share one."""
    t.host_ids = [0] * len(t.host)
    t.device_ids = [0] * len(t.device)
    launches = {}
    for i, (n, a, _) in enumerate(t.host):
        kind = spans.launch_kind(n)
        if kind is not None:
            launches.setdefault(kind, []).append((a, i))
    ops = {}
    for i, (n, a, _) in enumerate(t.device):
        ops.setdefault(spans.device_kind(n), []).append((a, i))
    cid = 100
    for kind, seq in ops.items():
        for (_, op), (_, call) in zip(sorted(seq), sorted(launches[kind])):
            cid += 1
            t.device_ids[op], t.host_ids[call] = cid, cid
    return t


def _synthetic(with_spans=True, trace_steps=1):
    """One step [0.0, 1.0] and the harness's loss read after it:

    forward   adapter 0.01-0.05 (launch 0.02), layer 0.10-0.30 holding
              attention 0.15-0.20 (launch 0.16) and a launch at 0.25
    backward  node 0.50-0.70 recomputing the layer 0.52-0.60 (launches
              0.53; 0.56 in attention 0.55-0.58); node 0.75-0.80 with
              attention's range 0.76-0.79 (launch 0.77); node 0.85-0.90
              with the merge's range 0.86-0.89 (memset 0.87, launch 0.88)
    after     a memcpy launched at 1.20, outside the step

    Device operations run 0.1 s after their launches, 0.01-0.05 s long;
    each launch call and the operation it launched share a correlation
    id."""
    host = [("cudaLaunchKernel", t, t + 0.001)
            for t in (0.02, 0.16, 0.25, 0.53, 0.56, 0.77, 0.88)]
    host += [("cudaMemsetAsync", 0.87, 0.871),
             ("cudaMemcpyAsync", 1.20, 1.21)]
    host += [("autograd::engine::evaluate_function: A", 0.50, 0.70),
             ("autograd::engine::evaluate_function: B", 0.75, 0.80),
             ("autograd::engine::evaluate_function: C", 0.85, 0.90)]
    if with_spans:
        host += [(P + "step", 0.0, 1.0), (P + "adapter", 0.01, 0.05),
                 (P + "layer", 0.10, 0.30),
                 (P + "attention/direct", 0.15, 0.20),
                 (P + "layer", 0.52, 0.60),
                 (P + "attention/direct", 0.55, 0.58),
                 (P + "attention/direct", 0.76, 0.79),
                 (P + "adapter", 0.86, 0.89)]
    device = [
        ("void deltaw_kernel<(Basis)0, 1, false>(Scatter)", 0.12, 0.13),
        ("attn_a", 0.26, 0.30),          # attention forward
        ("mm_a", 0.35, 0.40),            # the layer's own work
        ("mm_b", 0.63, 0.66),            # recompute, outside attention
        ("attn_b", 0.66, 0.68),          # recompute in attention
        ("attn_c", 0.87, 0.90),          # attention's backward
        ("Memset (Device)", 0.97, 0.98),  # the merge's backward
        ("dc_partial_kernel<(Basis)0, false>", 0.98, 1.00),
        ("Memcpy DtoH (Device -> Pageable)", 1.30, 1.32),
    ]
    t = _with_ids(Trace(span_s=2.0, device=device, host=host))
    return Run("train", {}, {"trace_steps": trace_steps}, H100,
               window_s=10.0, step_s=[1.0, 1.2, 1.1], tokens=3 * 8192,
               step_ops=1.966e14, trace=t,
               counters={"k1_launches": 2, "k2_launches": 2},
               sites=[("layers/wq", 4096, 4096, 32),
                      ("layers/wv", 4096, 512, 32)],
               peak_window_bytes=3 * 2 ** 30)


@pytest.mark.parametrize("steps", [1, 2])
def test_span_readers_on_a_synthetic_trace(steps):
    r = _synthetic(trace_steps=steps)
    per = 1e3 / steps
    assert read("attention_ms.train", r) == pytest.approx(
        (0.04 + 0.02 + 0.03) * per)
    assert read("adapter_ms.train", r) == pytest.approx(
        (0.01 + 0.01 + 0.02) * per)
    assert read("recompute_ms.train", r) == pytest.approx(
        (0.03 + 0.02) * per)
    # gaps 0-0.12, 0.13-0.26, 0.30-0.35, 0.40-0.63, 0.68-0.87, 0.90-0.97
    # lie in the step; 1.00-1.30 (middle 1.15) and 1.32-2.0 do not
    assert read("idle_in_step_ms.train", r) == pytest.approx(
        (0.12 + 0.13 + 0.05 + 0.23 + 0.19 + 0.07) * per)


def test_attribution_counts_and_leaves_the_unlaunched_out():
    r = _synthetic()
    att = spans.attribute(r.trace)
    assert att.paired == 9 and att.launches == att.ops == {
        "kernel": 7, "memset": 1, "memcpy": 1}
    chains = {n: [c.name for c in ch] for (n, _, _), ch in
              zip(r.trace.device, att.chains)}
    assert chains["attn_b"] == [P + "step", P + "layer",
                                P + "attention/direct"]
    assert chains["Memcpy DtoH (Device -> Pageable)"] == []
    # a kernel with no launch before it takes none, and the next
    # kernel keeps its own
    r.trace.device.insert(0, ("orphan", 0.0, 0.01))
    r.trace.device_ids.insert(0, 0)
    att = spans.attribute(r.trace)
    assert att.paired == 9 and att.chains[0] == ()
    assert [c.name for c in att.chains[1]] == [P + "step", P + "adapter"]


def test_pairing_by_correlation_id_survives_a_launch_stamped_late():
    # attention's forward kernel (launched at 0.16) stamped as starting at
    # 0.15: by order it would pair with no launch, and every later kernel
    # with the launch before its own
    r = _synthetic()
    i = [n for n, _, _ in r.trace.device].index("attn_a")
    r.trace.device[i] = ("attn_a", 0.15, 0.19)
    assert spans.attribute(r.trace).paired == 9
    assert read("attention_ms.train", r) == pytest.approx(
        (0.04 + 0.02 + 0.03) * 1e3)
    assert read("recompute_ms.train", r) == pytest.approx(
        (0.03 + 0.02) * 1e3)


def test_a_trace_without_correlation_ids_is_attributed_nothing():
    r = _synthetic()
    r.trace.device_ids, r.trace.host_ids = [], []
    assert spans.attribute(r.trace) is None
    for name in NEW:
        assert read(name, r) is None


def test_span_readers_read_nothing_without_spans():
    bare = _synthetic(with_spans=False)
    for name in NEW:
        assert read(name, bare) is None
    no_device = _synthetic()
    no_device.trace.device = []
    for name in NEW:
        assert read(name, no_device) is None
        assert read(name, Run("serve", {}, {}, H100)) is None
    untraced = _synthetic()
    untraced.trace = None
    for name in NEW:
        assert read(name, untraced) is None


def test_existing_readers_unmoved_by_spans():
    plain, spanned = _synthetic(with_spans=False), _synthetic()
    for name in OLD:
        assert read(name, spanned) == read(name, plain), name
    assert spanned.trace.busy_s() == plain.trace.busy_s()
    assert spanned.trace.top_ops() == plain.trace.top_ops()


@pytest.mark.cuda
def test_span_metrics_on_the_card(tmp_path):
    """A traced run of the tiny train cell on the card reports the four
    metrics, every device operation paired to its launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import run as runner
    root = tr.make_root(tmp_path)
    res = runner.run_cell(root, "tiny-dense-train", 2 ** 31 + 12345, 2.0,
                          True, torch.device("cuda", 0),
                          t_start=time.perf_counter())
    assert res["correct"] is True, res["checks"]
    for name in NEW:
        assert res["metrics"][name]["value"] >= 0
    assert res["metrics"]["attention_ms.train"]["value"] > 0
