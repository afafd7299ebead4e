"""The train path's profiler ranges (`repro_torch.core.spans`) on a tiny
dense model with remat full, on the CPU: nothing is recorded and
`record_function` is never called while no profiler records; under
`torch.profiler` each range appears where its work happens (the layer's
range a second time for its recompute, attention's and the merge's again
around their backward nodes); a profiled step trains bit for bit as an
unprofiled one; a range opened on another thread than the graph it reads
(remat's recompute on the card) keeps to its own nodes."""
import threading

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.configs.base import PEFTConfig, TrainConfig
from repro_torch.core import spans
from repro_torch.models import attention as attn
from repro_torch.models import build
from repro_torch.train import step as ts

VOCAB = 64
BACKWARD = "autograd::engine::evaluate_function"


def _step(layers=2):
    cfg = configs.reduced(configs.get("yi-6b"), layers=layers).replace(
        vocab=VOCAB, param_dtype="float32", dtype="float32")
    model = build(cfg, PEFTConfig(method="fourierft", n=32, alpha=10.0),
                  remat="full")
    state, frozen = ts.init_state(model, TrainConfig(), 0, device="cpu")
    return ts.make_train_step(model, TrainConfig()), state, frozen


def _batch(i):
    g = torch.Generator().manual_seed(i)
    toks = torch.randint(0, VOCAB, (2, 17), generator=g)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _profiled(fn):
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
               e.is_user_annotation())
              for e in prof.profiler.kineto_results.events()]
    return out, events


def _inside(t, ranges):
    return any(a <= t <= b for _, a, b, _ in ranges)


def test_no_profiler_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a range opened without a profiler")
    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert spans.span("step") is spans.span("layer")
    step, state, frozen = _step()
    for i in range(2):
        state, metrics = step(state, frozen, _batch(i))
    assert torch.isfinite(metrics["loss"])


def test_ranges_where_the_work_happens():
    layers = 2
    step, state, frozen = _step(layers)
    state, _ = step(state, frozen, _batch(0))
    _, events = _profiled(lambda: step(state, frozen, _batch(1)))
    ranges = lambda n: [e for e in events if e[0] == spans.PREFIX + n]
    nodes = [e for e in events if e[0].startswith(BACKWARD)]
    in_backward = lambda n: [e for e in ranges(n) if _inside(e[1], nodes)]
    fwd = lambda n: [e for e in ranges(n) if not _inside(e[1], nodes)]

    assert len(ranges("step")) == 1
    # function-scope ranges: Kineto copies no user annotation of them onto
    # the device's timeline
    assert not any(e[3] for e in events if e[0].startswith(spans.PREFIX))
    step_range = ranges("step")
    assert all(_inside(e[1], step_range) for e in events
               if e[0].startswith(spans.PREFIX))
    # the layer's body: once forward, once recomputed inside the backward
    assert len(fwd("layer")) == layers
    recomputed = in_backward("layer")
    assert len(recomputed) == layers
    # attention: once in each forward layer, once in each recompute, and
    # around its backward nodes (outside any layer)
    att = ranges("attention/direct")
    assert sum(_inside(e[1], fwd("layer")) for e in att) == layers
    assert sum(_inside(e[1], recomputed) for e in att) == layers
    att_nodes = [e for e in in_backward("attention/direct")
                 if not _inside(e[1], recomputed)]
    assert len(att_nodes) >= layers
    softmax_bw = [e for e in events if e[0] == "aten::_softmax_backward_data"]
    assert len(softmax_bw) == layers
    assert all(_inside(e[1], att_nodes) for e in softmax_bw)
    # the merge: once forward, before the layers, then around its
    # backward nodes, apart from attention's
    assert len(fwd("adapter")) == 1
    assert fwd("adapter")[0][2] < fwd("layer")[0][1]
    merge_nodes = in_backward("adapter")
    assert merge_nodes
    assert not any(_inside(e[1], merge_nodes) for e in att)


def test_a_range_on_another_thread_keeps_to_its_own_nodes(monkeypatch):
    """On the card remat recomputes on the autograd engine's thread, whose
    sequence numbers are its own. A range opened there reads inputs whose
    graph the forward's thread made, under larger numbers; it opens around
    its own nodes only, not around that graph's."""
    x = torch.randn(8, requires_grad=True)
    h = x
    for _ in range(50):             # the forward thread's count runs ahead
        h = h * 1.01
    hooked = []
    monkeypatch.setattr(spans, "_open_while_running",
                        lambda node, name: hooked.append(node.name()))

    def recompute():
        with spans.Span(spans.PREFIX + "shared") as sp:
            out = torch.cat([h, h]).exp()
            sp.backward(out)
    worker = threading.Thread(target=recompute)
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive()
    assert sorted(hooked) == ["CatBackward0", "ExpBackward0"]


def test_merge_range_holds_the_dc_transform():
    """FourierDeltaW (K1/K2's autograd Function; their plain versions on
    CPU tensors): its backward runs inside the merge's range."""
    from repro_torch.core import fourierft
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)
    c = torch.randn(32, generator=g, requires_grad=True)
    entries = fourierft.sample_entries(16, 24, 32, seed=0)

    def run():
        with spans.span("adapter") as sp:
            dw = ops.fourier_deltaw_forward(c, entries, 16, 24, 10.0)
            sp.backward(dw)
        return torch.autograd.grad(dw.square().sum(), c)[0]
    grad, events = _profiled(run)
    merge = [e for e in events if e[0] == spans.PREFIX + "adapter"]
    dc = [e for e in events if e[0] == "DeltaWBackward"]
    assert len(merge) == 2 and len(dc) == 1
    assert _inside(dc[0][1], merge[1:])
    assert torch.equal(grad, run())


@pytest.mark.parametrize("flash,path", [(True, "flash"),
                                        (False, "chunked")])
def test_attention_names_its_path(flash, path):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 16, 4, 8, generator=g, requires_grad=True)
    k = torch.randn(1, 16, 2, 8, generator=g, requires_grad=True)
    v = torch.randn(1, 16, 2, 8, generator=g, requires_grad=True)

    def run():
        out = attn.attention(q, k, v, direct_threshold=8, chunk=8,
                             flash=flash)
        return torch.autograd.grad(out.sum(), (q, k, v))
    grads, events = _profiled(run)
    names = [e[0] for e in events if e[0].startswith(spans.PREFIX)]
    assert set(names) == {spans.PREFIX + "attention/" + path}
    assert len(names) >= 2          # the forward and its backward nodes
    plain = run()
    for a, b in zip(grads, plain):
        assert torch.equal(a, b)


def test_profiled_steps_train_bit_for_bit():
    def train(profiled):
        torch.manual_seed(0)
        step, state, frozen = _step()
        losses = []
        for i in range(3):
            if profiled:
                (state, m), _ = _profiled(
                    lambda: step(state, frozen, _batch(i)))
            else:
                state, m = step(state, frozen, _batch(i))
            losses.append(m["loss"])
        return torch.stack(losses), state["trainable"]["peft"]
    la, ca = train(False)
    lb, cb = train(True)
    assert torch.equal(la, lb)
    assert ca.keys() == cb.keys()
    for site in ca:
        assert torch.equal(ca[site]["c"], cb[site]["c"])
