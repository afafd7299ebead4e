"""Each per-layer reader on synthetic spans, counters and profiler events,
and the trace's own reductions."""
import json

import pytest

import perfbench_testroot as tr
from harness import flops, spec
from harness.record import Run, quantile
from harness.trace import Trace

YI = json.loads((tr.BENCH / "configs" / "yi-6b.json").read_text())
H100 = flops.peaks("H100")
SITES = [("layers/wq", 4096, 4096, 32), ("layers/wv", 4096, 512, 32)]


def read(name, run):
    return spec.reader(tr.REPO, name)(run)


def train_run(**kw):
    t = Trace(span_s=2.0, device=[
        ("void deltaw_kernel<(Basis)0, 1, false>(Scatter)", 0.0, 0.004),
        ("scatter_plan_kernel<(Basis)0>", 0.004, 0.005),
        ("dc_partial_kernel<(Basis)0, false>", 0.5, 0.504),
        ("dc_reduce_kernel", 0.504, 0.505),
        ("nvjet_tst_192x192", 0.6, 1.5),
    ], host=[("aten::mm", 1.5, 1.9)])
    r = Run("train", YI, {}, H100, window_s=10.0, step_s=[1.0, 1.2, 1.1],
            tokens=3 * 8192, step_ops=1.966e14, trace=t,
            counters={"k1_launches": 2, "k2_launches": 2}, sites=SITES,
            peak_window_bytes=3 * 2 ** 30)
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_train_readers():
    r = train_run()
    assert read("step_ms_p50.train", r) == pytest.approx(1100.0)
    assert read("mfu.train", r) == pytest.approx(
        100 * 3 * 1.966e14 / (3.3 * 989e12))
    cycle = flops.deltaw_bound(4096, 4096, 32, H100) + flops.deltaw_bound(
        4096, 512, 32, H100)
    # 2 launches = one cycle over the two sites, in 5 ms of K1's kernels
    assert read("k1_roofline.train", r) == pytest.approx(100 * cycle / 0.005)
    assert read("k2_roofline.train", r) == pytest.approx(100 * cycle / 0.005)
    assert read("peak_mem_gib.train", r) == pytest.approx(3.0)
    busy = 0.005 + 0.005 + 0.9
    assert read("device_idle_share.train", r) == pytest.approx(
        100 * (1 - busy / 2.0))


def test_readers_read_nothing_where_nothing_was_measured():
    bare = train_run(trace=None, counters={}, step_s=[])
    for name in ("step_ms_p50.train", "k1_roofline.train",
                 "k2_roofline.train", "device_idle_share.train"):
        assert read(name, bare) is None
    no_launch = train_run(counters={"k1_launches": 0, "k2_launches": 0})
    assert read("k1_roofline.train", no_launch) is None
    serve = Run("serve", YI, {}, H100)
    for name in ("step_ms_p50.train", "mfu.train", "peak_mem_gib.train"):
        assert read(name, serve) is None
    for name in ("tick_ms_p50.serve", "mfu.serve", "k3_roofline.serve",
                 "device_idle_share.serve", "sender_lag_p95_ms.serve",
                 "peak_mem_gib.serve", "tpot_p95_ms.hostpaced",
                 "ttft_p95_ms.tail", "ttft_p50_ms.serve"):
        assert read(name, train_run()) is None
        assert read(name, serve) is None


def test_attention_roofline_reads_the_fused_kernel_alone():
    t = Trace(span_s=1.0, device=[
        ("void fwd_kernel<128>(bf16 const*, Dims)", 0.0, 0.002),
        ("void bwd_dq_kernel<128>(bf16 const*, Dims)", 0.1, 0.103),
        ("void bwd_dkdv_kernel<128>(bf16 const*, Dims)", 0.103, 0.107),
        ("void pytorch_flash::flash_fwd_kernel<Traits>(Params)", 0.2, 0.5),
        ("nvjet_tst_192x192", 0.5, 0.9),
    ])
    shape = (8, 1024, 32, 4, 128)
    r = train_run(trace=t, attention=shape,
                  counters={"attention_launches": 2,
                            "attention_bwd_launches": 1})
    # forward: 4 x 32 x 128 x 8 x (1024^2 + 1024) / 2 = 6.878e10 operations
    # (0.0695 ms at 989 TF/s; its bytes take 0.045 ms); backward twice that
    fwd = 4 * 32 * 128 * 8 * (1024 ** 2 + 1024) / 2 / 989e12
    assert flops.fused_attention_bound(shape, H100) == pytest.approx(fwd)
    assert flops.fused_attention_bound(shape, H100, backward=True) == \
        pytest.approx(2 * fwd)
    assert read("attention_roofline.train", r) == pytest.approx(
        100 * 4 * fwd / 0.009)
    for bare in (train_run(trace=t), train_run(trace=None, attention=shape),
                 train_run(trace=t, attention=shape),
                 train_run(trace=Trace(span_s=1.0), attention=shape,
                           counters={"attention_launches": 2})):
        assert read("attention_roofline.train", bare) is None
    assert read("attention_roofline.train", Run("serve", YI, {}, H100)) \
        is None


def test_serve_readers():
    t = Trace(span_s=1.0, device=[
        ("void paged_attn_bf16<128, 64, 2, 2>(Args)", 0.0, 0.01),
        ("void combine_splits<__nv_bfloat16>(Args)", 0.01, 0.012),
        ("nvjet_gemm", 0.1, 0.5),
    ])
    rounds = [[100, 1, 1], [101, 1, 1]]
    r = Run("serve", YI, {}, H100, window_s=30.0, tick_s=[0.02, 0.04, 0.03],
            required_ops=1e15, busy_rounds_s=2.0, lag_s=[0.001] * 19 + [0.5],
            tpot_s=[0.1] * 18 + [0.2, 0.3], ttft_s=[0.5] * 18 + [1.0, 2.0],
            trace=t, k3_rounds=rounds, peak_window_bytes=2 ** 31)
    assert read("tick_ms_p50.serve", r) == pytest.approx(30.0)
    assert read("mfu.serve", r) == pytest.approx(100 * 1e15 / (2 * 989e12))
    want = 32 * sum(flops.paged_attention_bound(kv, 32, 4, 128, 2, H100)
                    for kv in rounds)
    assert read("k3_roofline.serve", r) == pytest.approx(100 * want / 0.012)
    assert read("device_idle_share.serve", r) == pytest.approx(
        100 * (1 - 0.412))
    assert read("sender_lag_p95_ms.serve", r) == pytest.approx(1.0)
    assert read("peak_mem_gib.serve", r) == pytest.approx(2.0)
    assert read("tpot_p95_ms.hostpaced", r) == pytest.approx(200.0)
    assert read("ttft_p95_ms.tail", r) == pytest.approx(1000.0)
    assert read("ttft_p50_ms.serve", r) == pytest.approx(500.0)


def test_trace_union_gaps_and_top_ops():
    t = Trace(span_s=1.0, device=[("a", 0.0, 0.3), ("b", 0.2, 0.4),
                                  ("a", 0.7, 0.8)],
              host=[("cudaStreamSynchronize", 0.4, 0.69),
                    ("aten::mm", 0.85, 0.9)])
    assert t.busy_s() == pytest.approx(0.5)
    assert t.kernel_s(("a",)) == (pytest.approx(0.4), 2)
    assert t.top_ops() == [["a", pytest.approx(0.4)], ["b",
                                                      pytest.approx(0.2)]]
    gaps = t.idle_gaps()
    assert gaps[0] == ["cudaStreamSynchronize", pytest.approx(0.3)]
    assert gaps[1] == ["aten::mm", pytest.approx(0.2)]


def test_quantile_is_nearest_rank():
    assert quantile(list(range(1, 21)), 0.95) == 19
    assert quantile([5.0], 0.95) == 5.0
    assert quantile([], 0.5) is None
