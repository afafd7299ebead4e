"""The yardstick against numbers worked out by hand for yi-6b: the decoder
family's required operations and the kernels' bounds."""
import json
import math

import pytest

import perfbench_testroot as tr
from harness import flops, spec

YI = json.loads((tr.BENCH / "configs" / "yi-6b.json").read_text())
FAMILY = spec.family(YI, tr.REPO)
H100 = {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}


def test_yi_6b_matmul_parameters():
    # a layer: q 4096x4096, k and v 4096x512, o 4096x4096
    #          = 33,554,432 + 4,194,304 = 37,748,736; x 32 = 1,207,959,552
    # MLP: 3 x 4096 x 11008 = 135,266,304; x 32 = 4,328,521,728
    # head: 4096 x 64000 = 262,144,000
    m = FAMILY.matmul_params_per_token(YI)
    assert m == {"attention": 1_207_959_552, "mlp": 4_328_521_728,
                 "head": 262_144_000}
    assert sum(m.values()) == 5_798_625_280


def test_yi_6b_sft_step():
    # forward matmuls 2 x 5,798,625,280 x 8192 = 9.5004e13, as many again
    # backward; causal attention 2 x (32 x 128 x 32) x 1024^2 x 8
    # = 2.1990e12 forward, twice that backward: 196.6 TFLOP a step
    mm = 2 * 5_798_625_280 * 8192
    attn = 2 * 131_072 * 1024 ** 2 * 8
    assert FAMILY.train_step_ops(YI, 8, 1024) == pytest.approx(
        2 * mm + 3 * attn, rel=1e-12)
    assert FAMILY.train_step_ops(YI, 8, 1024) == pytest.approx(1.966e14,
                                                              rel=1e-3)


def test_yi_6b_short_step():
    # 32 x 128 = 4096 tokens: matmuls 4 x 5,798,625,280 x 4096 = 9.5005e13;
    # causal attention 2 x 131,072 x 128^2 x 32 = 1.3744e11 forward, x 3
    # with the backward: 95.4 TFLOP a step
    assert FAMILY.train_step_ops(YI, 32, 128) == pytest.approx(
        4 * 5_798_625_280 * 4096 + 3 * 2 * 131_072 * 128 ** 2 * 32,
        rel=1e-12)
    assert FAMILY.train_step_ops(YI, 32, 128) == pytest.approx(9.5418e13,
                                                              rel=1e-4)


def test_prefill_and_decode():
    # a 768-token prompt: 2 x (1,207,959,552 + 4,328,521,728) x 768 + the
    # head once + 2 x 131,072 x 768^2
    assert FAMILY.prefill_ops(YI, 768) == pytest.approx(
        2 * 5_536_481_280 * 768 + 2 * 262_144_000 + 2 * 131_072 * 768 ** 2)
    # two slots at kv 100 and 1: 2 x 5,798,625,280 x 2 + 4 x 131,072 x 101
    assert FAMILY.decode_ops(YI, [100, 1]) == pytest.approx(
        2 * 5_798_625_280 * 2 + 4 * 131_072 * 101)


def test_deltaw_bound_is_bytes_at_yi_shapes():
    # wq: 32 x 4096 x 4096 f32 once = 2,147,483,648 B -> 0.641 ms; the FFT's
    # 2.5 x 2^24 x 24 x 32 = 3.22e10 operations take 0.481 ms at 67 TF/s
    b = flops.deltaw_bound(4096, 4096, 32, H100)
    assert b == pytest.approx(2_147_483_648 / 3.35e12)
    assert flops.fft_ops(4096, 4096, 32) == pytest.approx(
        2.5 * 2 ** 24 * 24 * 32)
    # wv: 32 x 4096 x 512: 268,435,456 B
    assert flops.deltaw_bound(4096, 512, 32, H100) == pytest.approx(
        268_435_456 / 3.35e12)


def test_paged_attention_bound():
    # slots at kv 100 and 1, 4 kv heads of 128 in bf16, k and v: 101 x 4 x
    # 128 x 2 x 2 = 206,848 B; queries in and outputs out, 32 heads: 2 x 32
    # x 128 x 2 x 2 = 32,768 B
    b = flops.paged_attention_bound([100, 1], 32, 4, 128, 2, H100)
    assert b == pytest.approx((206_848 + 32_768) / 3.35e12)


def test_fused_attention_bound_is_operations_at_sft1k_and_bytes_at_decode():
    # B 8, S 1024, 32 heads of 128 over 4 kv heads: 4 x 32 x 128 x 524,800
    # x 8 = 6.878e10 operations forward (0.0695 ms), twice that backward;
    # bytes 2 x (2 x 33,554,432 + 2 x 4,194,304) + 4 x 262,144 = 152 MB
    shape = (8, 1024, 32, 4, 128)
    ops = 4.0 * 32 * 128 * 8 * (1024 * 1024 + 1024) / 2
    assert flops.fused_attention_bound(shape, H100) == pytest.approx(
        ops / 989e12)
    assert flops.fused_attention_bound(shape, H100, backward=True) == \
        pytest.approx(2 * ops / 989e12)
    # one row: 4 x 32 x 128 x 1 operations against 2 x (2 x 4096 + 2 x
    # 512) + 128 bytes
    one = (1, 1, 32, 4, 128)
    assert flops.fused_attention_bound(one, H100) == pytest.approx(
        (2 * (2 * 4096 + 2 * 512) + 4 * 32) / 3.35e12)


def test_peaks_table():
    assert flops.peaks("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
    with pytest.raises(KeyError):
        flops.peaks("some other card")
    assert math.isclose(flops.bound(1e12, 0.0, 1e12, 1.0), 1.0)
