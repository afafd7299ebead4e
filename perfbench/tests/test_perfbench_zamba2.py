"""The zamba2 family: its plain reference against HF transformers'
`Zamba2ForCausalLM` and its chunked scan against the per-token recurrence,
the published configuration's sizes and operations, its readers on a
synthetic trace and the spans of a profiled CPU step, and a test-sized
cell run to `correct` (and not, with the reference's embeddings concat
left out)."""
import json
import shutil
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import perfbench_testroot as tr
import run as runner
from harness import flops, inputs, spans, spec, trace
from harness.record import Run
from harness.trace import Trace

TINY = json.loads((tr.DATA / "configs" / "tiny-zamba2.json").read_text())
ZAMBA = json.loads((tr.BENCH / "configs"
                    / "zamba2-7b-instruct.json").read_text())
FAMILY = spec.family(TINY, tr.REPO)
REF = spec.reference(TINY, tr.REPO)
CELL = "tiny-zamba2-train"
SEED = 2 ** 31 + 4242
H100 = flops.peaks("H100")
P = spans.PREFIX


def _f32_base(cfg, seed):
    """Base weights in f32, the ones-leaves of the mamba layers moved off
    1 so that each is read."""
    base = inputs.make_base(FAMILY.base_layout(cfg), seed, "cpu",
                            dtype=torch.float32)
    g = torch.Generator().manual_seed(seed)
    for k in ("norm", "gnorm", "conv_b", "dt_bias", "A_log", "Dp"):
        t = base["layers"][k]
        base["layers"][k] = t + 0.3 * torch.rand(t.shape, generator=g)
    return base


# ---------------------------------------------------------------------------
# The reference against the published module and the scan's oracle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hf():
    """transformers' Zamba2 classes, imported without TensorFlow."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")
        pytest.importorskip("transformers")
        from transformers.models.zamba2 import modeling_zamba2
    return modeling_zamba2


def _hf_model(hf, cfg, base):
    """HF's Zamba2ForCausalLM at `cfg`'s sizes holding `base` (the
    reference's layout) under HF's names."""
    keys = ("vocab_size", "hidden_size", "num_hidden_layers",
            "layers_block_type", "mamba_d_state", "mamba_d_conv",
            "mamba_expand", "mamba_ngroups", "n_mamba_heads", "chunk_size",
            "intermediate_size", "hidden_act", "num_attention_heads",
            "num_key_value_heads", "num_mem_blocks", "adapter_rank",
            "use_mem_rope", "rope_theta", "rms_norm_eps")
    hc = hf.Zamba2Config(attn_implementation="eager",
                         **{k: cfg[k] for k in keys})
    assert (hc.attention_head_dim, hc.mamba_headdim, hc.tie_word_embeddings) \
        == (cfg["attention_head_dim"], cfg["mamba_headdim"], True)
    m = hf.Zamba2ForCausalLM(hc).eval()
    lw, sh, ap = base["layers"], base["shared"], base["apps"]
    ids = cfg["hybrid_layer_ids"]

    def put(param, value):
        param.copy_(value.T if value.ndim == 2 else value)

    with torch.no_grad():
        put(m.model.embed_tokens.weight, base["embed"].T)
        put(m.model.final_layernorm.weight, base["final_norm"])
        for i, layer in enumerate(m.model.layers):
            mam = layer.mamba_decoder if i in ids else layer
            mix = mam.mamba
            put(mam.input_layernorm.weight, lw["norm"][i])
            put(mix.in_proj.weight, torch.cat(
                [lw[k][i] for k in ("wz", "wx", "wbc", "wdt")], dim=1))
            mix.conv1d.weight.copy_(lw["conv_w"][i][:, None, :])
            put(mix.conv1d.bias, lw["conv_b"][i])
            for ours, theirs in (("dt_bias", mix.dt_bias),
                                 ("A_log", mix.A_log), ("Dp", mix.D),
                                 ("gnorm", mix.norm.weight)):
                put(theirs, lw[ours][i])
            put(mix.out_proj.weight, lw["wo_ssm"][i])
            if i not in ids:
                continue
            j = ids.index(i)
            b = j % cfg["num_mem_blocks"]
            block = layer.shared_transformer
            assert block.block_id == b
            put(layer.linear.weight, ap["linear"][j])
            put(block.input_layernorm.weight, sh["attn_norm"][b])
            put(block.pre_ff_layernorm.weight, sh["mlp_norm"][b])
            for ours, theirs in (("wq", "q_proj"), ("wk", "k_proj"),
                                 ("wv", "v_proj"), ("wo", "o_proj")):
                put(getattr(block.self_attn, theirs).weight, sh[ours][b])
            ff = block.feed_forward
            put(ff.gate_up_proj.weight, torch.cat([sh["wg"][b], sh["wi"][b]],
                                                  dim=1))
            put(ff.down_proj.weight, sh["wo_mlp"][b])
            put(ff.gate_up_proj_adapter_list[j][0].weight,
                ap["mlp_lora_a"][j])
            put(ff.gate_up_proj_adapter_list[j][1].weight,
                ap["mlp_lora_b"][j])
    assert m.lm_head.weight.data_ptr() == m.model.embed_tokens.weight \
        .data_ptr()
    return m


def test_reference_logits_match_the_published_module(hf):
    """The reference's forward against HF's torch path, the same f32
    weights under its names (dt_bias 1 and more: no dt under 1e-3, where
    HF's clamp would bite). Both compute in f32; they differ in the order
    of sums (the chunked scan, the split in-projection), so 1e-5 of the
    largest logit."""
    base = _f32_base(TINY, SEED)
    model = _hf_model(hf, TINY, base)
    toks = torch.randint(0, TINY["vocab_size"], (32,),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(input_ids=toks[None], use_cache=False).logits[0]
    dims = REF.Dims(TINY)
    got = REF.logits_at(base, None, REF.entries_for(dims, "cpu"), toks, 0,
                        dims)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_reference_scan_matches_the_recurrence_in_float64(chunk):
    """The chunked SSD against one state update a token, in float64: equal
    to rounding (1e-10), at every chunk that divides the sequence."""
    g = torch.Generator().manual_seed(chunk)
    b, S, H, P_, G, N = 2, 32, 4, 8, 2, 6
    f64 = torch.float64
    x = torch.randn(b, S, H, P_, generator=g, dtype=f64)
    dt = torch.rand(b, S, H, generator=g, dtype=f64) + 0.1
    A = -torch.rand(H, generator=g, dtype=f64) - 0.5
    B = torch.randn(b, S, G, N, generator=g, dtype=f64)
    C = torch.randn(b, S, G, N, generator=g, dtype=f64)
    D = torch.randn(H, generator=g, dtype=f64)
    want = REF.ssd_recurrence(x, dt, A, B, C, D)
    got = REF.ssd(x, dt, A, B, C, D, chunk)
    assert (got - want).abs().max() <= 1e-10 * want.abs().max()


# ---------------------------------------------------------------------------
# The published configuration
# ---------------------------------------------------------------------------

def test_published_configuration_as_the_program_runs_it():
    """Zamba2-7B-Instruct's sizes: 7.36 B weights (tied head), 11.03 B
    multiply-adds a token, 13 applications of two blocks at head dim 224,
    and the program's config built from the file."""
    layout = FAMILY.base_layout(ZAMBA)
    n = sum(torch.Size(s).numel() for s, _ in layout.values())
    assert n == 7_356_749_648 and "lm_head" not in layout
    per_token = FAMILY.matmul_params_per_token(ZAMBA)
    assert sum(per_token.values()) == 11_026_505_728
    assert FAMILY.attention_shape(ZAMBA, 1, 4096) == (1, 4096, 32, 32, 224)
    assert FAMILY.adapted_sites(ZAMBA) == [
        ("shared/wq", 7168, 7168, 13), ("shared/wv", 7168, 7168, 13),
        ("layers/wx", 3584, 7168, 81), ("layers/wo_ssm", 7168, 3584, 81)]
    # the scan: 16 chunks of 256, 32,896 visible pairs each, G·N + H·P =
    # 7,296 a pair; 2·H·P·N = 917,504 a token
    assert FAMILY.ssd_ops(ZAMBA, 1, 4096) == 2.0 * 16 * 32896 * 7296 \
        + 2.0 * 4096 * 917504
    step = FAMILY.train_step_ops(ZAMBA, 1, 4096)
    assert step == pytest.approx(4 * 11_026_505_728 * 4096 + 3 * (
        13 * 2 * 32 * 224 * 4096 ** 2 + 81 * FAMILY.ssd_ops(ZAMBA, 1, 4096)))
    m = per_token
    assert FAMILY.prefill_ops(ZAMBA, 4096) == pytest.approx(
        2 * (m["mamba"] + m["shared"]) * 4096 + 2 * m["head"]
        + 13 * 2 * 32 * 224 * 4096 ** 2 + 81 * FAMILY.ssd_ops(ZAMBA, 1, 4096))
    # a token a slot: the projections, attention over the cache, and a state
    # update and read (2·H·P·N each) a layer
    assert FAMILY.decode_ops(ZAMBA, [100, 1]) == pytest.approx(
        2 * sum(m.values()) * 2 + 4 * 32 * 224 * 13 * 101
        + 2 * 2 * 112 * 64 * 64 * 81 * 2)
    cfg = FAMILY.model_config(ZAMBA)
    assert (cfg.family, cfg.num_layers, cfg.head_dim, cfg.tie_embeddings,
            cfg.ssm.n_groups, cfg.ssm.head_dim, cfg.norm_eps) == (
        "hybrid", 81, 224, True, 2, 64, 1e-5)
    assert cfg.zamba.hybrid_layer_ids == tuple(ZAMBA["hybrid_layer_ids"])
    assert (cfg.zamba.num_mem_blocks, cfg.zamba.adapter_rank) == (2, 128)


@pytest.mark.parametrize("key,value", [
    ("hidden_act", "silu"), ("use_shared_attention_adapter", True),
    ("use_mem_rope", False), ("time_step_limit", [0.0, 1.0]),
    ("hybrid_layer_ids", [6, 12])])
def test_a_config_the_family_does_not_cover_is_refused(key, value):
    with pytest.raises(ValueError, match=key.split("_")[0]):
        FAMILY.model_config(dict(ZAMBA, **{key: value}))


# ---------------------------------------------------------------------------
# The readers and the program's spans
# ---------------------------------------------------------------------------

def _traced(with_spans=True):
    """One step: launches at 0.10 (in `ssd`), 0.20 (in `shared`, inside
    `layer`), 0.30 (in `layer` alone), a backward node 0.50-0.70 whose
    `ssd` range (0.55-0.60) launches at 0.56; operations 0.1 s after their
    launches, 0.02 long."""
    host = [("cudaLaunchKernel", t, t + 0.001)
            for t in (0.10, 0.20, 0.30, 0.56)]
    host += [("autograd::engine::evaluate_function: A", 0.50, 0.70)]
    if with_spans:
        host += [(P + "step", 0.0, 1.0), (P + "layer", 0.05, 0.15),
                 (P + "ssd", 0.08, 0.12), (P + "layer", 0.18, 0.35),
                 (P + "shared", 0.19, 0.25), (P + "ssd", 0.55, 0.60)]
    device = [(f"op{i}", t + 0.1, t + 0.12)
              for i, t in enumerate((0.10, 0.20, 0.30, 0.56))]
    t = Trace(span_s=1.0, device=device, host=host,
              device_ids=[1, 2, 3, 4], host_ids=[1, 2, 3, 4] + [0] * (
                  len(host) - 4))
    return Run("train", ZAMBA, {"batch": 1, "seq": 4096, "trace_steps": 1},
               H100, trace=t)


def test_ssd_and_mem_block_readers_on_a_synthetic_trace():
    r = _traced()
    read = lambda name: spec.reader(tr.REPO, name)(r)  # noqa: E731
    assert read("ssd_ms.train") == pytest.approx(40.0)
    assert read("mem_block_ms.train") == pytest.approx(20.0)
    bound = 3 * 81 * max(
        FAMILY.ssd_ops(ZAMBA, 1, 4096) / H100["bf16_flops"],
        FAMILY.ssd_bytes(ZAMBA, 1, 4096) / H100["hbm_bytes_per_s"])
    assert read("ssd_roofline.train") == pytest.approx(100 * bound / 0.04)
    # the backward node's `ssd` range is no recompute
    assert read("recompute_ms.train") == 0.0
    bare = _traced(with_spans=False)
    decoder = Run("train", json.loads((tr.BENCH / "configs" /
                                       "yi-6b.json").read_text()),
                  {"batch": 8, "seq": 1024, "trace_steps": 1}, H100,
                  trace=r.trace)
    for name in ("ssd_ms.train", "mem_block_ms.train",
                 "ssd_roofline.train"):
        assert spec.reader(tr.REPO, name)(bare) is None
        assert spec.reader(tr.REPO, name)(Run("train", ZAMBA, {}, H100)) \
            is None
    assert spec.reader(tr.REPO, "ssd_roofline.train")(decoder) is None


def test_a_profiled_cpu_step_opens_the_hybrid_ranges():
    """A step of the tiny model (remat full, all four sites) under the
    profiler: every mamba layer's scan lies in `ssd`, each application in
    `shared` and `layer`, the shared sites' factored products in
    `adapter`; remat re-enters each of the 8 layers and 2 applications."""
    from repro_torch.configs.base import PEFTConfig, TrainConfig
    from repro_torch.models import build
    from repro_torch.train import step as ts
    cfg = FAMILY.model_config(dict(TINY, model={
        "dtype": "float32", "param_dtype": "float32"}))
    peft = PEFTConfig(method="fourierft", n=24, alpha=10.0,
                      target_modules=("wq", "wv", "wx", "wo_ssm"))
    model = build(cfg, peft, remat="full")
    state, frozen = ts.init_state(model, TrainConfig(), 0, device="cpu")
    step = ts.make_train_step(model, TrainConfig())
    batch = inputs.train_batch(SEED, 0, 2, 16, TINY["vocab_size"], "cpu")
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    t0 = time.time_ns()
    step(state, frozen, batch)
    t1 = time.time_ns()
    prof.stop()
    ranges = spans.program_ranges(trace.capture(prof, t0, t1))
    count = {}
    for r in ranges:
        key = (r.name, r.recompute)
        count[key] = count.get(key, 0) + 1
    assert count[(P + "layer", False)] == count[(P + "layer", True)] == 10
    assert count[(P + "shared", False)] >= 4      # forward and recompute
    assert count[(P + "ssd", False)] >= 16
    assert count[(P + "attention/direct", False)] >= 4
    assert count[(P + "adapter", False)] >= 1 + 4 * 2

    step_range = next(r for r in ranges if r.name == P + "step")
    assert all(step_range.start <= r.start and r.end <= step_range.end
               for r in ranges)


# ---------------------------------------------------------------------------
# A test-sized cell
# ---------------------------------------------------------------------------

def _root(tmp, concat: bool):
    """A test root plus the tiny zamba2 configuration, its cell and limits,
    as new files and new entries only; without `concat` the reference's
    shared block leaves the embeddings out."""
    root = tr.make_root(tmp)
    pb = root / "perfbench"
    shutil.copy(tr.DATA / "configs" / "tiny-zamba2.json", pb / "configs")
    shutil.copy(tr.DATA / "limits" / f"{CELL}.json", pb / "limits")
    if not concat:
        path = pb / "reference" / "zamba2.py"
        src = path.read_text()
        assert src.count("CONCAT_EMBEDDINGS = True") == 1
        path.write_text(src.replace("CONCAT_EMBEDDINGS = True",
                                    "CONCAT_EMBEDDINGS = False"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-zamba2", "source": "test",
                             "file": "perfbench/configs/tiny-zamba2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny-zamba2",
                               "traffic": "tiny-train", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny-dense-train" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("concat", [True, False],
                         ids=["sound", "reference_without_the_concat"])
def test_the_tiny_cell_is_correct_only_with_the_concat(tmp_path, concat):
    """The cell adapts the shared q/v, whose gradients read the block's
    input: a reference whose block leaves the embeddings out misses
    grad_gap's limit by 10x and more (limits and readings in
    data/limits/tiny-zamba2-train.json)."""
    root = _root(tmp_path, concat)
    assert spec.cell(root, CELL).family.model_config(TINY).zamba \
        .hybrid_layer_ids == (2, 5)
    res = runner.run_cell(root, CELL, SEED, 0.5, False, torch.device("cpu"),
                          t_start=time.perf_counter())
    assert res["correct"] is concat, res["checks"]
    if not concat:
        g = res["checks"]["grad_gap"]
        assert g["value"] > 5 * g["limit"]
