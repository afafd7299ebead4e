"""Zamba2 as published (`configs.base.Zamba2Published`) in the port against
the benchmark's plain reference (`perfbench/reference/zamba2.py`, which its
own tests hold to HF transformers' `Zamba2ForCausalLM`), on the CPU at a
tiny size: 8 layers, two shared blocks applied in turn before layers 2
and 5, two mamba groups, a rank-4 MLP LoRA, tied embeddings, in f32.

The port runs through `models.build` with FourierFT on all four sites (the
shared q/v factored, one row per application; wx/wo_ssm merged or
factored). The reference computes the same mathematics in another order
(ΔW materialised by an inverse FFT, its own chunked scan, the gate/up and
in-projections as one matrix each), so f32 results agree to rounding:
logits within 1e-5 of the largest, the loss within 1e-6 relative, each
site's coefficient gradient within 1e-4 of its largest entry."""
import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO / "perfbench") not in sys.path:
    sys.path.insert(0, str(REPO / "perfbench"))

from harness import inputs, spec  # noqa: E402

from repro_torch.configs.base import PEFTConfig  # noqa: E402
from repro_torch.core import peft as peft_mod  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import build, mamba2, zamba2  # noqa: E402

TINY = json.loads(
    (REPO / "perfbench/tests/data/configs/tiny-zamba2.json").read_text())
TINY = dict(TINY, model={"dtype": "float32", "param_dtype": "float32"})
FAMILY = spec.family(TINY, REPO)
REF = spec.reference(TINY, REPO)
SITES = ("wq", "wv", "wx", "wo_ssm")
SEED = 11


@pytest.fixture(scope="module")
def weights():
    """f32 base weights in the benchmark's layout (the mamba layers'
    ones-leaves moved off 1), coefficients for the four sites, a batch."""
    base = inputs.make_base(FAMILY.base_layout(TINY), SEED, "cpu",
                            dtype=torch.float32)
    g = torch.Generator().manual_seed(SEED)
    for k in ("norm", "gnorm", "conv_b", "dt_bias", "A_log", "Dp"):
        t = base["layers"][k]
        base["layers"][k] = t + 0.3 * torch.rand(t.shape, generator=g)
    cfg = dict(TINY, adapter=dict(TINY["adapter"], target_modules=SITES))
    c0 = inputs.make_coeffs(FAMILY.adapted_sites(cfg), 24, SEED, "cpu")
    batch = inputs.train_batch(SEED, 0, 2, 32, TINY["vocab_size"], "cpu")
    dims = REF.Dims(cfg)
    return base, c0, batch, dims, REF.entries_for(dims, "cpu")


def _port(weights, strategy="merged", remat="full"):
    base, c0, *_ = weights
    peft = PEFTConfig(method="fourierft", n=24, alpha=300.0,
                      entry_seed=2024, target_modules=SITES,
                      strategy=strategy)
    model = build(FAMILY.model_config(TINY), peft, remat=remat)
    ads = peft_mod.init_adapters(torch.Generator(), model.sites, peft, "cpu")
    cs = {k: c.clone().requires_grad_(True) for k, c in c0.items()}
    for k, ad in ads.items():
        ad["c"] = cs[k]
    return model, {"base": base, "peft": ads}, cs


def test_sites_and_groups_of_the_published_wiring(weights):
    model, _, _ = _port(weights)
    assert [(s.name, s.d_in, s.d_out, s.stack) for s in model.sites] == [
        ("shared/wq", 64, 64, 2), ("shared/wv", 64, 64, 2),
        ("layers/wx", 32, 64, 8), ("layers/wo_ssm", 64, 32, 8)]
    assert zamba2.n_apps(model.cfg) == 2
    assert zamba2._published_groups(model.cfg) == [
        (None, [0, 1]), (0, [2, 3, 4]), (1, [5, 6, 7])]


@pytest.mark.parametrize("strategy", ["merged", "factored"])
def test_forward_and_loss_match_the_reference(weights, strategy):
    base, c0, batch, dims, entries = weights
    model, params, cs = _port(weights, strategy)
    for site, ad in params["peft"].items():
        assert torch.equal(ad["entries"].to(torch.int64), entries[site])
    with torch.no_grad():
        logits = model.forward(params, batch)
        loss = model.loss(params, batch)
    for b in range(batch["tokens"].shape[0]):
        want = REF.logits_at(base, c0, entries,
                             batch["tokens"][b].to(torch.int64), 0, dims)
        assert (logits[b] - want).abs().max() <= 1e-5 * want.abs().max()
    want, _ = REF.loss_and_grads(base, c0, entries, batch["tokens"],
                                 batch["labels"], dims)
    assert float(loss) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("strategy", ["merged", "factored"])
def test_gradients_match_the_reference(weights, strategy):
    """remat full (every group checkpointed and re-entered); each site's
    gradient within 1e-4 of its largest entry: the shared sites' are about
    1e-7 (the block's output reaches the loss through four 0.02-scale
    products at these widths), the mamba sites' 1e-3 to 1e-2."""
    base, c0, batch, dims, entries = weights
    model, params, cs = _port(weights, strategy)
    names = sorted(cs)
    got = torch.autograd.grad(model.loss(params, batch),
                              [cs[n] for n in names])
    _, want = REF.loss_and_grads(base, c0, entries, batch["tokens"],
                                 batch["labels"], dims)
    for name, g in zip(names, got):
        assert (g - want[name]).abs().max() <= \
            1e-4 * want[name].abs().max(), name


def test_remat_modes_give_equal_gradients(weights):
    _, _, batch, *_ = weights
    grads = []
    for remat in ("none", "dots", "full"):
        model, params, cs = _port(weights, remat=remat)
        names = sorted(cs)
        grads.append(torch.autograd.grad(model.loss(params, batch),
                                         [cs[n] for n in names]))
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-12)


def test_decode_after_prefill_matches_the_forward(weights):
    """The lockstep decode (one KV cache per application, the mamba layers'
    conv and SSM state) after a prefill of 20 tokens gives the forward's
    logits at the next 12 positions, to f32 rounding."""
    _, _, batch, *_ = weights
    model, params, _ = _port(weights, strategy="factored")
    tokens = batch["tokens"]
    with torch.no_grad():
        full = model.forward(params, {"tokens": tokens})
        cache = model.init_cache(tokens.shape[0], 32, torch.float32, "cpu")
        _, cache = model.prefill(params, cache, {"tokens": tokens[:, :20]})
        assert cache["attn_k"].shape == (2, 2, 32, 4, 16)
        for t in range(20, 32):
            logits, cache = model.decode_logits(
                params, cache, {"tokens": tokens[:, t:t + 1]})
            assert (logits[:, 0] - full[:, t]).abs().max() <= \
                1e-5 * full[:, t].abs().max(), t


@pytest.mark.parametrize("path", ["direct", "flash", "chunked"])
def test_attention_takes_an_explicit_scale(path):
    """`attention(..., scale=s)` on each path equals the default scale on
    queries multiplied by s·sqrt(dh), forward and backward: the scores are
    f32 on every path, and the two round the factor in different places,
    so to 1e-5."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 96, 4, 16, generator=g)
    k = torch.randn(2, 96, 2, 16, generator=g)
    v = torch.randn(2, 96, 2, 16, generator=g)
    s = 0.37
    kw = {"direct": {}, "flash": {"direct_threshold": 32, "chunk": 32},
          "chunked": {"direct_threshold": 32, "chunk": 64}}[path]
    qa = q.clone().requires_grad_(True)
    qb = q.clone().requires_grad_(True)
    a = attn_mod.attention(qa, k, v, scale=s, **kw)
    b = attn_mod.attention(qb * (s * 16 ** 0.5), k, v, **kw)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    ga, = torch.autograd.grad(a.square().sum(), qa)
    gb, = torch.autograd.grad(b.square().sum(), qb)
    torch.testing.assert_close(ga, gb, rtol=1e-5, atol=1e-5)


def test_grouped_gated_norm_normalises_each_group():
    g = torch.Generator().manual_seed(1)
    y, z = torch.randn(3, 5, 12, generator=g), torch.randn(3, 5, 12,
                                                          generator=g)
    w = torch.rand(12, generator=g)
    out = mamba2.gated_norm(y, z, w, 1e-5, groups=3)
    x = (y * torch.nn.functional.silu(z)).reshape(3, 5, 3, 4)
    want = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-5)
    torch.testing.assert_close(out, want.reshape(3, 5, 12) * w)
    torch.testing.assert_close(mamba2.gated_norm(y, z, w, 1e-5, groups=1),
                               mamba2.rms_norm(y * torch.nn.functional.silu(
                                   z), w, 1e-5))
