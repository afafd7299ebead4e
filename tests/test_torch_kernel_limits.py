"""The kernel registry refuses, at resolution, a CUDA-resident site beyond a
kernel's shape limits, naming the limit; nothing degrades to the plain
version on the card, and the same sites resolve to the plain version on the
CPU. Resolution needs no card: these run everywhere."""
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import PEFTConfig
from repro_torch.core.adapter import AdapterSite
from repro_torch.kernels import api as kernel_api
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import build, transformer

Unavailable = kernel_api.KernelUnavailableError


@pytest.mark.parametrize("method", ["fourierft", "dct"])
@pytest.mark.parametrize("d1,d2,n,limit", [
    (4096, 4096, 20000, "16384"),          # the scatter plan's n
    (64, 29057, 64, "29056"),              # one f32 complex row in smem
    (64, 67 * 8, 64, "63"),                # the generic radix stage
    (65536, 64, 64, "65535"),              # the row phase
])
def test_deltaw_beyond_fft_plan_refused_on_cuda(method, d1, d2, n, limit):
    peft = PEFTConfig(method=method, n=n)
    with pytest.raises(Unavailable, match=limit):
        kernel_api.resolve_op("deltaw", method, peft, d1, d2, device="cuda")
    op = kernel_api.resolve_op("deltaw", method, peft, d1, d2, device="cpu")
    assert op.backend == "einsum"


@pytest.mark.parametrize("method", ["fourierft", "dct"])
@pytest.mark.parametrize("d1,d2", [(4096, 4096), (4096, 11008),
                                   (5120, 27648), (5120, 5120)])
def test_deltaw_within_fft_plan_resolves_to_cuda(method, d1, d2):
    peft = PEFTConfig(method=method, n=16384)
    assert kernel_api.resolve_op("deltaw", method, peft, d1, d2,
                                 device="cuda").backend == "cuda"


@pytest.mark.parametrize("dh,dtype,limit", [
    (512, torch.bfloat16, "256"), (257, torch.float32, "256"),
    (128, torch.float16, "float16"), (64, torch.float64, "float64")])
def test_paged_attention_beyond_its_limits_refused_on_cuda(dh, dtype, limit):
    with pytest.raises(Unavailable, match=limit):
        kernel_api.resolve_op("paged_attention", pa.OWNER, PEFTConfig(), 4,
                              dh, device="cuda", dtype=dtype)
    assert kernel_api.resolve_op("paged_attention", pa.OWNER, PEFTConfig(),
                                 4, dh, device="cpu",
                                 dtype=dtype).backend == "einsum"


@pytest.mark.parametrize("dh", [1, 16, 17, 80, 112, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, None])
def test_paged_attention_head_dims_resolve_to_cuda(dh, dtype):
    assert kernel_api.resolve_op("paged_attention", pa.OWNER, PEFTConfig(),
                                 4, dh, device="cuda",
                                 dtype=dtype).backend == "cuda"


def test_reduced_models_resolve_the_kernel():
    """configs.reduced gives head_dim 16, which the kernel once refused; the
    op the scheduler resolves for it on the card is the kernel."""
    cfg = configs.reduced(configs.get("yi-6b"))
    assert cfg.head_dim == 16
    for dtype in (torch.float32, torch.bfloat16):
        op = transformer.paged_attention_op(cfg, PEFTConfig(), "cuda", dtype)
        assert op.backend == "cuda" and op.fn is pa.paged_attention
    with pytest.raises(Unavailable, match="512"):
        transformer.paged_attention_op(cfg.replace(head_dim=512),
                                       PEFTConfig(), "cuda", torch.bfloat16)


@pytest.mark.parametrize("method", ["fourierft", "dct"])
def test_policy_refuses_an_over_limit_site_before_any_launch(method):
    """`KernelPolicy.build(..., device="cuda").validate()`, which the Engine
    runs at construction, refuses a site beyond the plan; on the CPU the
    same sites resolve to the plain version."""
    sites = (AdapterSite("layers/wq", 64, 64, 2),
             AdapterSite("layers/wv", 64, 67 * 8, 2))
    peft = PEFTConfig(method=method, n=64)
    with pytest.raises(Unavailable, match="63"):
        kernel_api.KernelPolicy.build(method, sites, peft, "cuda").validate()
    ok = kernel_api.KernelPolicy.build(method, sites[:1], peft,
                                       "cuda").validate()
    assert [r.backend for r in ok.resolutions if r.op == "deltaw"] \
        == ["cuda"]
    # the factored and bank applies are einsum only, on the card too
    assert {(r.op, r.backend) for r in ok.resolutions if r.op != "deltaw"} \
        == {("factored_apply", "einsum"), ("bank_apply", "einsum")}
    cpu = kernel_api.KernelPolicy.build(method, sites, peft, "cpu").validate()
    assert {r.backend for r in cpu.resolutions} == {"einsum"}
    with pytest.raises(Unavailable, match="16384"):
        kernel_api.KernelPolicy.build(method, sites[:1],
                                      peft.replace(n=20000),
                                      "cuda").validate()


def test_model_policy_on_cuda_for_the_slices_models():
    """yi-6b's wq (4096x4096) and wv (4096x512) sit inside the plan."""
    model = build(configs.get("yi-6b"), PEFTConfig(n=1000))
    policy = model.kernel_policy("cuda").validate()
    assert {r.backend for r in policy.resolutions if r.op == "deltaw"} \
        == {"cuda"}
    assert {r.backend for r in policy.resolutions if r.op != "deltaw"} \
        == {"einsum"}


def test_model_resolves_the_paged_attention_once():
    """`Model.paged_attention` resolves the op once per (device type,
    dtype) and keeps it for every decode step; a head_dim the kernel
    cannot take refuses there, before any step."""
    cfg = configs.reduced(configs.get("yi-6b"))
    model = build(cfg, PEFTConfig())
    fn = model.paged_attention("cuda", torch.bfloat16)
    assert fn is pa.paged_attention
    assert model._paged_fns == {("cuda", torch.bfloat16): fn}
    assert model.paged_attention("cuda:0", torch.bfloat16) is fn
    assert model.paged_attention("cpu", torch.float32) \
        is pa.paged_attention_reference
    wide = build(cfg.replace(head_dim=512), PEFTConfig())
    with pytest.raises(Unavailable, match="512"):
        wide.paged_attention("cuda", torch.bfloat16)
