"""Plain PyTorch reference of a decoder-only language model: RMSNorm,
rotary embeddings (rotate-half, HF Llama's convention), grouped-query
causal attention, a SwiGLU MLP, and a FourierFT ΔW added to each adapted
weight. Everything runs in float32; matrix products run with TF32 off
(`precise()`).

It reads a configuration file of the benchmark (the published keys, and
the `model` block that states how the measured program runs them) and
weights that the benchmark made, in the layout of the benchmark's weight
maker: stacked (L, d_in, d_out) matrices applied as `x @ W`. It imports
nothing of the measured program and takes nothing that it made. Adapted
sites, their coefficients, entries and gradients are keyed by the site's
full path in that layout ("layers/wq").

The whole model is never held with activations for a backward pass:
`loss_and_grads` runs the forward layer by layer keeping only each layer's
input, then recomputes one layer at a time backwards.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from reference import fourier

F32 = torch.float32


def precise() -> None:
    """float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def plain_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def fp8_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the arithmetic of an fp8 linear layer: both operands rounded
    to float8 e4m3 under one scale per tensor (amax / 448), and in the
    backward the incoming gradient rounded to e5m2 (amax / 57344) before
    both of its products; products and sums in float32."""
    return _Fp8Linear.apply(x, w)


def _round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).to(F32) * scale


def _e4m3(t):
    return _round(t, torch.float8_e4m3fn, 448.0)


def _e5m2(t):
    return _round(t, torch.float8_e5m2, 57344.0)


class _Fp8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        qx, qw = _e4m3(x), _e4m3(w)
        ctx.save_for_backward(qx, qw)
        return qx @ qw

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        qg = _e5m2(g)
        gx = qg @ qw.T
        gw = (qx.reshape(-1, qx.shape[-1]).T
              @ qg.reshape(-1, qg.shape[-1])).reshape(qw.shape)
        return gx, gw


LINEARS: Dict[str, Callable] = {"float32": plain_linear,
                                "fp8": fp8_linear}


class Dims:
    """The sizes the reference reads from a configuration file."""

    def __init__(self, cfg: Dict):
        m = cfg.get("model", {})
        self.L = cfg["num_hidden_layers"]
        self.d = cfg["hidden_size"]
        self.H = cfg["num_attention_heads"]
        self.K = cfg.get("num_key_value_heads", self.H)
        self.hd = m.get("head_dim", self.d // self.H)
        self.V = cfg["vocab_size"]
        self.theta = float(cfg["rope_theta"])
        self.eps = float(cfg["rms_norm_eps"])
        ad = cfg["adapter"]
        self.n = ad["n"]
        self.alpha = float(ad["alpha"])
        self.entry_seed = ad["entry_seed"]
        self.sites = tuple(f"layers/{t}" for t in ad["target_modules"])

    def site_shape(self, site: str) -> Tuple[int, int]:
        out = {"layers/wq": self.H * self.hd, "layers/wk": self.K * self.hd,
               "layers/wv": self.K * self.hd}
        if site not in out:
            raise ValueError(f"the reference adapts q/k/v only, not {site}")
        return self.d, out[site]


def entries_for(dims: Dims, device) -> Dict[str, torch.Tensor]:
    """{site: (2, n) int64 entries} by the frozen entry rule."""
    out = {}
    for site in dims.sites:
        d1, d2 = dims.site_shape(site)
        e = fourier.sample_entries(d1, d2, dims.n,
                                   fourier.entry_seed(dims.entry_seed, d1,
                                                      d2))
        out[site] = torch.from_numpy(e).to(device)
    return out


def leaf(site: str) -> str:
    """The weight a site adapts within its layer: "layers/wq" -> "wq"."""
    return site.split("/")[-1]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.to(F32)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, N, hd); pos (S,) positions."""
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=F32, device=x.device)
                           / half))
    ang = pos.to(F32)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, S, K, hd) -> (B, S, H·hd); query head h
    reads kv head h // (H / K)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bthd->bhqt", q, k) / math.sqrt(hd)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqt,bthd->bqhd", p, v).reshape(B, S, H * hd)


def layer(x: torch.Tensor, lw: Dict, dw: Dict[str, torch.Tensor],
          dims: Dims, lin: Callable, pos: torch.Tensor) -> torch.Tensor:
    """One pre-norm block. lw: this layer's weights; dw: {leaf: ΔW}."""
    B, S, _ = x.shape

    def w(name):
        t = lw[name].to(F32)
        return t + dw[name] if name in dw else t

    h = rms_norm(x, lw["attn_norm"], dims.eps)
    q = lin(h, w("wq")).reshape(B, S, dims.H, dims.hd)
    k = lin(h, w("wk")).reshape(B, S, dims.K, dims.hd)
    v = lin(h, w("wv")).reshape(B, S, dims.K, dims.hd)
    q, k = rope(q, pos, dims.theta), rope(k, pos, dims.theta)
    x = x + lin(causal_attention(q, k, v), w("wo"))
    h = rms_norm(x, lw["mlp_norm"], dims.eps)
    a = torch.nn.functional.silu(lin(h, w("wg"))) * lin(h, w("wi"))
    return x + lin(a, w("wo_mlp"))


def layer_weights(base: Dict, li: int) -> Dict:
    return {k: v[li] for k, v in base["layers"].items()}


def deltas(cs: Optional[Dict[str, torch.Tensor]], entries: Dict, li: int,
           dims: Dims) -> Dict[str, torch.Tensor]:
    """{leaf: ΔW of layer li} for the coefficients cs {site: (L, n)}."""
    if cs is None:
        return {}
    out = {}
    for site, c in cs.items():
        d1, d2 = dims.site_shape(site)
        out[leaf(site)] = fourier.delta_w(c[li], entries[site], d1, d2,
                                          dims.alpha)
    return out


def head(base: Dict, x: torch.Tensor, dims: Dims, lin: Callable
         ) -> torch.Tensor:
    return lin(rms_norm(x, base["final_norm"], dims.eps),
               base["lm_head"].to(F32))


# ---------------------------------------------------------------------------
# Training: loss and the coefficients' gradients
# ---------------------------------------------------------------------------

def loss_and_grads(base: Dict, cs: Dict[str, torch.Tensor], entries: Dict,
                   tokens: torch.Tensor, labels: torch.Tensor, dims: Dims,
                   lin: Callable = plain_linear, block: Callable = layer
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """Mean token cross-entropy of the causal forward, and its gradient in
    every coefficient (L, n). `block` is the layer (`layer`'s arguments)."""
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    xs: List[torch.Tensor] = [base["embed"].index_select(
        0, tokens.reshape(-1)).reshape(*tokens.shape, dims.d).to(F32)]
    with torch.no_grad():
        for li in range(dims.L):
            xs.append(block(xs[-1], layer_weights(base, li),
                            deltas(cs, entries, li, dims), dims, lin, pos))
    with torch.enable_grad():
        xl = xs.pop().requires_grad_(True)
        logits = head(base, xl, dims, lin)
        ce = torch.nn.functional.cross_entropy(
            logits.reshape(-1, dims.V), labels.reshape(-1).to(torch.int64))
        (gx,) = torch.autograd.grad(ce, [xl])
    loss = float(ce.detach())
    del logits, xl
    grads = {name: torch.zeros_like(c) for name, c in cs.items()}
    for li in reversed(range(dims.L)):
        xin = xs.pop().requires_grad_(True)
        with torch.enable_grad():
            live = {site: c[li].detach().clone().requires_grad_(True)
                    for site, c in cs.items()}
            dw = {leaf(site): fourier.delta_w(live[site], entries[site],
                                              *dims.site_shape(site),
                                              dims.alpha)
                  for site in live}
            out = block(xin, layer_weights(base, li), dw, dims, lin, pos)
            names = sorted(live)
            got = torch.autograd.grad([out], [xin] + [live[n] for n in names],
                                      [gx])
        gx = got[0]
        for name, g in zip(names, got[1:]):
            grads[name][li] = g
    return loss, grads


# ---------------------------------------------------------------------------
# Serving: next-token logits over a whole sequence
# ---------------------------------------------------------------------------

@torch.no_grad()
def logits_at(base: Dict, cs: Optional[Dict[str, torch.Tensor]],
              entries: Dict, tokens: torch.Tensor, first: int, dims: Dims,
              lin: Callable = plain_linear, block: Callable = layer
              ) -> torch.Tensor:
    """Logits (S - first, V) that score tokens[first + 1:] and the token
    after the last: the causal forward of one sequence (S,)."""
    S = tokens.shape[0]
    pos = torch.arange(S, device=tokens.device)
    x = base["embed"].index_select(0, tokens).to(F32)[None]
    for li in range(dims.L):
        x = block(x, layer_weights(base, li), deltas(cs, entries, li, dims),
                  dims, lin, pos)
    return head(base, x[0, first:], dims, lin)
