"""Plain PyTorch reference of Zamba2 (Zyphra, arXiv:2411.15242) as HF
transformers' `Zamba2ForCausalLM` computes it (`modeling_zamba2.py`):
Mamba2 layers, two (`num_mem_blocks`) shared transformer blocks applied in
turn before the hybrid layers, and a FourierFT ΔW added to each adapted
weight. Everything runs in float32; matrix products run with TF32 off
(`precise()`).

With h the residual stream, e the token embeddings and j the index of an
application (block b = j mod num_mem_blocks, before hybrid layer i):

    u   = RMSNorm_b(concat[h, e])
    q, k, v = u · Wq_b, u · Wk_b, u · Wv_b; RoPE (rotate-half) over head_dim
    a   = softmax(q kᵀ · (head_dim / 2) ** -0.5 + causal) v · Wo_b
    m   = RMSNorm'_b(a)
    [g, up] = m · Wgu_b + (m · A_j) · B_j
    s_j = ((GELU_erf(g) ⊙ up) · Wdown_b) · Lin_j
    h  <- h + Mamba_i(RMSNorm_i(h + s_j))        (s_j only at hybrid layer i)

and Mamba_i(x): z, x, B, C, dt from the in-projection; x, B, C through a
causal depthwise conv (width `mamba_d_conv`, with bias) and SiLU; dt =
softplus(dt + dt_bias), A = -exp(A_log); the SSD recurrence with head h
reading group h // (heads / groups), plus D·x; y = grouped
RMSNorm(y ⊙ SiLU(z)) (groups `mamba_ngroups`, eps 1e-5), then the
out-projection. The logits are RMSNorm(h) · Eᵀ (tied embeddings, the
config's default) or RMSNorm(h) · lm_head.

Departures from the HF module: dt is not clamped (HF's torch path clamps it
below at `time_step_min`; its kernel path applies `time_step_limit`, which
the published config leaves null, so no clamp); the SSD scan here is the
chunked form (`ssd`, chunk `chunk_size`; the sequence must be a multiple of
it); the in-projection is the layout's four matrices (wz, wx, wbc, wdt),
HF's `in_proj` rows in that order, and the gate/up projection is wg beside
wi. The layout is the benchmark's weight maker's: stacked (n, d_in, d_out)
matrices applied as `x @ W`, the mamba layers under `layers/`, the blocks
under `shared/` (stacked over the blocks), each application's LoRA and
linear under `apps/` (stacked over the applications). Adapted sites,
their coefficients, entries and gradients are keyed by the site's full
path ("shared/wq", "layers/wx"); a shared site has one coefficient row per
application. It imports nothing of the measured program.

The whole model is never held with activations for a backward pass:
`loss_and_grads` runs the forward layer by layer keeping only each layer's
input, then recomputes one layer (with its application, if any) at a time
backwards.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from reference import fourier
from reference.decoder import (LINEARS, plain_linear, precise,  # noqa: F401
                               rms_norm, rope)

F32 = torch.float32
# the shared block reads the embeddings beside the residual stream (its
# input is concat[h, e]); False leaves them out (the tests' fault)
CONCAT_EMBEDDINGS = True
GATED_NORM_EPS = 1e-5           # fixed in HF's Zamba2RMSNormGated


class Dims:
    """The sizes the reference reads from a configuration file."""

    def __init__(self, cfg: Dict):
        self.L = cfg["num_hidden_layers"]
        self.d = cfg["hidden_size"]
        self.V = cfg["vocab_size"]
        self.H = cfg["num_attention_heads"]
        self.K = cfg.get("num_key_value_heads", self.H)
        self.hd = cfg["attention_head_dim"]
        self.f = cfg["intermediate_size"]
        self.ids = tuple(cfg["hybrid_layer_ids"])
        self.M = cfg["num_mem_blocks"]
        self.di = cfg["mamba_expand"] * self.d
        self.Hs = cfg["n_mamba_heads"]
        self.P = cfg["mamba_headdim"]
        self.G = cfg["mamba_ngroups"]
        self.N = cfg["mamba_d_state"]
        self.Q = cfg["chunk_size"]
        self.theta = float(cfg["rope_theta"])
        self.eps = float(cfg["rms_norm_eps"])
        self.tied = cfg.get("tie_word_embeddings", True)
        ad = cfg["adapter"]
        self.n = ad["n"]
        self.alpha = float(ad["alpha"])
        self.entry_seed = ad["entry_seed"]
        prefix = {"wq": "shared", "wv": "shared", "wx": "layers",
                  "wo_ssm": "layers"}
        self.sites = tuple(f"{prefix[t]}/{t}" for t in ad["target_modules"])

    def site_shape(self, site: str) -> Tuple[int, int]:
        shapes = {"shared/wq": (2 * self.d, self.H * self.hd),
                  "shared/wv": (2 * self.d, self.K * self.hd),
                  "layers/wx": (self.d, self.di),
                  "layers/wo_ssm": (self.di, self.d)}
        if site not in shapes:
            raise ValueError(f"the reference adapts {sorted(shapes)}, not "
                             f"{site}")
        return shapes[site]


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


# ---------------------------------------------------------------------------
# The SSD scan
# ---------------------------------------------------------------------------

def _segsum(a: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = a[..., j+1] + ... + a[..., i] for j <= i, -inf
    above the diagonal; a (..., T)."""
    T = a.shape[-1]
    x = a[..., None].expand(*a.shape, T)             # x[..., m, j] = a[m]
    ones = torch.ones(T, T, dtype=torch.bool, device=a.device)
    x = torch.cumsum(x.masked_fill(~ones.tril(-1), 0.0), dim=-2)
    return x.masked_fill(~ones.tril(), -math.inf)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, D: torch.Tensor, chunk: int) -> torch.Tensor:
    """y of the selective state space recurrence

        s_t = exp(dt_t · A) s_{t-1} + dt_t · x_t ⊗ B_t
        y_t = s_t C_t + D x_t

    by chunks of `chunk` (Mamba2's SSD: the quadratic form inside a chunk,
    chunk states, a decay across chunks, the states' output). x (b, S, H,
    P), dt (b, S, H), A (H,), B/C (b, S, G, N), head h reading group
    h // (H / G), D (H,)."""
    b, S, H, P = x.shape
    G = B.shape[2]
    nc = S // chunk
    Bh = B.repeat_interleave(H // G, dim=2)
    Ch = C.repeat_interleave(H // G, dim=2)

    def chunks(t):
        return t.reshape(b, nc, chunk, *t.shape[2:])
    X, Bc, Cc = chunks(x * dt[..., None]), chunks(Bh), chunks(Ch)
    a = chunks(dt * A).permute(0, 3, 1, 2)                  # (b, H, nc, l)
    a_cum = torch.cumsum(a, dim=-1)
    # inside each chunk
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)
    decay = torch.exp(_segsum(a)).permute(0, 2, 1, 3, 4)    # (b, nc, H, l, s)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores * decay, X)
    # each chunk's state, carried across chunks
    to_end = torch.exp(a_cum[..., -1:] - a_cum)             # (b, H, nc, l)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bc, to_end, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    across = torch.exp(_segsum(F.pad(a_cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", across, states)[:, :-1]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Cc, states,
                         torch.exp(a_cum))
    return (y_diag + y_off).reshape(b, S, H, P) + x * D[:, None]


def ssd_recurrence(x, dt, A, B, C, D) -> torch.Tensor:
    """`ssd` one token at a time (the tests' oracle)."""
    b, S, H, P = x.shape
    G = B.shape[2]
    Bh = B.repeat_interleave(H // G, dim=2)
    Ch = C.repeat_interleave(H // G, dim=2)
    s = torch.zeros(b, H, P, B.shape[3], dtype=x.dtype, device=x.device)
    ys = []
    for t in range(S):
        s = (torch.exp(dt[:, t] * A)[..., None, None] * s
             + (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, t, :, None])
        ys.append(torch.einsum("bhpn,bhn->bhp", s, Ch[:, t]))
    return torch.stack(ys, dim=1) + x * D[:, None]


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def causal_attention(q, k, v, scale: float) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, S, K, hd) -> (B, S, H·hd); query head h
    reads kv head h // (H / K)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bthd->bhqt", q, k) * scale
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqt,bthd->bqhd", p, v).reshape(B, S, H * hd)


def _weights(tree: Dict, i: int, dw: Dict[str, torch.Tensor]):
    """Slice i of a stacked tree, in f32, with ΔW {leaf: (d1, d2)} added."""
    def w(name):
        t = tree[name][i].to(F32)
        return t + dw[name] if name in dw else t
    return w


def shared_block(h, e, base: Dict, j: int, dw: Dict, dims: Dims,
                 lin: Callable, pos) -> torch.Tensor:
    """s_j: application j of block j mod num_mem_blocks on h (B, S, d) and
    the embeddings e; dw: {leaf: ΔW} of its adapted q/v."""
    Bt, S, _ = h.shape
    w = _weights(base["shared"], j % dims.M, dw)
    app = _weights(base["apps"], j, {})
    # without the concat the block reads h alone, through the first d
    # rows of its norm and projections
    rows = slice(None) if CONCAT_EMBEDDINGS else slice(0, dims.d)
    x = torch.cat([h, e], dim=-1) if CONCAT_EMBEDDINGS else h
    u = rms_norm(x, w("attn_norm")[rows], dims.eps)
    q = lin(u, w("wq")[rows]).reshape(Bt, S, dims.H, dims.hd)
    k = lin(u, w("wk")[rows]).reshape(Bt, S, dims.K, dims.hd)
    v = lin(u, w("wv")[rows]).reshape(Bt, S, dims.K, dims.hd)
    q, k = rope(q, pos, dims.theta), rope(k, pos, dims.theta)
    a = lin(causal_attention(q, k, v, (dims.hd / 2) ** -0.5), w("wo"))
    m = rms_norm(a, w("mlp_norm"), dims.eps)
    gu = lin(m, torch.cat([w("wg"), w("wi")], dim=1)) \
        + lin(lin(m, app("mlp_lora_a")), app("mlp_lora_b"))
    act = F.gelu(gu[..., :dims.f]) * gu[..., dims.f:]
    return lin(lin(act, w("wo_mlp")), app("linear"))


def mamba(x, i: int, base: Dict, dw: Dict, dims: Dims,
          lin: Callable) -> torch.Tensor:
    """Mamba_i(x) on the normed input x (B, S, d); dw {leaf: ΔW}."""
    Bt, S, _ = x.shape
    lw = base["layers"]
    w = _weights(lw, i, dw)
    GN = dims.G * dims.N
    z = lin(x, w("wz"))
    xbc = torch.cat([lin(x, w("wx")), lin(x, w("wbc"))], dim=-1)
    dt = lin(x, w("wdt"))
    taps = w("conv_w")                                       # (C, width)
    xbc = F.conv1d(xbc.transpose(1, 2), taps[:, None, :], w("conv_b"),
                   padding=taps.shape[1] - 1, groups=taps.shape[0])
    xbc = F.silu(xbc[..., :S].transpose(1, 2))
    xs, Bm, Cm = torch.split(xbc, [dims.di, GN, GN], dim=-1)
    dt = F.softplus(dt + w("dt_bias"))
    A = -torch.exp(w("A_log"))
    y = ssd(xs.reshape(Bt, S, dims.Hs, dims.P), dt, A,
            Bm.reshape(Bt, S, dims.G, dims.N),
            Cm.reshape(Bt, S, dims.G, dims.N), w("Dp"), dims.Q)
    g = (y.reshape(Bt, S, dims.di) * F.silu(z)).reshape(Bt, S, dims.G, -1)
    g = g * torch.rsqrt((g * g).mean(-1, keepdim=True) + GATED_NORM_EPS)
    y = g.reshape(Bt, S, dims.di) * w("gnorm")
    return lin(y, w("wo_ssm"))


def unit(h, e, i: int, base: Dict, dw: Dict, dims: Dims, lin: Callable,
         pos) -> torch.Tensor:
    """Layer i, with the application before it if it is a hybrid layer.
    dw: {site: ΔW} of this layer's (and its application's) sites."""
    s = 0.0
    if i in dims.ids:
        sdw = {k.split("/")[-1]: v for k, v in dw.items()
               if k.startswith("shared/")}
        s = shared_block(h, e, base, dims.ids.index(i), sdw, dims, lin, pos)
    ldw = {k.split("/")[-1]: v for k, v in dw.items()
           if k.startswith("layers/")}
    hin = rms_norm(h + s, base["layers"]["norm"][i], dims.eps)
    return h + mamba(hin, i, base, ldw, dims, lin)


def row(site: str, i: int, dims: Dims) -> Optional[int]:
    """The coefficient row of `site` that layer i's unit reads (None: the
    unit reads none)."""
    if site.startswith("layers/"):
        return i
    return dims.ids.index(i) if i in dims.ids else None


def deltas(cs: Optional[Dict[str, torch.Tensor]], entries: Dict, i: int,
           dims: Dims) -> Dict[str, torch.Tensor]:
    """{site: ΔW} of layer i's unit for the coefficients cs {site: (n_rows,
    n)}."""
    out = {}
    for site, c in (cs or {}).items():
        r = row(site, i, dims)
        if r is not None:
            out[site] = fourier.delta_w(c[r], entries[site],
                                        *dims.site_shape(site), dims.alpha)
    return out


def head(base: Dict, h: torch.Tensor, dims: Dims, lin: Callable
         ) -> torch.Tensor:
    out = base["embed"].to(F32).T if dims.tied else base["lm_head"].to(F32)
    return lin(rms_norm(h, base["final_norm"], dims.eps), out)


def _embed(base: Dict, tokens: torch.Tensor, dims: Dims) -> torch.Tensor:
    return base["embed"].index_select(0, tokens.reshape(-1)).reshape(
        *tokens.shape, dims.d).to(F32)


# ---------------------------------------------------------------------------
# Training: loss and the coefficients' gradients
# ---------------------------------------------------------------------------

def loss_and_grads(base: Dict, cs: Dict[str, torch.Tensor], entries: Dict,
                   tokens: torch.Tensor, labels: torch.Tensor, dims: Dims,
                   lin: Callable = plain_linear
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """Mean token cross-entropy of the causal forward, and its gradient in
    every coefficient row."""
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    e = _embed(base, tokens, dims)
    xs: List[torch.Tensor] = [e]
    with torch.no_grad():
        for i in range(dims.L):
            xs.append(unit(xs[-1], e, i, base, deltas(cs, entries, i, dims),
                           dims, lin, pos))
    with torch.enable_grad():
        xl = xs.pop().requires_grad_(True)
        logits = head(base, xl, dims, lin)
        ce = F.cross_entropy(logits.reshape(-1, dims.V),
                             labels.reshape(-1).to(torch.int64))
        (gx,) = torch.autograd.grad(ce, [xl])
    loss = float(ce.detach())
    del logits, xl
    grads = {name: torch.zeros_like(c) for name, c in cs.items()}
    for i in reversed(range(dims.L)):
        xin = xs.pop().requires_grad_(True)
        with torch.enable_grad():
            live = {site: c[row(site, i, dims)].detach().clone()
                    .requires_grad_(True) for site, c in cs.items()
                    if row(site, i, dims) is not None}
            dw = {site: fourier.delta_w(c, entries[site],
                                        *dims.site_shape(site), dims.alpha)
                  for site, c in live.items()}
            out = unit(xin, e, i, base, dw, dims, lin, pos)
            names = sorted(live)
            got = torch.autograd.grad([out], [xin] + [live[n] for n in names],
                                      [gx])
        gx = got[0]
        for name, g in zip(names, got[1:]):
            grads[name][row(name, i, dims)] = g
    return loss, grads


# ---------------------------------------------------------------------------
# Serving: next-token logits over a whole sequence
# ---------------------------------------------------------------------------

@torch.no_grad()
def logits_at(base: Dict, cs: Optional[Dict[str, torch.Tensor]],
              entries: Dict, tokens: torch.Tensor, first: int, dims: Dims,
              lin: Callable = plain_linear) -> torch.Tensor:
    """Logits (S - first, V) that score tokens[first + 1:] and the token
    after the last: the causal forward of one sequence (S,)."""
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    e = _embed(base, tokens[None], dims)
    h = e
    for i in range(dims.L):
        h = unit(h, e, i, base, deltas(cs, entries, i, dims), dims, lin, pos)
    return head(base, h[0, first:], dims, lin)
