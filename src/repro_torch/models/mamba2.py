"""Mamba2 mixer via SSD (state-space duality, arXiv:2405.21060), the JAX
package's `models/mamba2.py`.

The chunked algorithm serves training and full-sequence forwards
(intra-chunk quadratic form, per-chunk states, then the inter-chunk
recurrence, which JAX runs as a `lax.scan` over chunks and this module as
one product with the chunks' decay matrix, the SSD paper's minimal form:
a handful of launches in place of a few per chunk); the decode step
carries an O(1) state. The SSD scan is not a Pallas kernel in the JAX
package (XLA computes it). Here `ssd_chunked` is its plain PyTorch
version, which the CPU, float64 tensors and the tests take; on the card
`ssd_scan` routes bf16 and f32 tensors to the hand-written kernel
(`kernels/ssd_scan.py`), the same f32 arithmetic with each chunk's
(Q, Q) tiles kept out of device memory.

Layout: x (B, S, H, P) with H = expand·d_model / head_dim, P = head_dim;
separate projections wz/wx/wbc/wdt instead of one fused in_proj, as in the
JAX package. The scan computes in f32 for bf16 and f32 inputs, as JAX
does, and in float64 for float64 inputs (the oracle the tests and the
chip smoke hold it to).

On a mesh (the projections' outputs are DTensors) the mixer between the
in- and out-projections — the causal conv, the gates, the SSD scan and
the decode recurrence — is per-channel and per-head work: it runs on
each rank's local shard (`_LocalHeads`): the batch rows it holds, and the
heads `wx`'s column shard over `model` gives it (all heads where `model`
does not divide them). B and C are shared by every head, so they are
gathered whole; the conv's per-channel taps and the per-head scalars are
sliced to the local channels. No sharding strategy is needed for the
scan's cumsum, segment sums and chunk product.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.spans import span
from repro_torch.dist.dtensor import is_dtensor, local_shape_and_offset
from repro_torch.kernels import ssd_scan as ssk
from repro_torch.models.common import dense_init, rms_norm


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads, head_dim, groups)."""
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    return d_inner, d_inner // ssm.head_dim, ssm.head_dim, ssm.n_groups


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def conv1d_causal(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: out[b,s,c] = b_c + Σ_i x[b, s-w+1+i, c]·w[c,i],
    each tap accumulated in f32. x (B, S, C), w (C, width), b (C,)."""
    width = w.shape[1]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + xp[:, i:i + S, :].to(torch.float32) \
            * w[:, i].to(torch.float32)
    return (out + b.to(torch.float32)).to(x.dtype)


def _segsum(dta: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: out[..., i, j] = Σ_{j < m <= i} dta[..., m], -inf
    for j > i. dta (..., Q). The difference is formed before the mask, as
    in JAX; the masked entries get no gradient through `where`."""
    Q = dta.shape[-1]
    cs = torch.cumsum(dta, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(Q, device=dta.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, diff, torch.full((), -math.inf, dtype=diff.dtype,
                                              device=diff.device))


def ssd_chunked(x, dt, A, B, C, D, *, chunk: int):
    """SSD forward. x (b, S, H, P); dt (b, S, H) (after softplus); A (H,)
    negative; B, C (b, S, G, N); D (H,). Returns y (b, S, H, P) in x's
    dtype and the final state (b, H, P, N) in the compute dtype."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk
    rep = H // G
    ct = _compute_dtype(x)

    xc = x.reshape(b, nc, chunk, H, P).to(ct)
    dtc = dt.reshape(b, nc, chunk, H).to(ct)
    Bc = B.reshape(b, nc, chunk, G, N).to(ct)
    Cc = C.reshape(b, nc, chunk, G, N).to(ct)

    dta = dtc * A.to(ct)                               # (b, nc, Q, H)
    dtx = xc * dtc[..., None]                          # dt-weighted inputs

    # intra-chunk (quadratic within the chunk)
    Lmat = torch.exp(_segsum(dta.movedim(3, 2)))       # (b, nc, H, Q, Q)
    scores = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)
    if G != H:                                         # head h: group h // rep
        scores = torch.repeat_interleave(scores, rep, dim=2)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores * Lmat, dtx)

    # chunk states
    cum = torch.cumsum(dta, dim=2)                     # (b, nc, Q, H)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    Bh = torch.repeat_interleave(Bc, rep, dim=3) if G != H else Bc
    states = torch.einsum("bcqhn,bcqhp->bchpn",
                          Bh * decay_to_end[..., None], dtx)

    # inter-chunk recurrence, as one product: the state entering chunk z
    # is Σ_{c<z} exp(Σ_{c<w<z} a_w)·states_c, a_w chunk w's log decay
    chunk_log = F.pad(torch.sum(dta, dim=2).movedim(2, 1), (1, 0))
    decay = torch.exp(_segsum(chunk_log))              # (b, H, nc+1, nc+1)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    entering = torch.einsum("bhzc,bchpn->bzhpn", decay, states)
    prev_states, s = entering[:, :-1], entering[:, -1]  # (b, nc, H, P, N)

    # inter-chunk output
    in_decay = torch.exp(cum)
    Ch = torch.repeat_interleave(Cc, rep, dim=3) if G != H else Cc
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", Ch * in_decay[..., None],
                         prev_states)

    y = (y_diag + y_off).reshape(b, S, H, P)
    y = y + x.to(ct) * D.to(ct)[None, None, :, None]
    return y.to(x.dtype), s


def ssd_scan(x, dt, A, B, C, D, *, chunk: int):
    """`ssd_chunked`'s signature and contract, by the route its inputs
    take: CUDA tensors of bf16 or f32 launch the kernel
    (`kernels/ssd_scan.py`, which raises on any other CUDA input but
    float64, and on a shape it does not take); CPU and float64 tensors run
    `ssd_chunked`."""
    if ssk.takes(x, dt, A, B, C, D):
        return ssk.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    return ssd_chunked(x, dt, A, B, C, D, chunk=chunk)


def ssd_recurrent_oracle(x, dt, A, B, C, D):
    """The per-token recurrence (test oracle): `ssd_chunked`'s signature and
    semantics, one state update per token."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    ct = _compute_dtype(x)
    Bh = torch.repeat_interleave(B, rep, dim=2).to(ct)
    Ch = torch.repeat_interleave(C, rep, dim=2).to(ct)
    dtf = dt.to(ct)
    xf = x.to(ct)
    Af = A.to(ct)
    state = torch.zeros((b, H, P, N), dtype=ct, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af)                 # (b, H)
        state = (state * decay[:, :, None, None]
                 + torch.einsum("bhn,bhp,bh->bhpn", Bh[:, t], xf[:, t],
                                dtf[:, t]))
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], state))
    y = torch.stack(ys, dim=1) + xf * D.to(ct)[None, None, :, None]
    return y.to(x.dtype), state


def init_mamba_params(gen: torch.Generator, cfg: ModelConfig, stack: int,
                      dtype, device) -> Dict:
    """One mamba2 block's params, stacked over `stack` layers (none when
    0). dt_bias, A_log and Dp are f32 whatever `dtype` is, as in JAX."""
    d = cfg.d_model
    ssm = cfg.ssm
    d_inner, H, P, G = dims(cfg)
    conv_ch = d_inner + 2 * G * ssm.state
    L = (stack,) if stack else ()
    f32 = torch.float32
    u = torch.rand(L + (H,), generator=gen, device=device, dtype=f32)
    dt0 = torch.exp(u * (math.log(ssm.dt_max) - math.log(ssm.dt_min))
                    + math.log(ssm.dt_min))
    return {
        "norm": torch.ones(L + (d,), dtype=dtype, device=device),
        "wz": dense_init(gen, L + (d, d_inner), dtype, device),
        "wx": dense_init(gen, L + (d, d_inner), dtype, device),
        "wbc": dense_init(gen, L + (d, 2 * G * ssm.state), dtype, device),
        "wdt": dense_init(gen, L + (d, H), dtype, device),
        "conv_w": dense_init(gen, L + (conv_ch, ssm.d_conv), dtype, device,
                             0.2),
        "conv_b": torch.zeros(L + (conv_ch,), dtype=dtype, device=device),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                          device=device))
        * torch.ones(L + (H,), dtype=f32, device=device),
        "Dp": torch.ones(L + (H,), dtype=f32, device=device),
        "gnorm": torch.ones(L + (d_inner,), dtype=dtype, device=device),
        "wo_ssm": dense_init(gen, L + (d_inner, d), dtype, device),
    }


def _plain_linear(p: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[name]


def gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
               eps: float, groups: int = 1) -> torch.Tensor:
    """RMSNorm of y · SiLU(z) over the last dim, or over each of its
    `groups` equal parts (Zamba2's grouped gated norm)."""
    g = y * F.silu(z.to(torch.float32)).to(y.dtype)
    if groups == 1:
        return rms_norm(g, w, eps)
    shape = g.shape
    return rms_norm(g.reshape(*shape[:-1], groups, shape[-1] // groups),
                    w.reshape(groups, -1), eps).reshape(shape)


def mamba_block(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                linear_fn=None, add=None, norm_groups: int = 1
                ) -> torch.Tensor:
    """One pre-norm mamba2 block over a sequence. x (B, S, d).
    `linear_fn(p, name, x)` lets the PEFT layer intercept the wz, wx and
    wo_ssm projections. softplus is torch's, which is the identity above
    20 where JAX's is not (they differ by less than 3e-9 there). `add`
    (B, S, d) joins the input before the norm and not the residual (a
    published Zamba2 hybrid layer); `norm_groups` groups the gated norm."""
    H = dims(cfg)[1]
    linear_fn = linear_fn or _plain_linear
    h = rms_norm(x if add is None else x + add, p["norm"], cfg.norm_eps)
    z = linear_fn(p, "wz", h)
    xin = linear_fn(p, "wx", h)
    bc = h @ p["wbc"]
    dt_raw = h @ p["wdt"]
    if is_dtensor(xin):
        loc = _LocalHeads(xin, cfg)
        y = loc.placed(_mixer(loc.taps(p), loc.heads(xin), loc.whole(bc),
                              loc.heads(dt_raw), cfg, loc.n_heads))
    else:
        y = _mixer(p, xin, bc, dt_raw, cfg, H)
    y = gated_norm(y, z, p["gnorm"], cfg.norm_eps, norm_groups)
    return x + linear_fn(p, "wo_ssm", y)


def _mixer(p: Dict, xin, bc, dt_raw, cfg: ModelConfig, H: int):
    """conv -> SiLU -> SSD over `H` heads: xin (B, S, H·P), bc (B, S,
    2·G·N), dt_raw (B, S, H); p's conv taps cover xin's channels then
    bc's, its per-head scalars the H heads. -> y (B, S, H·P)."""
    ssm = cfg.ssm
    P, G = ssm.head_dim, ssm.n_groups
    d_inner = H * P
    conv_out = conv1d_causal(torch.cat([xin, bc], dim=-1), p["conv_w"],
                             p["conv_b"])
    conv_out = F.silu(conv_out.to(torch.float32)).to(xin.dtype)
    xin = conv_out[..., :d_inner]
    bc = conv_out[..., d_inner:]
    B, S, _ = xin.shape
    Bmat = bc[..., :G * ssm.state].reshape(B, S, G, ssm.state)
    Cmat = bc[..., G * ssm.state:].reshape(B, S, G, ssm.state)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"].to(torch.float32))
    # the scan, forward and backward, lies in the range `ssd`
    with span("ssd") as sp:
        y, _ = ssd_scan(xin.reshape(B, S, H, P), dt, A, Bmat, Cmat,
                        p["Dp"], chunk=min(ssm.chunk, S))
        sp.backward(y)
    return y.reshape(B, S, d_inner)


class _LocalHeads:
    """The local shard of a mesh-placed mixer (module docstring), from
    `xin` (B, S, d_inner), a DTensor. `heads(t)` / `whole(t)` give the
    local tensor of a (B, S, ...) DTensor with its last dim on the local
    heads / whole; `taps(p)` the layer's conv taps and per-head scalars
    for the local channels; `placed(y)` puts a local (B, S, ...) result
    back as a DTensor of the heads' placement."""

    def __init__(self, xin, cfg: ModelConfig):
        from torch.distributed.tensor import Replicate, Shard
        d_inner, H, P, _ = dims(cfg)
        self.cfg, self.d_inner, self.P = cfg, d_inner, P
        mesh = self.mesh = xin.device_mesh
        names = mesh.mesh_dim_names or ()
        batch = [Shard(0) if q.is_shard(0) else Replicate()
                 for q in xin.placements]
        self.whole_pl = batch
        heads = list(batch)
        if "model" in names:
            i = names.index("model")
            if mesh.size(i) > 1 and H % mesh.size(i) == 0:
                heads[i] = Shard(xin.ndim - 1)
        self.heads_pl = heads
        lshape, off = local_shape_and_offset(xin.shape, mesh, heads)
        self.c0, self.nc = off[-1], lshape[-1]      # local x channels
        self.n_heads = self.nc // P

    def heads(self, t):
        return t.redistribute(self.mesh, self.heads_pl).to_local()

    def whole(self, t):
        """Whole along the last dim: every rank's heads read all of it, so
        its gradient on a rank is that rank's heads' term of the whole."""
        from repro_torch.dist.dtensor import summed_grad_placements
        split = [i for i, (a, b) in enumerate(zip(self.heads_pl,
                                                   self.whole_pl)) if a != b]
        return t.redistribute(self.mesh, self.whole_pl).to_local(
            grad_placements=summed_grad_placements(self.whole_pl, split))

    def taps(self, p: Dict) -> Dict:
        def full(t):
            return t.full_tensor() if is_dtensor(t) else t
        c0, nc, d = self.c0, self.nc, self.d_inner
        h0, nh = c0 // self.P, self.n_heads
        w, b = full(p["conv_w"]), full(p["conv_b"])
        return {"conv_w": torch.cat([w[c0:c0 + nc], w[d:]]),
                "conv_b": torch.cat([b[c0:c0 + nc], b[d:]]),
                **{k: full(p[k])[h0:h0 + nh]
                   for k in ("dt_bias", "A_log", "Dp")}}

    def placed(self, y, placements=None):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(y, self.mesh, placements or self.heads_pl,
                                  run_check=False)

    def _head_dim_pl(self, dim: int):
        from torch.distributed.tensor import Shard
        return [Shard(dim) if q.is_shard() and not q.is_shard(0) else q
                for q in self.heads_pl]

    def conv_cache(self, conv):
        """A (B, w-1, C) conv history in the local channel layout."""
        c = self.whole(conv)
        c0, nc, d = self.c0, self.nc, self.d_inner
        return torch.cat([c[..., c0:c0 + nc], c[..., d:]], dim=-1)

    def ssm_cache(self, state):
        """A (B, H, P, N) state on the local heads."""
        return state.redistribute(self.mesh,
                                  self._head_dim_pl(1)).to_local()

    def conv_back(self, new_conv, like):
        """A local-layout conv history back in `like`'s placement."""
        nc = self.nc
        xs = self.placed(new_conv[..., :nc].contiguous(),
                         self._head_dim_pl(2))
        xs = xs.redistribute(self.mesh, self.whole_pl).to_local()
        whole = torch.cat([xs, new_conv[..., nc:]], dim=-1)
        return self.placed(whole, self.whole_pl).redistribute(
            self.mesh, like.placements)

    def ssm_back(self, state, like):
        return self.placed(state, self._head_dim_pl(1)).redistribute(
            self.mesh, like.placements)


def init_mamba_cache(cfg: ModelConfig, stack: int, batch: int, dtype,
                     device) -> Dict:
    """conv (stack, B, d_conv - 1, C) in `dtype`; ssm (stack, B, H, P, N)
    in f32."""
    ssm = cfg.ssm
    d_inner, H, P, G = dims(cfg)
    conv_ch = d_inner + 2 * G * ssm.state
    return {
        "conv": torch.zeros((stack, batch, ssm.d_conv - 1, conv_ch),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((stack, batch, H, P, ssm.state),
                           dtype=torch.float32, device=device),
    }


def mamba_decode_step(p: Dict, cache: Dict, x: torch.Tensor,
                      cfg: ModelConfig, linear_fn=None, add=None,
                      norm_groups: int = 1):
    """One token. x (B, 1, d); cache {conv (B, w-1, C), ssm (B, H, P, N)}
    (one layer's slices, read only). Returns (y (B, 1, d), new cache); the
    conv history keeps the cache's dtype. `add` and `norm_groups` as in
    `mamba_block`."""
    H = dims(cfg)[1]
    linear_fn = linear_fn or _plain_linear
    h = rms_norm(x if add is None else x + add, p["norm"],
                 cfg.norm_eps)[:, 0]                          # (B, d)
    z = linear_fn(p, "wz", h)
    xin = linear_fn(p, "wx", h)
    bc = h @ p["wbc"]
    dt_raw = h @ p["wdt"]
    if is_dtensor(xin):
        loc = _LocalHeads(xin, cfg)
        y, new_conv, state = _decode_mixer(
            loc.taps(p), loc.conv_cache(cache["conv"]),
            loc.ssm_cache(cache["ssm"]), loc.heads(xin), loc.whole(bc),
            loc.heads(dt_raw), cfg, loc.n_heads)
        y = loc.placed(y.to(x.dtype))
        new = {"conv": loc.conv_back(new_conv, cache["conv"]),
               "ssm": loc.ssm_back(state, cache["ssm"])}
    else:
        y, new_conv, state = _decode_mixer(p, cache["conv"], cache["ssm"],
                                           xin, bc, dt_raw, cfg, H)
        y = y.to(x.dtype)
        new = {"conv": new_conv, "ssm": state}
    y = gated_norm(y, z, p["gnorm"], cfg.norm_eps, norm_groups)
    out = x + linear_fn(p, "wo_ssm", y)[:, None, :]
    return out, new


def _decode_mixer(p: Dict, conv, ssm_state, xin, bc, dt_raw,
                  cfg: ModelConfig, H: int):
    """One token's conv and SSD recurrence over `H` heads (the layout of
    `_mixer`). -> (y (B, H·P) f32, new conv history, new state)."""
    ssm = cfg.ssm
    P, G = ssm.head_dim, ssm.n_groups
    d_inner = H * P
    B = xin.shape[0]
    cache = {"conv": conv, "ssm": ssm_state}
    conv_in = torch.cat([xin, bc], dim=-1)                    # (B, C)
    hd = torch.promote_types(cache["conv"].dtype, conv_in.dtype)
    hist = torch.cat([cache["conv"].to(hd), conv_in[:, None, :].to(hd)],
                     dim=1)
    conv_out = torch.einsum("bwc,cw->bc", hist.to(torch.float32),
                            p["conv_w"].to(torch.float32)) \
        + p["conv_b"].to(torch.float32)
    conv_out = F.silu(conv_out).to(xin.dtype)
    new_conv = hist[:, 1:, :].to(cache["conv"].dtype)
    xin = conv_out[..., :d_inner].reshape(B, H, P)
    bc = conv_out[..., d_inner:]
    Bmat = bc[..., :G * ssm.state].reshape(B, G, ssm.state)
    Cmat = bc[..., G * ssm.state:].reshape(B, G, ssm.state)
    rep = H // G
    Bh = torch.repeat_interleave(Bmat, rep, dim=1).to(torch.float32)
    Ch = torch.repeat_interleave(Cmat, rep, dim=1).to(torch.float32)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])  # (B, H)
    A = -torch.exp(p["A_log"].to(torch.float32))
    decay = torch.exp(dt * A)
    xf = xin.to(torch.float32)
    state = (cache["ssm"] * decay[:, :, None, None]
             + torch.einsum("bhn,bhp,bh->bhpn", Bh, xf, dt))
    y = torch.einsum("bhn,bhpn->bhp", Ch, state)
    y = (y + xf * p["Dp"][None, :, None]).reshape(B, d_inner)
    return y, new_conv, state
