"""Mamba2 SSD (state-space duality) block: chunked-scan prefill, O(1) decode
(port of `repro.models.ssm`).

Chunked SSD (Dao & Gu 2024): within a chunk of length Q the recurrence

    h_t = exp(a_t) h_{t-1} + dt_t B_t x_t,     y_t = C_t . h_t + D x_t

is evaluated with quadratic-in-Q einsums (intra-chunk term via the decay
matrix L[i,j] = exp(cum_i - cum_j), i >= j), while chunk-to-chunk states are
carried by a loop over chunks: O(S*Q) work and O(S) memory.  Decode is a
single recurrent state update per token.

Conventions: d_inner = expand*d_model; H = d_inner/P heads of dim P; B/C in
G groups of state dim N shared across H/G heads; depthwise causal conv of
width W over the concatenated (x, B, C) channels; gated RMSNorm output.

As the reference: softplus is `logaddexp(x, 0)` (torch's `F.softplus` turns
into the identity above 20), the causal conv sums its W shifted products
with Python's `sum` from 0 in the reference's order, and einsums that ask
for fp32 results take upcast operands.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamInit, apply_dense, init_dense, reshape, rms_norm

__all__ = [
    "init_mamba",
    "apply_mamba",
    "apply_mamba_decode",
    "init_mamba_cache",
    "ssd_chunked",
]

F32 = torch.float32


def _dims(cfg):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    H = s.num_heads(cfg.d_model)
    conv_dim = d_in + 2 * s.n_groups * s.state_dim
    return s, d_in, H, conv_dim


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_mamba(init: ParamInit, cfg) -> dict:
    s, d_in, H, conv_dim = _dims(cfg)
    proj_out = 2 * d_in + 2 * s.n_groups * s.state_dim + H  # z, x, B, C, dt
    return {
        "in_proj": init_dense(init, cfg.d_model, proj_out),
        "conv_w": init.normal((s.conv_width, conv_dim), 0.2),
        "conv_b": init.zeros((conv_dim,)),
        "A_log": init.zeros((H,)),  # A = -exp(A_log) = -1
        "D": init.ones((H,)),
        "dt_bias": init.full((H,), -2.0),  # softplus(-2) ~ 0.13
        "norm": init.ones((d_in,)),
        "out_proj": init_dense(init, d_in, cfg.d_model),
    }


def _split_proj(cfg, proj):
    s, d_in, H, _ = _dims(cfg)
    gn = s.n_groups * s.state_dim
    z = proj[..., :d_in]
    xbc = proj[..., d_in : d_in + d_in + 2 * gn]
    dt = proj[..., d_in + d_in + 2 * gn :]
    return z, xbc, dt


def _causal_conv(xbc, w, b):
    """Depthwise causal conv over time. xbc: [B,S,C], w: [W,C].  A DTensor
    xbc runs per batch shard on the local tensors, the weights whole (a
    DTensor pad loses its mesh on some PyTorch versions)."""
    if hasattr(xbc, "placements"):
        from repro_torch.models.layers import batch_shards, on_local_shards, whole_local

        keep = batch_shards(xbc)
        wl, bl = whole_local(w, list(keep)), whole_local(b, list(keep))
        return on_local_shards(lambda t: _causal_conv(t, wl, bl), (xbc,), (keep,), keep)
    W = w.shape[0]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = sum(
        pad[:, i : i + xbc.shape[1], :] * w[i][None, None, :] for i in range(W)
    )
    return F.silu(out + b[None, None, :])


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a: [..., Q] -> L-matrix exponents: out[..., i, j] = sum_{j+1..i} a, i>=j."""
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    Q = a.shape[-1]
    i = torch.arange(Q, device=a.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(
    xdt: torch.Tensor,  # [b,s,h,p]  dt-premultiplied inputs (dt_j B_j x_j form)
    a: torch.Tensor,  # [b,s,h]    log-decay per step (dt * A, negative)
    Bm: torch.Tensor,  # [b,s,g,n]
    Cm: torch.Tensor,  # [b,s,g,n]
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # [b,h,p,n] initial state
):
    """Returns (y [b,s,h,p], h_final [b,h,p,n]).  DTensor inputs run per
    batch shard on the local tensors (`layers.on_local_shards`)."""
    if hasattr(xdt, "placements"):
        from repro_torch.models.layers import batch_shards, on_local_shards

        keep = batch_shards(xdt)
        ins = (xdt, a, Bm, Cm) + ((h0,) if h0 is not None else ())
        return on_local_shards(
            lambda *t: ssd_chunked(t[0], t[1], t[2], t[3], chunk, t[4] if len(t) > 4 else None),
            ins, (keep,) * len(ins), (keep, keep))
    b, S, H, Pd = xdt.shape
    g, n = Bm.shape[2], Bm.shape[3]
    hg = H // g
    Q = min(chunk, S)
    assert S % Q == 0
    nc = S // Q

    xc = xdt.reshape(b, nc, Q, H, Pd)
    ac = a.reshape(b, nc, Q, H)
    Bc = Bm.reshape(b, nc, Q, g, n)
    Cc = Cm.reshape(b, nc, Q, g, n)

    h = h0 if h0 is not None else torch.zeros((b, H, Pd, n), dtype=F32, device=xdt.device)
    ys = []
    for c in range(nc):
        x_, a_, B_, C_ = xc[:, c], ac[:, c], Bc[:, c], Cc[:, c]
        cum = torch.cumsum(a_, dim=1)  # [b,Q,H]
        L = torch.exp(segsum(a_.movedim(-1, 1)))  # [b,H,Q,Q]
        cb = torch.einsum("bigm,bjgm->bgij", C_, B_)  # [b,g,Q,Q]
        cb_h = torch.repeat_interleave(cb, hg, dim=1)  # [b,H,Q,Q]
        y_diag = torch.einsum("bhij,bjhp->bihp", (cb_h * L).to(F32), x_.to(F32))
        # carried-state contribution: C_i exp(cum_i) h0
        c_h = torch.repeat_interleave(C_, hg, dim=2)  # [b,Q,H,n]
        y_off = torch.einsum("bihn,bhpn,bih->bihp", c_h.to(F32), h.to(F32),
                             torch.exp(cum).to(F32))
        # state update
        total = cum[:, -1, :]  # [b,H]
        decay_out = torch.exp(total[:, None, :] - cum)  # [b,Q,H]
        b_h = torch.repeat_interleave(B_, hg, dim=2)  # [b,Q,H,n]
        h = (
            torch.exp(total)[:, :, None, None] * h
            + torch.einsum("bjhn,bjhp,bjh->bhpn", b_h.to(F32), x_.to(F32),
                           decay_out.to(F32))
        )
        ys.append((y_diag + y_off).to(xdt.dtype))
    y = torch.stack(ys, dim=1).reshape(b, S, H, Pd)
    return y, h


def apply_mamba(p, cfg, x, h0=None):
    """Full-sequence Mamba2 block. x: [B,S,d_model] -> ([B,S,d_model], state).

    state = (h_final, conv_tail): h feeds decode continuation; conv_tail is
    the last W-1 raw (pre-conv) xbc rows, i.e. the decode conv cache.
    """
    s, d_in, H, conv_dim = _dims(cfg)
    B_, S, _ = x.shape
    proj = apply_dense(p["in_proj"], x)
    z, xbc, dt = _split_proj(cfg, proj)
    conv_tail = xbc[:, -(s.conv_width - 1):, :]
    xbc = _causal_conv(xbc, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    gn = s.n_groups * s.state_dim
    xin = reshape(xbc[..., :d_in], B_, S, H, s.head_dim)
    Bm = reshape(xbc[..., d_in : d_in + gn], B_, S, s.n_groups, s.state_dim)
    Cm = reshape(xbc[..., d_in + gn :], B_, S, s.n_groups, s.state_dim)
    dt = _softplus(dt.to(F32) + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])  # [H]
    a = dt * A[None, None, :]  # [B,S,H]
    xdt = xin * dt[..., None].to(xin.dtype)
    y, h_fin = ssd_chunked(xdt, a, Bm, Cm, cfg.ssm.chunk, h0=h0)
    y = y + xin * p["D"].to(xin.dtype)[None, None, :, None]
    y = reshape(y, B_, S, d_in)
    y = rms_norm(y, p["norm"], cfg.rmsnorm_eps) * F.silu(z)
    out = apply_dense(p["out_proj"], y)
    return out, (h_fin, conv_tail)


def init_mamba_cache(cfg, batch: int, dtype=F32, device="cpu") -> dict:
    s, d_in, H, conv_dim = _dims(cfg)
    return {
        "h": torch.zeros((batch, H, s.head_dim, s.state_dim), dtype=F32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype, device=device),
    }


def apply_mamba_decode(p, cfg, x, cache):
    """One-token recurrent step. x: [B,1,d_model] -> ([B,1,d_model], cache).
    The returned cache holds new tensors; the one given is not changed.
    Over a mesh (x a DTensor) the conv and state update run per batch shard
    on the local tensors (`layers.on_local_shards`): their einsums fold the
    sharded batch and head dims together, which DTensor's view rule does
    not carry on every PyTorch version."""
    s, d_in, H, conv_dim = _dims(cfg)
    B_ = x.shape[0]
    proj = apply_dense(p["in_proj"], x)  # [B,1,*]
    z, xbc, dt = _split_proj(cfg, proj)
    args = (xbc, dt, cache["conv"], cache["h"], p["conv_w"].to(x.dtype),
            p["conv_b"].to(x.dtype), p["dt_bias"], p["A_log"], p["D"])
    if hasattr(x, "placements"):
        from repro_torch.models.layers import batch_shards, on_local_shards, whole_local

        keep = batch_shards(xbc)
        weights = tuple(whole_local(w, list(keep)) for w in args[4:])
        y, h_new, conv_new = on_local_shards(
            lambda *t: _decode_core(cfg, *t, *weights), args[:4], (keep,) * 4, (keep,) * 3)
    else:
        y, h_new, conv_new = _decode_core(cfg, *args)
    y = reshape(y, B_, 1, d_in)
    y = rms_norm(y, p["norm"], cfg.rmsnorm_eps) * F.silu(z)
    out = apply_dense(p["out_proj"], y)
    return out, {"h": h_new, "conv": conv_new}


def _decode_core(cfg, xbc, dt, conv, h, w, b, dt_bias, A_log, D):
    """The conv over (cached W-1 inputs | new input) and the state update:
    (y [B,H,P] with its D term, the new state, the new conv cache)."""
    s, d_in, H, conv_dim = _dims(cfg)
    B_ = xbc.shape[0]
    win = torch.cat([conv.to(xbc.dtype), xbc], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", win, w) + b
    xbc1 = F.silu(conv_out)[:, None, :]  # [B,1,C]
    gn = s.n_groups * s.state_dim
    xin = xbc1[..., :d_in].reshape(B_, H, s.head_dim)
    Bm = xbc1[..., d_in : d_in + gn].reshape(B_, s.n_groups, s.state_dim)
    Cm = xbc1[..., d_in + gn :].reshape(B_, s.n_groups, s.state_dim)
    dt1 = _softplus(dt[:, 0].to(F32) + dt_bias[None, :])  # [B,H]
    A = -torch.exp(A_log)
    decay = torch.exp(dt1 * A[None, :])  # [B,H]
    hg = H // s.n_groups
    b_h = torch.repeat_interleave(Bm, hg, dim=1)  # [B,H,n]
    c_h = torch.repeat_interleave(Cm, hg, dim=1)
    u = torch.einsum("bhp,bhn,bh->bhpn", xin.to(F32), b_h.to(F32), dt1)
    h_new = h * decay[:, :, None, None] + u
    y = torch.einsum("bhpn,bhn->bhp", h_new, c_h.to(F32)).to(xbc.dtype)
    y = y + xin * D.to(xbc.dtype)[None, :, None]
    return y, h_new, win[:, 1:, :].to(conv.dtype)
