"""Analytic FLOP/byte accounting for every (arch x shape) cell (port of
`repro.analysis.flops_model`, formula for formula and in the reference's order
of operations, so the floats are equal).

Why analytic: XLA:CPU's `cost_analysis()` counts each while-loop *body* once,
not trip_count times, so for scan-over-layers programs the reported HLO_FLOPs
is a per-body figure.  Since we control the exact lowering (which ops run,
how many times), we derive the true totals analytically.  The port's eager
step visits every layer, so `torch.utils.flop_counter.FlopCounterMode`'s
count of one step is held against the whole total (tests/test_torch_analysis.py).

Conventions: FLOPs are global (whole step, all chips); matmul = 2mnk; backward
= 2x forward matmul FLOPs; remat recomputes the block forward once (factor 4
on scanned blocks, factor 3 on non-rematted extras).  Attention in this
codebase computes *all* (q, kv) chunk pairs with masking, so causal attention
costs full S^2 (the 2x over the useful causal half shows up in the
MODEL_FLOPS / HLO_FLOPS ratio, exactly the redundancy the roofline section is
asked to surface).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import ShapeSpec
from repro_torch.models.config import ModelConfig

__all__ = ["CellCost", "cell_cost"]


@dataclasses.dataclass
class CellCost:
    flops: float  # global FLOPs per step (what our lowering executes)
    bytes: float  # global HBM bytes per step (params + activations + cache)
    layer_fwd_flops: float  # one scanned-block forward (for HLO validation)
    extra_flops: float  # non-scanned compute (embed/logits/loss/opt)
    notes: str = ""


def _attn_flops(cfg: ModelConfig, T: int, S_kv: int, full_pairs: bool = True) -> float:
    """Per-step attention FLOPs for T query tokens against S_kv keys."""
    H, Dh, d = cfg.num_heads, cfg.head_dim, cfg.d_model
    if cfg.mla is not None:
        m = cfg.mla
        qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
        proj = (
            2 * d * m.q_lora_rank
            + 2 * m.q_lora_rank * H * qk_dim
            + 2 * d * (m.kv_lora_rank + m.qk_rope_head_dim)
            + 2 * m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
            + 2 * H * m.v_head_dim * d
        )
        mix = 2 * H * S_kv * (qk_dim + m.v_head_dim)
    else:
        K = cfg.num_kv_heads
        proj = 2 * d * H * Dh + 2 * 2 * d * K * Dh + 2 * H * Dh * d
        mix = 2 * H * S_kv * (Dh + Dh)
    return T * (proj + mix)


def _mlp_flops(cfg: ModelConfig, T: int, ff: int) -> float:
    return T * 2 * 3 * cfg.d_model * ff


def _moe_flops(cfg: ModelConfig, T: int) -> float:
    m = cfg.moe
    d = cfg.d_model
    routed = T * 2 * 3 * d * m.expert_ff * m.top_k * m.capacity_factor
    shared = T * 2 * 3 * d * m.expert_ff * m.num_shared
    router = T * 2 * d * m.num_experts
    return routed + shared + router


def _mamba_flops(cfg: ModelConfig, T: int) -> float:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.d_inner(d)
    H, P, N, Q = s.num_heads(d), s.head_dim, s.state_dim, s.chunk
    gn = s.n_groups * N
    proj = 2 * d * (2 * d_in + 2 * gn + H) + 2 * d_in * d
    conv = 2 * s.conv_width * (d_in + 2 * gn)
    # chunked SSD per token: intra-chunk L.x (2*Q*H*P) + CB (2*Q*gn) +
    # state in/out projections (4*H*P*N) + off-diag output (2*H*P*N)
    ssd = 2 * Q * H * P + 2 * Q * gn + 6 * H * P * N
    return T * (proj + conv + ssd)


def _layer_fwd_flops(cfg: ModelConfig, T: int, S_kv: int) -> float:
    """One scanned block, forward, T tokens."""
    if cfg.family in ("ssm", "hybrid"):
        f = _mamba_flops(cfg, T)
        if cfg.family == "hybrid" and cfg.attn_period:
            # shared attention block amortised over the period
            f += (_attn_flops(cfg, T, S_kv) + _mlp_flops(cfg, T, cfg.d_ff)) / cfg.attn_period
        return f
    f = _attn_flops(cfg, T, S_kv)
    if cfg.family == "moe":
        f += _moe_flops(cfg, T)
    else:
        f += _mlp_flops(cfg, T, cfg.d_ff)
    return f


def cell_cost(cfg: ModelConfig, shape: ShapeSpec) -> CellCost:
    B, S = shape.global_batch, shape.seq_len
    V, d = cfg.vocab_size, cfg.d_model
    n_scan = cfg.num_layers - cfg.n_dense_layers

    if shape.kind == "train":
        T = B * S
        lf = _layer_fwd_flops(cfg, T, S)
        prefix = sum(
            _attn_flops(cfg, T, S) + _mlp_flops(cfg, T, cfg.dense_ff or cfg.d_ff)
            for _ in range(cfg.n_dense_layers)
        )
        if cfg.encdec:
            # encoder (bidirectional) + decoder (self + cross) stacks
            enc = cfg.enc_layers * (_attn_flops(cfg, T, S) + _mlp_flops(cfg, T, cfg.d_ff))
            dec = n_scan * (
                2 * _attn_flops(cfg, T, S) + _mlp_flops(cfg, T, cfg.d_ff)
            )
            lf = (enc + dec) / max(cfg.enc_layers + n_scan, 1)
            body_total = enc + dec
        else:
            body_total = n_scan * lf
        logits = T * 2 * d * V
        extras = 3 * (logits + prefix) + T * 5 * V  # fwd+bwd (2x) + softmax
        total = 4 * body_total + extras  # fwd + remat + bwd(2x)
        # bytes: optimizer (7 fp32 accesses) + bf16 param reads x3 passes +
        # activation traffic (~8 B/token/layer/d: fwd write, bwd read, remat)
        from repro_torch.models.model import Model

        N = Model(cfg).param_count()
        p_bytes = N * (7 * 4 + 3 * 2)
        act_bytes = 8.0 * T * d * (cfg.num_layers + (cfg.enc_layers if cfg.encdec else 0))
        logit_bytes = 4.0 * T * V  # fp32 logits r/w (sharded, still HBM traffic)
        return CellCost(total, p_bytes + act_bytes + logit_bytes, lf, extras)

    if shape.kind == "prefill":
        T = B * S
        lf = _layer_fwd_flops(cfg, T, S)
        if cfg.encdec:
            enc = cfg.enc_layers * (_attn_flops(cfg, T, S) + _mlp_flops(cfg, T, cfg.d_ff))
            dec1 = cfg.num_layers * (
                _attn_flops(cfg, B, 1) + _attn_flops(cfg, B, S) + _mlp_flops(cfg, B, cfg.d_ff)
            )
            body_total = enc + dec1
            lf = enc / max(cfg.enc_layers, 1)
        else:
            body_total = n_scan * lf + sum(
                _attn_flops(cfg, T, S) + _mlp_flops(cfg, T, cfg.dense_ff or cfg.d_ff)
                for _ in range(cfg.n_dense_layers)
            )
        logits = B * 2 * d * V  # last position only
        from repro_torch.models.model import Model

        N = Model(cfg).param_count()
        cache_bytes = _cache_bytes(cfg, B, S)
        byts = N * 2 + 6.0 * T * d * cfg.num_layers + cache_bytes
        return CellCost(body_total + logits, byts, lf, logits)

    # decode: one token per sequence against an S-deep cache
    T = B
    lf = _layer_fwd_flops(cfg, T, S)
    body_total = n_scan * lf + sum(
        _attn_flops(cfg, T, S) + _mlp_flops(cfg, T, cfg.dense_ff or cfg.d_ff)
        for _ in range(cfg.n_dense_layers)
    )
    if cfg.encdec:
        body_total = cfg.num_layers * (
            2 * _attn_flops(cfg, T, S) + _mlp_flops(cfg, T, cfg.d_ff)
        )
        lf = body_total / cfg.num_layers
    logits = B * 2 * d * V
    from repro_torch.models.model import Model

    N_active = Model(cfg).param_count(active_only=True)
    cache_bytes = _cache_bytes(cfg, B, S)
    byts = N_active * 2 + cache_bytes  # read all active params + full cache
    return CellCost(body_total + logits, byts, lf, logits)


def _cache_bytes(cfg: ModelConfig, B: int, S: int) -> float:
    """Bytes of the KV/state cache read once per decode step."""
    kvb = 1.125 if cfg.kv_cache_dtype == "int8" else 2.0  # int8 + bf16 scales/Dh
    if cfg.family == "ssm":
        s = cfg.ssm
        return 4.0 * cfg.num_layers * B * s.num_heads(cfg.d_model) * s.head_dim * s.state_dim
    if cfg.family == "hybrid":
        s = cfg.ssm
        state = 4.0 * cfg.num_layers * B * s.num_heads(cfg.d_model) * s.head_dim * s.state_dim
        n_attn = cfg.num_layers // max(cfg.attn_period, 1)
        kv = kvb * 2 * n_attn * B * S * cfg.num_kv_heads * cfg.head_dim
        return state + kv
    if cfg.mla is not None:
        r = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        return 2.0 * cfg.num_layers * B * S * r
    mult = 2 if not cfg.encdec else 4  # self + cross
    return kvb * mult * cfg.num_layers * B * S * cfg.num_kv_heads * cfg.head_dim
