"""Core transformer layers: norms, RoPE, GQA/MLA attention, MLPs (port of
`repro.models.layers`).

Pure functional style: `init_*` builds param dicts (fp32 masters) from a
`ParamInit` (a torch.Generator, its device, and the leading dims of stacked
layers), `apply_*` consumes them, casting to the compute dtype at use.  All
sequence mixing is KV-chunked (flash-style online softmax over static chunk
pairs), as the reference's.

Numerics follow the reference op for op.  Where it asks an einsum for fp32
results from bf16 operands (`preferred_element_type=jnp.float32`), the
operands are upcast first (exact), since a bf16 torch.einsum would round its
result to bf16; the bf16 casts the reference does make (`p.astype(vblk.dtype)`
before the PV product, `pw.astype(x.dtype)` in absorbed MLA) stay.  A cache
write clamps its position into the cache as `jax.lax.dynamic_update_slice`
does, and writes in place: the decode entry points update the cache they are
given and return it (the reference's engine donates its cache buffers).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = [
    "ParamInit",
    "rms_norm",
    "rope",
    "init_dense",
    "init_attention",
    "apply_attention",
    "apply_attention_decode",
    "init_mlp",
    "apply_mlp",
    "init_mla",
    "apply_mla",
    "apply_mla_decode",
    "chunked_attention",
    "reshape",
]

_NEG = -1.0e30
F32 = torch.float32


class ParamInit:
    """Where the init functions draw parameters: normals from `gen` on its
    device (no storage on the meta device, where `gen` may be None), with
    `lead` prepended to every shape (the layer axis of stacked blocks)."""

    def __init__(self, gen: Optional[torch.Generator], device=None, lead: tuple = ()):
        self.gen = gen
        self.device = torch.device(device) if device is not None else gen.device
        self.lead = tuple(lead)

    def stacked(self, n: int) -> "ParamInit":
        return ParamInit(self.gen, self.device, self.lead + (n,))

    def normal(self, shape, std: float) -> torch.Tensor:
        shape = self.lead + tuple(shape)
        if self.device.type == "meta":
            return torch.empty(shape, dtype=F32, device=self.device)
        return torch.randn(shape, generator=self.gen, dtype=F32, device=self.device).mul_(std)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(self.lead + tuple(shape), value, dtype=F32, device=self.device)

    def ones(self, shape) -> torch.Tensor:
        return self.full(shape, 1.0)

    def zeros(self, shape) -> torch.Tensor:
        return self.full(shape, 0.0)


def _cast(x, dtype):
    return x.to(dtype)


def _f32(*xs):
    return [x.to(F32) for x in xs]


def reshape(x: torch.Tensor, *shape) -> torch.Tensor:
    """`x.reshape(*shape)`.  On a DTensor, a mesh dim whose shard cannot
    follow the reshape is made whole first: DTensor keeps a shard through a
    reshape only on a dim that is kept, on the first factor of a split when
    that factor divides the shard count, or on the first dim of a flatten
    (GSPMD reshards the other cases itself).  This is where the head splits
    of q/k/v (kv-head counts that do not divide the tp axis) and the
    (chunk, position) split of a sequence-sharded attention input leave
    their shards."""
    if hasattr(x, "placements"):
        dst = _resolve_shape(shape, x.numel())
        x = _reshardable(x, dst)
        if torch.is_grad_enabled() and x.requires_grad:
            return _Reshape.apply(x, tuple(dst))
    return x.reshape(*shape)


class _Reshape(torch.autograd.Function):
    """A DTensor reshape whose backward reshapes the grad back under the
    same rule (the grad of a flatten may come back sharded where the split
    back cannot carry it)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.src = tuple(x.shape)
        return x.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return _reshardable(g, list(ctx.src)).reshape(ctx.src), None


def _resolve_shape(shape, numel: int) -> list:
    shape = list(shape[0]) if len(shape) == 1 and isinstance(shape[0], (tuple, list)) \
        else list(shape)
    if -1 in shape:
        known = 1
        for n in shape:
            known *= n if n != -1 else 1
        shape[shape.index(-1)] = numel // max(known, 1)
    return shape


def _bounds(shape) -> list:
    out = [1]
    for n in shape:
        out.append(out[-1] * n)
    return out


def _reshardable(x, dst: list):
    from torch.distributed.tensor import Replicate, Shard

    mesh, src = x.device_mesh, list(x.shape)
    cin, cout = _bounds(src), _bounds(dst)
    pl = list(x.placements)
    n_of = {}  # shard count per input dim
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            n_of[p.dim] = n_of.get(p.dim, 1) * mesh.size(i)
    for i, p in enumerate(pl):
        if not isinstance(p, Shard):
            continue
        d = p.dim
        lo, hi = cin[d], cin[d + 1]
        starts = [j for j in range(len(dst)) if cout[j] == lo and dst[j] > 1]
        ok = False
        if starts and hi in cout:  # kept, or split: the first factor carries the shard
            ok = dst[starts[0]] % n_of[d] == 0
        elif starts:  # flatten: only its first input dim keeps a shard
            first = min(e for e in range(len(src)) if cin[e] == lo and src[e] > 1)
            ok = first == d and src[d] % n_of[d] == 0
        if not ok:
            pl[i] = Replicate()
    if pl != list(x.placements):
        x = x.redistribute(mesh, pl)
    return x


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.to(F32)).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding on the last dim. x: [..., S, ..., D], positions: [B?, S]."""
    D = x.shape[-1]
    half = D // 2
    freq = 1.0 / (theta ** (torch.arange(0, half, dtype=F32, device=x.device) / half))
    ang = positions[..., None].to(F32) * freq  # [..., S, half]
    # broadcast angles over any head dims between S and D
    while ang.ndim < x.ndim:
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_dense(init: ParamInit, d_in: int, d_out: int, *, std: float = 0.02, bias=False):
    p = {"w": init.normal((d_in, d_out), std)}
    if bias:
        p["b"] = init.zeros((d_out,))
    return p


def dense_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.  A DTensor x of rank > 2 is flattened to [tokens, d] first
    (`reshape`, which keeps the batch shard): DTensor's own flatten inside
    `matmul` gives up a batch sharded over dp together with a sequence
    sharded over tp and replicates both."""
    if hasattr(x, "placements") and x.ndim > 2:
        lead = tuple(x.shape[:-1])
        return reshape(reshape(x, -1, x.shape[-1]) @ w, *lead, w.shape[-1])
    return x @ w


def on_local_shards(fn, xs, keep, out_dims):
    """fn(*local tensors) for DTensors `xs` on one mesh: each x is first
    placed with only the shards its `keep` entry allows (a dict, mesh dim ->
    tensor dim), everything else made whole, and fn's output is wrapped
    back with `out_dims` (such a dict; one per output when fn returns a
    tuple).  The named place for computations
    that are independent across those shards (attention per batch and head
    group, the SSD scan per batch) and whose inner ops DTensor would
    otherwise carry one by one."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = xs[0].device_mesh
    local = []
    for x, kp in zip(xs, keep):
        pl = [Shard(kp[i]) if i in kp else Replicate() for i in range(mesh.ndim)]
        local.append(x.redistribute(mesh, pl).to_local() if tuple(x.placements) != tuple(pl)
                     else x.to_local())
    out = fn(*local)
    wrap = lambda t, dims: DTensor.from_local(
        t, mesh, [Shard(dims[i]) if i in dims else Replicate() for i in range(mesh.ndim)],
        run_check=False)
    if isinstance(out, tuple):
        return tuple(wrap(t, d) for t, d in zip(out, out_dims))
    return wrap(out, out_dims)


def embed_on_shards(table, tokens):
    """`table[tokens]` of DTensors, per batch shard on the local tensors:
    the table made whole on every rank (its grad partial over the batch's
    mesh dims, so the update sums every shard's rows), the lookup local.
    DTensor's own index rule leaves the table's backward (an index_put)
    unpropagated on some PyTorch versions."""
    keep = batch_shards(tokens)
    full = whole_local(table, list(keep))
    return on_local_shards(lambda t: full[t.long()], (tokens,), (keep,), keep)


def whole_local(t, grad_partial: list):
    """The full value of DTensor `t` as this rank's plain tensor, its grad
    partial over the mesh dims in `grad_partial` (those whose shards feed
    it different rows) and replicated over the rest."""
    from torch.distributed.tensor import Partial, Replicate

    mesh = t.device_mesh
    return t.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if i in grad_partial else Replicate()
                         for i in range(mesh.ndim)])


def batch_shards(x) -> dict:
    """{mesh dim: 0} for the mesh dims that shard x's batch (dim 0)."""
    from torch.distributed.tensor import Shard

    return {i: 0 for i, p in enumerate(x.placements) if p == Shard(0)}


def apply_dense(p, x):
    y = dense_mm(x, _cast(p["w"], x.dtype))
    if "b" in p:
        y = y + _cast(p["b"], x.dtype)
    return y


def _clamp_pos(pos: int, size: int) -> int:
    """The start `jax.lax.dynamic_update_slice` uses for a length-1 update."""
    return min(max(int(pos), 0), size - 1)


# ---------------------------------------------------------------------------
# chunked (flash-style) attention
# ---------------------------------------------------------------------------


def chunked_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, K, D]
    v: torch.Tensor,  # [B, Sk, K, Dv]
    *,
    causal: bool,
    chunk: int = 1024,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention over static (q-chunk, kv-chunk) pairs.

    Memory is O(Cq * Ck) per head per step instead of O(S^2); each query
    chunk carries (m, l, acc) over the kv chunks.  GQA: H query heads grouped
    over K kv heads.
    """
    if hasattr(q, "placements"):
        return _chunked_attention_on_shards(q, k, v, causal=causal, chunk=chunk,
                                            q_offset=q_offset, scale=scale)
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    cq = min(chunk, Sq)
    ck = min(chunk, Sk)
    assert Sq % cq == 0 and Sk % ck == 0, (Sq, cq, Sk, ck)
    nq, nk = Sq // cq, Sk // ck
    dev = q.device

    qb = q.reshape(B, nq, cq, K, G, D)
    kb = k.reshape(B, nk, ck, K, D)
    vb = v.reshape(B, nk, ck, K, Dv)
    q_pos_base = torch.arange(cq, device=dev)
    k_pos_base = torch.arange(ck, device=dev)

    blocks = []
    for qi in range(nq):
        qblk = qb[:, qi].to(F32)  # [B, cq, K, G, D]
        q_pos = q_offset + qi * cq + q_pos_base  # [cq]
        m = torch.full((B, cq, K, G), _NEG, dtype=F32, device=dev)
        l = torch.zeros((B, cq, K, G), dtype=F32, device=dev)
        acc = torch.zeros((B, cq, K, G, Dv), dtype=F32, device=dev)
        for kj in range(nk):
            kblk, vblk = kb[:, kj], vb[:, kj]
            s = torch.einsum("bqkgd,bckd->bqkgc", qblk, kblk.to(F32)) * scale
            if causal:
                k_pos = kj * ck + k_pos_base
                mask = q_pos[:, None] >= k_pos[None, :]  # [cq, ck]
                s = torch.where(mask[None, :, None, None, :], s, _NEG)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgc,bckd->bqkgd", p.to(vblk.dtype).to(F32), vblk.to(F32)
            )
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        blocks.append(out.to(q.dtype))
    # blocks: nq x [B, cq, K, G, Dv] -> [B, Sq, H, Dv]
    return torch.cat(blocks, dim=1).reshape(B, Sq, H, Dv)


def _chunked_attention_on_shards(q, k, v, **kw):
    """`chunked_attention` of DTensors: per batch shard (q's dp shards) and
    per kv-head group (k's head shards, where the kv-head count divides
    them), on the local tensors; the sequence dims are made whole."""
    from torch.distributed.tensor import Shard

    mesh, K = q.device_mesh, k.shape[2]
    keep = batch_shards(q)
    for i, p in enumerate(k.placements):
        if i not in keep and p == Shard(2) and K % mesh.size(i) == 0:
            keep[i] = 2
    return on_local_shards(lambda a, b, c: chunked_attention(a, b, c, **kw),
                           (q, k, v), (keep, keep, keep), keep)


def decode_attention(
    q: torch.Tensor,  # [B, 1, H, D]
    k_cache: torch.Tensor,  # [B, S, K, D]
    v_cache: torch.Tensor,  # [B, S, K, Dv]
    pos: int,  # current position (number of valid cache entries - 1)
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token attention against a KV cache: plain einsum + masked
    softmax over the cache's valid entries (0..pos)."""
    if hasattr(q, "placements"):
        return _decode_attention_on_shards(q, k_cache, v_cache, pos, scale)
    B, _, H, D = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, K, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", *_f32(qg, k_cache)) * scale
    valid = torch.arange(S, device=q.device) <= pos
    s = torch.where(valid[None, None, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", *_f32(p.to(v_cache.dtype), v_cache))
    return out.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)


def _decode_attention_on_shards(q, k_cache, v_cache, pos: int, scale):
    """`decode_attention` of DTensors, on the local tensors of each batch
    shard and each sequence shard of the cache.  Over a sequence-sharded
    cache the softmax is a distributed one: the max and the sum of the
    exponentials are all-reduced over the sequence's mesh dims, then each
    rank weighs its own values and the products are summed.  With the
    sequence whole it is the single-device function on the local batch."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = k_cache.device_mesh
    batch = [i for i, p in enumerate(k_cache.placements) if p == Shard(0)]
    seq = [i for i, p in enumerate(k_cache.placements) if p == Shard(1)]
    cache_pl = [Shard(0) if i in batch else Shard(1) if i in seq else Replicate()
                for i in range(mesh.ndim)]
    row_pl = [Shard(0) if i in batch else Replicate() for i in range(mesh.ndim)]
    kl = k_cache.redistribute(mesh, cache_pl).to_local()
    vl = v_cache.redistribute(mesh, cache_pl).to_local()
    ql = q.redistribute(mesh, row_pl).to_local()
    wrap = lambda out: DTensor.from_local(out, mesh, row_pl, run_check=False)
    if not seq:
        return wrap(decode_attention(ql, kl, vl, pos, scale=scale))
    _, offset = compute_local_shape_and_global_offset(k_cache.shape, mesh, cache_pl)
    B, _, H, D = ql.shape
    S, K = kl.shape[1], kl.shape[2]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    qg = ql.reshape(B, K, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", *_f32(qg, kl)) * scale
    valid = offset[1] + torch.arange(S, device=ql.device) <= pos
    s = torch.where(valid[None, None, None, :], s, _NEG)
    m = torch.amax(s, dim=-1, keepdim=True)
    for i in seq:
        m = funcol.all_reduce(m, "max", (mesh, i))
    e = torch.exp(s - m)
    den = torch.sum(e, dim=-1, keepdim=True)
    for i in seq:
        den = funcol.all_reduce(den, "sum", (mesh, i))
    p = e / den
    out = torch.einsum("bkgs,bskd->bkgd", *_f32(p.to(vl.dtype), vl))
    for i in seq:
        out = funcol.all_reduce(out, "sum", (mesh, i))
    return wrap(out.reshape(B, 1, H, vl.shape[-1]).to(ql.dtype))


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------


def init_attention(init: ParamInit, cfg) -> dict:
    d, H, K, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": init_dense(init, d, H * Dh, bias=cfg.qkv_bias),
        "wk": init_dense(init, d, K * Dh, bias=cfg.qkv_bias),
        "wv": init_dense(init, d, K * Dh, bias=cfg.qkv_bias),
        "wo": init_dense(init, H * Dh, d),
    }
    if cfg.qk_norm:
        p["q_norm"] = init.ones((Dh,))
        p["k_norm"] = init.ones((Dh,))
    return p


def _qkv(p, cfg, x, positions, use_rope: bool = True):
    B, S, _ = x.shape
    H, K, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = reshape(apply_dense(p["wq"], x), B, S, H, Dh)
    k = reshape(apply_dense(p["wk"], x), B, S, K, Dh)
    v = reshape(apply_dense(p["wv"], x), B, S, K, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rmsnorm_eps)
        k = rms_norm(k, p["k_norm"], cfg.rmsnorm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def apply_attention(
    p, cfg, x, positions, *, causal=True, q_offset=0,
    kv: Optional[tuple] = None, use_rope: bool = True,
):
    """Full-sequence attention (train / prefill).  Returns (out, (k, v)).

    kv=(k, v) switches to cross-attention against an encoder memory (no rope,
    no causal mask).
    """
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions, use_rope=use_rope and kv is None)
    if kv is not None:  # cross-attention: keys/values from encoder memory
        k, v = kv
        causal = False
    out = chunked_attention(
        q, k, v, causal=causal, chunk=cfg.attn_chunk, q_offset=q_offset
    )
    return apply_dense(p["wo"], reshape(out, B, S, -1)), (k, v)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token-per-head absmax int8 quantization. x: [B, 1, K, D]."""
    x32 = x.to(F32)
    scale = torch.amax(torch.abs(x32), dim=-1) / 127.0  # [B,1,K]
    q = torch.round(x32 / torch.clamp_min(scale, 1e-8)[..., None]).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _write(cache: torch.Tensor, new: torch.Tensor, pos: int) -> torch.Tensor:
    """Write `new` (one position, axis 1) into `cache` at `pos`, in place."""
    p = _clamp_pos(pos, cache.shape[1])
    if hasattr(cache, "placements"):
        return _write_sharded(cache, new, p)
    cache[:, p : p + 1] = new.to(cache.dtype)
    return cache


def _write_sharded(cache, new, p: int):
    """`_write` into a DTensor cache whose sequence axis may be sharded: a
    slice assignment on a sharded dim has no DTensor rule (it would write
    into a gathered copy), so the rank whose shard holds position p writes
    its local rows in place."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = cache.device_mesh
    row = [Replicate() if pl == Shard(1) else pl for pl in cache.placements]
    new = new.to(cache.dtype).redistribute(mesh, row).to_local()
    shape, offset = compute_local_shape_and_global_offset(cache.shape, mesh, cache.placements)
    if offset[1] <= p < offset[1] + shape[1]:
        cache.to_local()[:, p - offset[1] : p - offset[1] + 1] = new
    return cache


def apply_attention_decode(p, cfg, x, pos, cache):
    """One-token step against a bf16 or int8 (quantized) KV cache.

    bf16 cache:  {"k", "v"} [B,S,K,D]
    int8 cache:  + {"k_scale", "v_scale"} [B,S,K] — per-token-per-head absmax
                 scales.
    The cache's tensors are updated in place and returned.
    """
    B = x.shape[0]
    positions = torch.full((B, 1), int(pos), dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(p, cfg, x, positions)
    quant = cache["k"].dtype == torch.int8
    if quant:
        k_q, k_s = quantize_kv(k_new)
        v_q, v_s = quantize_kv(v_new)
        k_cache = _write(cache["k"], k_q, pos)
        v_cache = _write(cache["v"], v_q, pos)
        ks = _write(cache["k_scale"], k_s, pos)
        vs = _write(cache["v_scale"], v_s, pos)
        new_cache = {"k": k_cache, "v": v_cache, "k_scale": ks, "v_scale": vs}
        bf = torch.bfloat16
        k_deq = k_cache.to(bf) * ks[..., None].to(bf)
        v_deq = v_cache.to(bf) * vs[..., None].to(bf)
        out = decode_attention(q, k_deq, v_deq, pos)
    else:
        k_cache = _write(cache["k"], k_new, pos)
        v_cache = _write(cache["v"], v_new, pos)
        new_cache = {"k": k_cache, "v": v_cache}
        out = decode_attention(q, k_cache, v_cache, pos)
    return apply_dense(p["wo"], reshape(out, B, 1, -1)), new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(init: ParamInit, d: int, ff: int) -> dict:
    return {
        "w_gate": init_dense(init, d, ff),
        "w_up": init_dense(init, d, ff),
        "w_down": init_dense(init, ff, d),
    }


def apply_mlp(p, x, mlp_type: str = "swiglu"):
    g = apply_dense(p["w_gate"], x)
    u = apply_dense(p["w_up"], x)
    # jax.nn.gelu's default is the tanh approximation
    act = F.gelu(g, approximate="tanh") if mlp_type == "geglu" else F.silu(g)
    return apply_dense(p["w_down"], act * u)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def init_mla(init: ParamInit, cfg) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    return {
        "wq_a": init_dense(init, d, m.q_lora_rank),
        "q_norm": init.ones((m.q_lora_rank,)),
        "wq_b": init_dense(init, m.q_lora_rank, H * (dn + dr)),
        "wkv_a": init_dense(init, d, m.kv_lora_rank + dr),
        "kv_norm": init.ones((m.kv_lora_rank,)),
        "wkv_b": init_dense(init, m.kv_lora_rank, H * (dn + dv)),
        "wo": init_dense(init, H * dv, d),
    }


def _mla_qkv(p, cfg, x, positions):
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    ql = rms_norm(apply_dense(p["wq_a"], x), p["q_norm"], cfg.rmsnorm_eps)
    q = reshape(apply_dense(p["wq_b"], ql), B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], rope(q[..., dn:], positions, cfg.rope_theta)
    kv_a = apply_dense(p["wkv_a"], x)
    latent = rms_norm(kv_a[..., : m.kv_lora_rank], p["kv_norm"], cfg.rmsnorm_eps)
    k_rope = rope(
        kv_a[..., m.kv_lora_rank:][:, :, None, :], positions, cfg.rope_theta
    )  # [B,S,1,dr] shared across heads
    return q_nope, q_rope, latent, k_rope


def apply_mla(p, cfg, x, positions, *, q_offset=0):
    """MLA for train/prefill: materialise per-head K/V from the latent."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    q_nope, q_rope, latent, k_rope = _mla_qkv(p, cfg, x, positions)
    kv = reshape(apply_dense(p["wkv_b"], latent), B, S, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
    out = chunked_attention(
        q, k, v, causal=True, chunk=cfg.attn_chunk, q_offset=q_offset,
        scale=(dn + dr) ** -0.5,
    )
    return apply_dense(p["wo"], reshape(out, B, S, -1)), latent, k_rope


def apply_mla_decode(p, cfg, x, pos, cache):
    """Absorbed MLA decode: the cache stores only the compressed latent
    [B, S, kv_lora + dr], updated in place.

    score_h = q_nope_h' Wkv_b_k_h latent + q_rope_h' k_rope   (weight absorption)
    out_h   = (attn @ latent) Wkv_b_v_h
    """
    m = cfg.mla
    B = x.shape[0]
    H = cfg.num_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    r = m.kv_lora_rank
    positions = torch.full((B, 1), int(pos), dtype=torch.int32, device=x.device)
    q_nope, q_rope, latent_new, k_rope_new = _mla_qkv(p, cfg, x, positions)
    entry = torch.cat([latent_new, k_rope_new[:, :, 0, :]], dim=-1)  # [B,1,r+dr]
    lat_cache = _write(cache["latent"], entry, pos)
    latent, k_rope = lat_cache[..., :r], lat_cache[..., r:]
    wkv_b = reshape(p["wkv_b"]["w"], r, H, dn + dv)
    wk, wv = wkv_b[..., :dn], wkv_b[..., dn:]  # [r,H,dn], [r,H,dv]
    dt = x.dtype
    # absorb: q_abs [B,H,r]
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], wk.to(dt))
    s = (
        torch.einsum("bhr,bsr->bhs", *_f32(q_abs, latent.to(dt)))
        + torch.einsum("bhd,bsd->bhs", *_f32(q_rope[:, 0], k_rope.to(dt)))
    ) * (dn + dr) ** -0.5
    S = latent.shape[1]
    valid = torch.arange(S, device=x.device) <= pos
    s = torch.where(valid[None, None, :], s, _NEG)
    pw = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", pw.to(dt), latent.to(dt))
    out = torch.einsum("bhr,rhv->bhv", ctx, wv.to(dt))
    return apply_dense(p["wo"], reshape(out, B, 1, -1)), {"latent": lat_cache}
