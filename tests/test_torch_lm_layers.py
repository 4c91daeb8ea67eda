"""The port's LM layers, MoE and SSD against the JAX package's functions.

Every function of `models/layers.py`, `models/moe.py` and `models/ssm.py`:
norms, RoPE, dense, chunked attention (GQA, causal and not, several chunks,
`q_offset`), decode attention, attention blocks (qk-norm, qkv bias, cross
attention `kv=`), int8 `quantize_kv`, the decode step against bf16 and int8
caches (the write position clamped as `dynamic_update_slice` clamps it),
MLPs, MLA (prefill and the absorbed decode), `lp_route` (against the
reference and at its properties), MoE dispatch (no drops, capacity drops
with ties in the router, groups) and the Mamba2 pieces.  Params come from the
reference's `init_*` through `convert.lm_params_from_reference`; inputs from
numpy seeds.

Tolerances: fp32 at rtol 1e-4 + atol 1e-5; bf16 at the reference's atol/rtol
0.05; int8 codes equal but at rounding ties (|diff| <= 1 in at most 0.1%).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_reduced_config as ref_config  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

FP32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=0.05, atol=0.05)
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": FP32, "bfloat16": BF16}


def normal(seed, shape, dtype="float32", scale=1.0):
    """The same numbers in both packages: (jax array, torch tensor)."""
    a = (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(a).astype(DT[dtype][0]), torch.from_numpy(a).to(DT[dtype][1])


def params(tree):
    return lm_params_from_reference(jax.tree.map(np.asarray, tree), "cpu")


def close(got, want, tol=FP32, **kw):
    want = np.asarray(want)
    want = want.astype(np.float32) if want.dtype.name == "bfloat16" else want
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy(),
                               want, **tol, **kw)


def cfg32(arch, **kw):
    return (dataclasses.replace(ref_config(arch), **kw),
            dataclasses.replace(get_reduced_config(arch), **kw))


def shapes(tree):
    return jax.tree.map(lambda x: tuple(x.shape), tree)


def test_init_functions_match_reference_shapes():
    """Each init_* builds the reference's tree (paths and shapes), stacked
    under a leading layer dim by `ParamInit.stacked`."""
    gen = torch.Generator().manual_seed(0)
    init = TL.ParamInit(gen)
    key = jax.random.key(0)
    for arch in ("qwen3-8b", "qwen2-72b", "deepseek-v2-236b", "mamba2-1.3b"):
        r, t = ref_config(arch), get_reduced_config(arch)
        pairs = [(RL.init_attention(key, r), TL.init_attention(init, t)),
                 (RL.init_mlp(key, r.d_model, 48), TL.init_mlp(init, t.d_model, 48))]
        if r.mla is not None:
            pairs.append((RL.init_mla(key, r), TL.init_mla(init, t)))
        if r.moe is not None:
            pairs.append((RM.init_moe(key, r), TM.init_moe(init, t)))
        if r.ssm is not None:
            pairs = [(RS.init_mamba(key, r), TS.init_mamba(init, t))]
        for ref, got in pairs:
            assert shapes(got) == shapes(ref), arch
    stacked = TM.init_moe(init.stacked(3), get_reduced_config("kimi-k2-1t-a32b"))
    ref = RM.init_moe(key, ref_config("kimi-k2-1t-a32b"))
    assert shapes(stacked) == jax.tree.map(lambda x: (3,) + x.shape, ref)
    assert TL.init_dense(init.stacked(4), 3, 5, bias=True)["w"].shape == (4, 3, 5)
    assert TL.ParamInit(None, "meta").normal((2, 3), 0.1).device.type == "meta"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_rope_dense(dtype):
    xr, xt = normal(0, (2, 6, 4, 16), dtype)
    sr, st = normal(1, (16,), "float32")
    close(TL.rms_norm(xt, st, 1e-6), RL.rms_norm(xr, sr, 1e-6), TOL[dtype])
    pos = np.random.default_rng(2).integers(0, 500, (2, 6)).astype(np.int32)
    for theta in (1e4, 1e6):
        close(TL.rope(xt, torch.from_numpy(pos), theta), RL.rope(xr, jnp.asarray(pos), theta),
              TOL[dtype])
        close(TL.rope(xt[:, :, :1], torch.from_numpy(pos), theta),
              RL.rope(xr[:, :, :1], jnp.asarray(pos), theta), TOL[dtype])
    pr = RL.init_dense(jax.random.key(3), 16, 24, bias=True)
    pr["b"] = jnp.asarray(np.random.default_rng(4).normal(size=24).astype(np.float32))
    close(TL.apply_dense(params(pr), xt), RL.apply_dense(pr, xr), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,Sq,Sk,chunk,q_offset", [
    (True, 32, 32, 8, 0),     # four query and four kv chunks
    (True, 8, 32, 8, 24),     # the last chunk of a longer sequence
    (False, 16, 24, 8, 0),    # bidirectional / cross shapes
    (True, 12, 12, 1024, 0),  # one chunk
])
def test_chunked_attention(dtype, causal, Sq, Sk, chunk, q_offset):
    B, H, K, D = 2, 4, 2, 16  # GQA: two query heads per kv head
    qr, qt = normal(0, (B, Sq, H, D), dtype)
    kr, kt = normal(1, (B, Sk, K, D), dtype)
    vr, vt = normal(2, (B, Sk, K, 8), dtype)
    for scale in (None, 0.3):
        kw = dict(causal=causal, chunk=chunk, q_offset=q_offset, scale=scale)
        close(TL.chunked_attention(qt, kt, vt, **kw),
              RL.chunked_attention(qr, kr, vr, **kw), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention(dtype):
    qr, qt = normal(0, (3, 1, 4, 16), dtype)
    kr, kt = normal(1, (3, 10, 2, 16), dtype)
    vr, vt = normal(2, (3, 10, 2, 16), dtype)
    for pos in (0, 4, 9):
        close(TL.decode_attention(qt, kt, vt, pos), RL.decode_attention(qr, kr, vr, pos),
              TOL[dtype])


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen2-72b", "gemma-7b"])
def test_attention_block_self_and_cross(arch):
    """qk-norm (qwen3), qkv bias (qwen2), MHA (gemma); causal self attention
    with q_offset, and cross attention against a memory (no rope/mask)."""
    rc, tc = cfg32(arch, dtype="float32", attn_chunk=8)
    pr = RL.init_attention(jax.random.key(0), rc)
    pr = jax.tree.map(lambda x: x + 0.01, pr)  # nonzero biases and norms
    pt = params(pr)
    xr, xt = normal(1, (2, 16, rc.d_model))
    pos = np.broadcast_to(np.arange(16) + 5, (2, 16)).astype(np.int32)
    out_r, (k_r, v_r) = RL.apply_attention(pr, rc, xr, jnp.asarray(pos), q_offset=0)
    out_t, (k_t, v_t) = TL.apply_attention(pt, tc, xt, torch.from_numpy(pos), q_offset=0)
    close(out_t, out_r)
    close(k_t, k_r)
    close(v_t, v_r)
    mr, mt = normal(2, (2, 24, rc.num_kv_heads, rc.head_dim))
    out_r, _ = RL.apply_attention(pr, rc, xr, jnp.asarray(pos), kv=(mr, mr * 0.5))
    out_t, _ = TL.apply_attention(pt, tc, xt, torch.from_numpy(pos), kv=(mt, mt * 0.5))
    close(out_t, out_r)
    out_r, _ = RL.apply_attention(pr, rc, xr[:, 8:], jnp.asarray(pos[:, 8:]), q_offset=8,
                                  causal=True)
    out_t, _ = TL.apply_attention(pt, tc, xt[:, 8:], torch.from_numpy(pos[:, 8:]), q_offset=8,
                                  causal=True)
    close(out_t, out_r)


def test_quantize_kv_codes():
    for seed in range(4):
        xr, xt = normal(seed, (3, 1, 4, 64), scale=3.0)
        qr, sr = RL.quantize_kv(xr)
        qt, st = TL.quantize_kv(xt)
        assert qt.dtype == torch.int8 and st.dtype == torch.bfloat16
        diff = np.abs(qt.numpy().astype(np.int32) - np.asarray(qr).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        close(st, sr, dict(rtol=0, atol=0))
    # an exact tie (x / scale = 0.5) rounds half to even in both
    x = np.zeros((1, 1, 1, 4), np.float32)
    x[..., :] = [127.0, 0.5, 1.5, -2.5]
    close(TL.quantize_kv(torch.from_numpy(x))[0], RL.quantize_kv(jnp.asarray(x))[0],
          dict(rtol=0, atol=0))


@pytest.mark.parametrize("quant", [False, True])
def test_attention_decode_against_cache(quant):
    """bf16 and int8 caches, positions inside the cache and past its end (the
    write clamps to the last slot, as dynamic_update_slice does)."""
    rc, tc = cfg32("qwen3-8b", dtype="float32")
    pr = RL.init_attention(jax.random.key(0), rc)
    pt = params(pr)
    B, S, K, Dh = 2, 8, rc.num_kv_heads, rc.head_dim
    cache_r = {"k": jnp.zeros((B, S, K, Dh), jnp.bfloat16), "v": jnp.zeros((B, S, K, Dh), jnp.bfloat16)}
    if quant:
        cache_r = {"k": jnp.zeros((B, S, K, Dh), jnp.int8), "v": jnp.zeros((B, S, K, Dh), jnp.int8),
                   "k_scale": jnp.zeros((B, S, K), jnp.bfloat16),
                   "v_scale": jnp.zeros((B, S, K), jnp.bfloat16)}
    cache_t = params(cache_r)
    for step, pos in enumerate([0, 1, 2, 5, 7, 9, 12]):
        xr, xt = normal(10 + step, (B, 1, rc.d_model))
        out_r, cache_r = RL.apply_attention_decode(pr, rc, xr, pos, cache_r)
        out_t, cache_t = TL.apply_attention_decode(pt, tc, xt, pos, cache_t)
        close(out_t, out_r, BF16)
        for k, r in cache_r.items():
            if r.dtype == jnp.int8:
                diff = np.abs(cache_t[k].numpy().astype(np.int32) - np.asarray(r).astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, k
            else:
                close(cache_t[k], r, BF16)


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp(mlp_type, dtype):
    pr = RL.init_mlp(jax.random.key(0), 32, 64)
    xr, xt = normal(1, (2, 5, 32), dtype, scale=4.0)  # gelu's tanh form matters here
    close(TL.apply_mlp(params(pr), xt, mlp_type), RL.apply_mlp(pr, xr, mlp_type), TOL[dtype])


@pytest.mark.parametrize("latent_dtype", ["bfloat16", "float32", "int8"])
def test_mla_prefill_and_absorbed_decode(latent_dtype):
    rc, tc = cfg32("deepseek-v2-236b", dtype="float32", attn_chunk=8)
    pr = RL.init_mla(jax.random.key(0), rc)
    pt = params(pr)
    B, S = 2, 16
    xr, xt = normal(1, (B, S, rc.d_model))
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    o_r, lat_r, kr_r = RL.apply_mla(pr, rc, xr, jnp.asarray(pos))
    o_t, lat_t, kr_t = TL.apply_mla(pt, tc, xt, torch.from_numpy(pos))
    close(o_t, o_r)
    close(lat_t, lat_r)
    close(kr_t, kr_r)
    r = rc.mla.kv_lora_rank + rc.mla.qk_rope_head_dim
    jdt = {"bfloat16": jnp.bfloat16, "float32": jnp.float32, "int8": jnp.int8}[latent_dtype]
    cache_r = {"latent": jnp.zeros((B, 6, r), jdt)}
    cache_t = params(cache_r)
    for step, p in enumerate([0, 1, 3, 5, 8]):
        yr, yt = normal(20 + step, (B, 1, rc.d_model))
        out_r, cache_r = RL.apply_mla_decode(pr, rc, yr, p, cache_r)
        out_t, cache_t = TL.apply_mla_decode(pt, tc, yt, p, cache_t)
        tol = FP32 if latent_dtype == "float32" else BF16
        close(out_t, out_r, tol)
        close(cache_t["latent"], cache_r["latent"], tol)


@pytest.mark.parametrize("seed", range(6))
def test_lp_route_matches_reference_and_properties(seed):
    rng = np.random.default_rng(seed)
    T, E, k = [(64, 4), (256, 8), (64, 8)][seed % 3] + (2,)
    logits = rng.normal(size=(T, E)) * 2
    probs_r = jax.nn.softmax(jnp.asarray(logits, jnp.float32), -1)
    probs_t = torch.from_numpy(np.array(probs_r))
    cap = T * k / E * 1.1
    xr = RM.lp_route(probs_r, k, capacity=cap, iters=64, gamma=0.05)
    xt = TM.lp_route(probs_t, k, capacity=cap, iters=64, gamma=0.05)
    close(xt, xr, dict(rtol=1e-4, atol=1e-4))
    x = xt.numpy()  # the reference test's properties (tests/test_moe_router.py)
    assert (x >= -1e-5).all()
    assert (x.sum(1) <= k + 1e-3).all()
    assert x.sum(0).max() <= cap * 1.25


def _moe_case(router, cf, top_k, tie_experts, groups=0, T=48):
    rc, tc = cfg32("deepseek-v2-236b", dtype="float32")
    moe = dataclasses.replace(rc.moe, router=router, capacity_factor=cf, top_k=top_k,
                              groups=groups, lp_iters=8)
    rc, tc = dataclasses.replace(rc, moe=moe), dataclasses.replace(tc, moe=moe)
    pr = RM.init_moe(jax.random.key(1), rc)
    w = np.asarray(pr["router"]["w"]).copy()
    for a, b in tie_experts:  # identical router columns: exactly tied probs
        w[:, b] = w[:, a]
    pr["router"]["w"] = jnp.asarray(w)
    xr, xt = normal(2, (T, rc.d_model))
    return rc, tc, pr, params(pr), xr, xt


@pytest.mark.parametrize("router,cf,top_k,ties,groups,drops", [
    ("topk", 8.0, 2, [], 0, False),               # no drops
    ("topk", 0.3, 2, [(0, 5), (2, 6)], 0, True),  # drops; exactly tied experts
    ("lp", 0.3, 6, [], 0, True),                  # drops; lp_route's exact zeros tie
    ("lp", 1.0, 2, [(1, 3)], 0, True),
    ("topk", 0.5, 2, [(0, 5)], 4, True),          # group-local dispatch
])
def test_moe_matches_reference(router, cf, top_k, ties, groups, drops):
    rc, tc, pr, pt, xr, xt = _moe_case(router, cf, top_k, ties, groups)
    close(TM.apply_moe(pt, tc, xt), RM.apply_moe(pr, rc, xr))
    # the case exercises what it names: ties at the top-k cut, drops past C
    m = rc.moe
    T = xr.shape[0] // max(groups, 1)
    C = int(max(1, round(T * m.top_k / m.num_experts * m.capacity_factor)))
    probs = jax.nn.softmax((xr @ pr["router"]["w"]).astype(jnp.float32), -1)
    if router == "lp":
        probs = RM.lp_route(probs, m.top_k, C, iters=m.lp_iters, gamma=m.lp_gamma)
    top = np.sort(np.asarray(probs), -1)[:, ::-1]
    assert (top[:, m.top_k - 1] == top[:, m.top_k]).any() == bool(ties or router == "lp")
    ids = np.asarray(jax.lax.top_k(probs, m.top_k)[1])
    load = max(np.bincount(ids[g * T:(g + 1) * T].reshape(-1), minlength=m.num_experts).max()
               for g in range(max(groups, 1)))
    assert (load > C) == drops


def test_top_k_tie_order_is_jax_lax_top_k():
    probs = np.array([[0.2, 0.3, 0.3, 0.2, 0.0, 0.0],
                      [0.0, 0.0, 0.0, 0.5, 0.5, 0.0],
                      [0.25, 0.25, 0.25, 0.25, 0.0, 0.0]], np.float32)
    for k in (1, 2, 3, 4):
        wr, ir = jax.lax.top_k(jnp.asarray(probs), k)
        wt, it = TM.top_k(torch.from_numpy(probs), k)
        assert it.tolist() == np.asarray(ir).tolist()
        assert wt.tolist() == np.asarray(wr).tolist()


def test_mamba_pieces():
    rc, tc = cfg32("mamba2-1.3b", dtype="float32")
    s = rc.ssm
    d_in, H = s.d_inner(rc.d_model), s.num_heads(rc.d_model)
    conv_dim = d_in + 2 * s.n_groups * s.state_dim
    pr, pt = normal(0, (2, 10, 2 * d_in + 2 * s.state_dim + H))
    for a, b in zip(TS._split_proj(tc, pt), RS._split_proj(rc, pr)):
        close(a, b, dict(rtol=0, atol=0))
    xr, xt = normal(1, (2, 10, conv_dim))
    wr, wt = normal(2, (s.conv_width, conv_dim))
    br, bt = normal(3, (conv_dim,))
    close(TS._causal_conv(xt, wt, bt), RS._causal_conv(xr, wr, br))
    ar, at = normal(4, (3, 2, 12), scale=0.3)
    got, want = TS.segsum(at).numpy(), np.asarray(RS.segsum(ar))
    assert (np.isneginf(got) == np.isneginf(want)).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **FP32)
    cache = TS.init_mamba_cache(tc, 3, torch.bfloat16)
    ref = RS.init_mamba_cache(rc, 3, jnp.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in cache.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in ref.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk,with_h0", [(64, 16, False), (64, 16, True), (24, 32, False)])
def test_ssd_chunked(dtype, S, chunk, with_h0):
    b, H, P, g, n = 2, 4, 8, 2, 6
    xr, xt = normal(0, (b, S, H, P), dtype)
    ar, at = normal(1, (b, S, H), scale=0.1)
    ar, at = -jnp.abs(ar), -at.abs()
    Br, Bt = normal(2, (b, S, g, n), dtype)
    Cr, Ct = normal(3, (b, S, g, n), dtype)
    h0r, h0t = normal(4, (b, H, P, n)) if with_h0 else (None, None)
    yr, hr = RS.ssd_chunked(xr, ar, Br, Cr, chunk, h0=h0r)
    yt, ht = TS.ssd_chunked(xt, at, Bt, Ct, chunk, h0=h0t)
    close(yt, yr, TOL[dtype])
    close(ht, hr, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_prefill_then_decode(dtype):
    rc, tc = cfg32("mamba2-1.3b", dtype=dtype)
    pr = RS.init_mamba(jax.random.key(0), rc)
    pr = dict(pr, dt_bias=pr["dt_bias"] + 25.0)  # softplus where F.softplus would switch
    pt = params(pr)
    xr, xt = normal(1, (2, 32, rc.d_model), dtype)
    out_r, (h_r, tail_r) = RS.apply_mamba(pr, rc, xr)
    out_t, (h_t, tail_t) = TS.apply_mamba(pt, tc, xt)
    close(out_t, out_r, TOL[dtype])
    close(h_t, h_r, TOL[dtype])
    close(tail_t, tail_r, TOL[dtype])
    cache_r = {"h": h_r, "conv": tail_r}
    cache_t = {"h": h_t, "conv": tail_t}
    for step in range(3):
        yr, yt = normal(5 + step, (2, 1, rc.d_model), dtype)
        o_r, cache_r = RS.apply_mamba_decode(pr, rc, yr, cache_r)
        o_t, cache_t = TS.apply_mamba_decode(pt, tc, yt, cache_t)
        close(o_t, o_r, TOL[dtype])
        close(cache_t["h"], cache_r["h"], TOL[dtype])
        close(cache_t["conv"], cache_r["conv"], TOL[dtype])
