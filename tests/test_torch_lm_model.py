"""The port's LM models against the JAX package's, all ten architectures.

Parametrised over `ARCH_IDS` on the REDUCED configs: `init_cache` shapes and
dtypes, `prefill` (with `max_seq`) and `decode_step` logits and caches, the
int8-cache variants of qwen3-8b and zamba2-2.7b, the parameter counts of the
ten full CONFIGs, and every CONFIG / REDUCED field for field.  Params built
by the reference's `Model.init` travel through
`convert.lm_params_from_reference`; inputs come from numpy seeds.

Tolerances: fp32 compute (`dataclasses.replace(cfg, dtype="float32")`) with
fp32 caches holds logits and caches at rtol 1e-4 + atol 1e-5; bf16 compute
at the reference's own atol/rtol 0.05 (tests/test_lm_demo.py).  int8 cache
codes are equal except at rounding ties: |diff| <= 1 in at most 0.1% of the
entries.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models.model import Model as RModel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_cache_from_reference, lm_params_from_reference  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402

ARCHS = rconfigs.ARCH_IDS
FP32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=0.05, atol=0.05)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def ref_np(a) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def models(arch, dtype=None, **kw):
    rc, tc = rconfigs.get_reduced_config(arch), tconfigs.get_reduced_config(arch)
    if dtype is not None:
        kw["dtype"] = dtype
    rc, tc = dataclasses.replace(rc, **kw), dataclasses.replace(tc, **kw)
    rm, tm = RModel(rc), TModel(tc)
    params = rm.init(jax.random.key(0))
    return rc, rm, tm, params, lm_params_from_reference(np_tree(params), "cpu")


def prefill_batch(cfg, B, S, seed):
    """The reference's test inputs (tests/test_models.py `_batch`), numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.encdec:
        return {"embeds": rng.normal(size=(B, S, cfg.d_model)).astype(np.float32),
                "tokens": toks[:, :1]}
    if cfg.frontend == "patch":
        P = cfg.frontend_len
        return {"embeds": rng.normal(size=(B, P, cfg.d_model)).astype(np.float32),
                "tokens": toks[:, : S - P]}
    return {"tokens": toks}


def assert_cache_close(rcache, tcache, tol):
    assert sorted(rcache) == sorted(tcache)
    for k in rcache:
        r = np.asarray(rcache[k])
        assert tuple(tcache[k].shape) == r.shape, k
        np.testing.assert_allclose(to_np(tcache[k]), ref_np(r), err_msg=k, **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_shapes_and_dtypes(arch):
    for kv in ("bfloat16", "int8"):
        rc = dataclasses.replace(rconfigs.get_reduced_config(arch), kv_cache_dtype=kv)
        tc = dataclasses.replace(tconfigs.get_reduced_config(arch), kv_cache_dtype=kv)
        for dtypes in ((None, None), (jnp.float32, torch.float32)):
            ref = jax.eval_shape(lambda: RModel(rc).init_cache(3, 24, dtypes[0]))
            got = TModel(tc).init_cache(3, 24, dtypes[1], device="cpu")
            assert sorted(ref) == sorted(got)
            for k, r in ref.items():
                assert tuple(got[k].shape) == r.shape, (kv, k)
                assert str(got[k].dtype).removeprefix("torch.") == str(r.dtype), (kv, k)
                assert not got[k].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_fp32(arch):
    """prefill (max_seq headroom) then two decode steps from its cache; and
    teacher-forced decode from an empty fp32 cache: logits and caches."""
    rc, rm, tm, params, tp = models(arch, "float32")
    B, S = 2, 16
    batch = prefill_batch(rc, B, S, seed=1)
    lr, cr = jax.jit(lambda p, b: rm.prefill(p, b, max_seq=S + 4))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        lt, ct = tm.prefill(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                            max_seq=S + 4)
    np.testing.assert_allclose(to_np(lt), np.asarray(lr), **FP32)
    assert_cache_close(cr, ct, FP32)

    dec = jax.jit(rm.decode_step)
    pos = 1 if rc.encdec else S
    for step in range(2):
        tok = np.argmax(np.asarray(lr)[:, -1], -1).astype(np.int32)[:, None]
        lr, cr = dec(params, jnp.asarray(tok), jnp.asarray(pos + step, jnp.int32), cr)
        with torch.no_grad():
            lt, ct = tm.decode_step(tp, torch.from_numpy(tok), pos + step, ct)
        np.testing.assert_allclose(to_np(lt), np.asarray(lr), **FP32)
        assert_cache_close(cr, ct, FP32)

    # teacher-forced decode from an empty cache (encdec: its self cache)
    toks = np.random.default_rng(2).integers(0, rc.vocab_size, (B, 6)).astype(np.int32)
    cr = rm.init_cache(B, 8, jnp.float32)
    ct = tm.init_cache(B, 8, torch.float32, device="cpu")
    for t in range(toks.shape[1]):
        lr, cr = dec(params, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t, jnp.int32), cr)
        with torch.no_grad():
            lt, ct = tm.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]), t, ct)
    np.testing.assert_allclose(to_np(lt), np.asarray(lr), **FP32)
    assert_cache_close(cr, ct, FP32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_bf16(arch):
    """The configs' own bf16 compute and bf16 caches, at the reference's
    tolerances."""
    rc, rm, tm, params, tp = models(arch)
    B, S = 2, 16
    batch = prefill_batch(rc, B, S, seed=3)
    lr, cr = jax.jit(lambda p, b: rm.prefill(p, b, max_seq=S + 4))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        lt, ct = tm.prefill(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                            max_seq=S + 4)
    np.testing.assert_allclose(to_np(lt), ref_np(lr), **BF16)
    assert_cache_close(cr, ct, BF16)
    tok = np.argmax(ref_np(lr)[:, -1], -1).astype(np.int32)[:, None]
    pos = 1 if rc.encdec else S
    lr, cr = jax.jit(rm.decode_step)(params, jnp.asarray(tok), jnp.asarray(pos, jnp.int32), cr)
    with torch.no_grad():
        lt, ct = tm.decode_step(tp, torch.from_numpy(tok), pos, ct)
    np.testing.assert_allclose(to_np(lt), ref_np(lr), **BF16)
    assert_cache_close(cr, ct, BF16)


def exact_bf16_decode(rm, params, tok, cache):
    """The reference's jitted decode_step, compiled so that XLA rounds every
    bf16 intermediate as written: by default (`xla_allow_excess_precision`)
    XLA:CPU keeps the int8 path's bf16 dequantization and softmax weights in
    fp32 inside a fusion, which the port, like the reference's own op-by-op
    arithmetic, does not."""
    return jax.jit(rm.decode_step).lower(
        params, jnp.asarray(tok), jnp.asarray(0, jnp.int32), cache
    ).compile(compiler_options={"xla_allow_excess_precision": False})


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "zamba2-2.7b"])
def test_int8_cache_matches_reference(arch, compute):
    """Teacher-forced decode against an int8 KV cache (the reference's
    tests/test_lm_demo.py::test_int8_cache_parity inputs), 16 steps in each
    package.  With fp32 compute the int8 codes are equal but at rounding
    ties; with bf16 compute the bf16 products already differ in the last
    place, so the codes are held dequantized.  Logits and scales at the
    bf16 tolerance: whatever the compute dtype, the int8 path dequantizes to
    bf16 and rounds the softmax weights to bf16 (`p.astype(v_cache.dtype)`),
    and a code one step off at a tie moves the logits by a code step."""
    rc, rm, tm, params, tp = models(arch, compute, kv_cache_dtype="int8")
    B, S = 2, 16
    toks = np.random.default_rng(2).integers(0, rc.vocab_size, (B, S)).astype(np.int32)
    cr = rm.init_cache(B, S)
    ct = tm.init_cache(B, S, device="cpu")
    dec = exact_bf16_decode(rm, params, toks[:, :1], cr)
    for t in range(S):
        lr, cr = dec(params, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t, jnp.int32), cr)
        with torch.no_grad():
            lt, ct = tm.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]), t, ct)
        np.testing.assert_allclose(to_np(lt), ref_np(lr), **BF16)
    for k, r in cr.items():
        r, got = np.asarray(r), ct[k]
        assert str(got.dtype).removeprefix("torch.") == str(r.dtype), k
        if r.dtype != np.int8:
            np.testing.assert_allclose(to_np(got), ref_np(r), err_msg=k, **BF16)
        elif compute == "float32":
            diff = np.abs(got.numpy().astype(np.int32) - r.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (k, diff.max(), (diff > 0).mean())
        else:
            scale = np.asarray(cr[k + "_scale"]).astype(np.float32)[..., None]
            deq = lambda c, s: c.astype(np.float32) * s
            np.testing.assert_allclose(
                deq(got.numpy(), to_np(ct[k + "_scale"])[..., None]), deq(r, scale),
                err_msg=k, **BF16)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    r, t = rconfigs.get_config(arch), tconfigs.get_config(arch)
    assert t.param_count() == r.param_count()
    assert t.active_param_count() == r.active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference_field_for_field(arch):
    for which in ("get_config", "get_reduced_config"):
        r = getattr(rconfigs, which)(arch)
        t = getattr(tconfigs, which)(arch)
        assert type(t).__name__ == type(r).__name__
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
        for f in dataclasses.fields(r):  # nested configs are the port's classes
            v = getattr(t, f.name)
            if dataclasses.is_dataclass(v):
                assert type(v).__module__ == "repro_torch.models.config"
                assert type(v).__name__ == type(getattr(r, f.name)).__name__
    assert [dataclasses.astuple(s) for s in tconfigs.applicable_shapes(t)] == \
        [dataclasses.astuple(s) for s in rconfigs.applicable_shapes(r)]


def test_registry_and_input_specs_match_reference():
    assert tconfigs.ARCH_IDS == rconfigs.ARCH_IDS
    assert {k: dataclasses.astuple(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in rconfigs.SHAPES.items()}
    assert tconfigs.LP_INSTANCES == rconfigs.LP_INSTANCES
    for arch in ARCHS:
        r, t = rconfigs.get_reduced_config(arch), tconfigs.get_reduced_config(arch)
        for name, shape in rconfigs.SHAPES.items():
            assert tconfigs.skip_reason(t, tconfigs.SHAPES[name]) == rconfigs.skip_reason(r, shape)
            small = dataclasses.replace(shape, seq_len=64, global_batch=2)
            want = jax.tree.map(lambda s: (s.shape, str(s.dtype)),
                                rconfigs.input_specs(r, small))
            got = tconfigs.input_specs(t, tconfigs.ShapeSpec(*dataclasses.astuple(small)))
            got = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype).removeprefix("torch.")),
                               got)
            assert got == want, (arch, name)
            assert all(x.device.type == "meta" for x in jax.tree.leaves(
                tconfigs.input_specs(t, tconfigs.ShapeSpec(*dataclasses.astuple(small)))))
