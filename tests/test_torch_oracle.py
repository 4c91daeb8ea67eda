"""Port parity: the one-pass dual oracle and MatchingObjective, against the JAX package.

The port's plain oracle (`repro_torch.kernels.ref.dual_oracle_ref`, what CPU
tensors take and what the CUDA kernel is held against on the card) must
match the reference's Pallas kernel body run in interpret mode and the
reference's plain oracle at `_assert_oracle_close`'s tolerances
(tests/test_dual_oracle.py: atol 3e-5, rtol 1e-5), with exact zeros on
padded rows.  `calculate`, fused and unfused, matches the reference within
1e-6 rel-L2 on g and grad and atol 3e-5 on x.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.core.objective import MatchingObjective as JaxObjective
from repro.instances import MatchingInstanceSpec as JaxSpec
from repro.instances import bucketize as jax_bucketize
from repro.instances import generate_matching_instance as jax_generate
from repro.instances.buckets import Bucket as JaxBucket
from repro.instances.buckets import convert_bucket as jax_convert_bucket
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core.objective import MatchingObjective, binned_segment_sum, segment_plan
from repro_torch.kernels import dual_oracle as kdo
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _random_bucket(rng, n, L, m, J, padded_rows):
    """Random slab with repeated idx within rows and fully padded rows."""
    idx = rng.integers(0, J, size=(n, L)).astype(np.int32)
    coeff = rng.random((m, n, L)).astype(np.float32)
    cost = rng.normal(size=(n, L)).astype(np.float32)
    mask = (rng.random((n, L)) < 0.8).astype(np.float32)
    mask[:padded_rows] = 0.0
    return idx * mask.astype(np.int32), coeff * mask[None], cost * mask, mask


def _both(dtype, n, L, m, J, seed, padded_rows=5):
    """The same bucket as JAX arrays and as port tensors (via convert)."""
    rng = np.random.default_rng(seed)
    idx, coeff, cost, mask = _random_bucket(rng, n, L, m, J, padded_rows)
    bj = jax_convert_bucket(
        JaxBucket(idx=idx, coeff=coeff, cost=cost, mask=mask, length=L), dtype
    )
    opt = lambda a: None if a is None else convert.tensor_from_numpy(a, "cpu")
    bt = dict(
        idx=opt(bj.idx), coeff=opt(bj.coeff), cost=opt(bj.cost), mask=opt(bj.mask),
        coeff_scale=opt(bj.coeff_scale), cost_scale=opt(bj.cost_scale),
    )
    lam = rng.random(m * J).astype(np.float32)
    return bj, bt, lam


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _assert_oracle_close(got, want, msg=""):
    for a, b, name in zip(got, want, ["x", "hist", "lin", "sq"]):
        np.testing.assert_allclose(
            _np(a), _np(b), atol=3e-5, rtol=1e-5, err_msg=f"{name} {msg}"
        )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("L,m", [(4, 1), (32, 3), (64, 2)])
@pytest.mark.parametrize("inequality", [True, False])
def test_dual_oracle_ref_matches_reference(dtype, L, m, inequality):
    J, n = 24, 21
    bj, bt, lam = _both(dtype, n, L, m, J, seed=L + m)
    # one trace of the interpret-mode kernel serves every gamma
    kernel = jax.jit(functools.partial(
        jops.fused_dual_oracle, num_destinations=J, interpret=True,
        radius=1.0, inequality=inequality,
    ))
    for gamma in [0.05, 1.0, 50.0]:
        kw = dict(radius=1.0, inequality=inequality)
        got = tref.dual_oracle_ref(
            bt["idx"], bt["coeff"], bt["cost"], bt["mask"], torch.from_numpy(lam),
            gamma, J, coeff_scale=bt["coeff_scale"], cost_scale=bt["cost_scale"],
            **kw,
        )
        jkw = dict(coeff_scale=bj.coeff_scale, cost_scale=bj.cost_scale, **kw)
        want_ref = jref.dual_oracle_ref(
            bj.idx, bj.coeff, bj.cost, bj.mask, jnp.asarray(lam), gamma, J, **jkw
        )
        want_kernel = kernel(
            bj.idx, bj.coeff, bj.cost, bj.mask, jnp.asarray(lam),
            jnp.float32(gamma), coeff_scale=bj.coeff_scale,
            cost_scale=bj.cost_scale,
        )
        _assert_oracle_close(got, want_ref, f"vs ref {dtype} gamma={gamma}")
        _assert_oracle_close(got, want_kernel, f"vs kernel {dtype} gamma={gamma}")
        x = got[0]
        assert x.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        assert got[1].dtype == torch.float32
        assert float(x[:5].float().abs().max()) == 0.0  # padded rows exactly 0


def test_fused_dual_oracle_routes_cpu_to_ref_and_counts_width_routing():
    J, m = 16, 2
    bj, bt, lam = _both("float32", 9, 8, m, J, seed=1)
    args = (bt["idx"], bt["coeff"], bt["cost"], bt["mask"], torch.from_numpy(lam), 0.7)
    before = tops.width_routed
    got = tops.fused_dual_oracle(*args, num_destinations=J)
    want = tref.dual_oracle_ref(*args, J)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert tops.width_routed == before
    # non-power-of-two width: the unfused oracle, counted
    rng = np.random.default_rng(2)
    idx, coeff, cost, mask = _random_bucket(rng, 5, 12, m, J, 0)
    t = [torch.from_numpy(a) for a in (idx, coeff, cost, mask)]
    got = tops.fused_dual_oracle(*t, torch.from_numpy(lam), 0.7, num_destinations=J)
    assert tops.width_routed == before + 1
    want = jops.fused_dual_oracle(
        idx, coeff, cost, mask, jnp.asarray(lam), jnp.float32(0.7),
        num_destinations=J, interpret=True,
    )
    _assert_oracle_close(got, want)
    with pytest.raises(ValueError, match="device"):
        tops.fused_dual_oracle(
            *(a.to("meta") for a in args[:5]), 0.7, num_destinations=J
        )


def test_kernel_wrapper_refuses_what_it_cannot_take():
    J, m = 16, 1
    _, bt, lam = _both("float32", 9, 8, m, J, seed=3)
    args = (bt["idx"], bt["coeff"], bt["cost"], bt["mask"], torch.from_numpy(lam), 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        kdo.dual_oracle(*args, num_destinations=J)
    # capacity gate: the [m, J] histogram must fit in shared memory
    with pytest.raises(ValueError, match="capacity"):
        kdo.plan_launch(1000, 8, 2, 40_000, 132)
    # main-path bucket: one block histogram + lam in smem, two blocks per SM
    plan = kdo.plan_launch(500_000, 8, 1, 10_000, 132)
    assert plan.lam_in_smem and plan.warps == 8 and plan.grid == 2 * 132
    assert plan.smem_bytes == 4 * (2 * 10_000 + 16 + 2 * 8 * 128 + 8)
    # small bucket: as many blocks as it has tiles of 8 warps x 4 x 32 slots
    assert kdo.plan_launch(2616, 1, 1, 10_000, 132).grid == 3
    # wide rows: a histogram and two 32 KB rows per warp, a warp per row
    wide = kdo.plan_launch(29, 8192, 3, 64, 132)
    assert wide.warps == 3 and wide.grid == 10
    # the cumsum order of PyTorch's CUDA scan: chunks of 2 * num_threads_x
    assert [kdo._scan_chunk(n, L) for n, L in
            [(9, 8192), (37, 512), (1000, 64), (10**6, 64), (20, 16)]] == [
        1024, 128, 32, 64, 16]
    far = kdo.plan_launch(1000, 8, 1, 40_000, 132)  # lam read through L1/L2
    assert not far.lam_in_smem and far.warps == 8


def test_slot_bytes_model():
    assert tops.oracle_slab_slot_bytes(1, "float32") == 20
    assert tops.oracle_slab_slot_bytes(1, "bfloat16") == 12
    assert tops.oracle_slab_slot_bytes(1, "int8") == 11
    assert tops.oracle_slab_slot_bytes(3, torch.float32) == jops.oracle_slab_slot_bytes(3)
    assert tops.oracle_hist_partial_bytes(500_000, 8, 1, 10_000, 132) == 2 * 4 * 264 * 10_000


def test_binned_segment_sum_matches_scatter():
    rng = np.random.default_rng(1)
    m, n, L, J = 3, 17, 8, 23
    idx = rng.integers(0, J, size=(n, L)).astype(np.int32)
    contrib = rng.normal(size=(m, n, L)).astype(np.float32)
    got = binned_segment_sum(torch.from_numpy(idx), torch.from_numpy(contrib), J)
    want = np.zeros((m, J), np.float32)
    for k in range(m):
        np.add.at(want, (k, idx.ravel()), contrib[k].ravel())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_binned_segment_sum_is_index_add_in_slot_order():
    """The fixed-order sum adds each bin's slots in slot order: on the CPU
    bitwise what `index_add_` gives, empty bins 0, with or without a plan."""
    rng = np.random.default_rng(2)
    m, n, L, J = 2, 300, 16, 50
    idx = torch.from_numpy(rng.integers(0, J - 5, size=(n, L)).astype(np.int32))
    contrib = torch.from_numpy(rng.normal(size=(m, n, L)).astype(np.float32))
    seg = (idx.reshape(1, -1).long() + torch.arange(m)[:, None] * J).reshape(-1)
    want = torch.zeros(m * J).index_add_(0, seg, contrib.reshape(-1)).reshape(m, J)
    plan = segment_plan(idx, m, J)
    assert torch.equal(binned_segment_sum(idx, contrib, J, plan), want)
    assert torch.equal(binned_segment_sum(idx, contrib, J), want)
    assert not want[:, J - 5:].any()


@pytest.fixture(scope="module")
def packed_pair():
    spec = JaxSpec(num_sources=300, num_destinations=40, avg_degree=5.0,
                   num_families=2, seed=7)
    pj = jax_bucketize(jax_generate(spec))
    return pj, convert.instance_from_reference(pj, device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("include_rhs", [True, False])
def test_calculate_matches_reference(packed_pair, fused, include_rhs):
    pj, pt = packed_pair
    lam = np.random.default_rng(0).random(pj.dual_dim).astype(np.float32)
    jax_calculate = jax.jit(JaxObjective(pj, include_rhs=include_rhs).calculate)
    for gamma in [0.05, 1.0, 50.0]:
        want = jax_calculate(jnp.asarray(lam), jnp.float32(gamma))
        got = MatchingObjective(
            pt, include_rhs=include_rhs, fused_oracle=fused
        ).calculate(torch.from_numpy(lam), gamma)
        assert _rel(float(got.g), float(want.g)) <= 1e-6, gamma
        assert _rel(got.grad.numpy(), want.grad) <= 1e-6, gamma
        assert _rel(got.ax.numpy(), want.ax) <= 1e-6, gamma
        for xt, xj in zip(got.x_slabs, want.x_slabs):
            np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=3e-5)


def test_apply_A_AT_and_violation_match(packed_pair):
    pj, pt = packed_pair
    rng = np.random.default_rng(4)
    lam = rng.random(pj.dual_dim).astype(np.float32)
    jo, to = JaxObjective(pj), MatchingObjective(pt)
    for a, b in zip(to.apply_AT(torch.from_numpy(lam)), jo.apply_AT(jnp.asarray(lam))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-6)
    xs = [rng.random(b.idx.shape).astype(np.float32) for b in pj.buckets]
    got = to.apply_A([torch.from_numpy(x) for x in xs])
    want = jo.apply_A([jnp.asarray(x) for x in xs])
    assert _rel(got.numpy(), want) <= 1e-6
    assert _rel(
        float(to.max_violation([torch.from_numpy(x) for x in xs])),
        float(jo.max_violation([jnp.asarray(x) for x in xs])),
    ) <= 1e-6
