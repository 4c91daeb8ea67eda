"""Card-only tests of the port: the three hand-written kernels (the dual
oracle, the primal step and the simplex projection) against their plain
PyTorch versions, the dual oracle as the PDHG engine's fused prox step, and
small solves through them against the same solves on the CPU.

Every test is marked `cuda` and skips (in a fixture, at run time) when
`torch.cuda.is_available()` is False.  Run on a machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: x atol 3e-5 (fp32, int8) / 2e-2 (bf16) as tests/test_kernels.py;
hist, c'x and ||x||^2 atol 3e-5 + rtol 1e-5 as tests/test_dual_oracle.py.
The primal-step kernel calls the oracle's own __device__ functions, so its x
is held bitwise equal to the oracle's; the simplex kernel's x is held bitwise
equal to its plain version's in each row form, whole call or one slab, under
any grid.  The oracle sums A x in int64 fixed
point, exactly, so its A x is held bitwise equal to `ref.fixed_point_hist`
and the same under any grid.
No JAX here: the machine with the card need not have it.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Maximizer, MaximizerConfig, MatchingObjective
from repro_torch.instances import (
    MatchingInstanceSpec, bucketize, generate_matching_instance,
)
from repro_torch.instances.buckets import Bucket, convert_bucket
from repro_torch.core.projections import UnitSimplexProjection
from repro_torch.engines.pdhg import PDHGEngineConfig, pdhg_raw_solve
from repro_torch.kernels import dual_oracle as kdo
from repro_torch.kernels import dual_primal as kdp
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import simplex_proj as ksp

pytestmark = pytest.mark.cuda

X_ATOL = {"float32": 3e-5, "bfloat16": 2e-2, "int8": 3e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _bucket(seed, n, L, m, J, dtype, device, padded_rows=5):
    rng = np.random.default_rng(seed)
    mask = (rng.random((n, L)) < 0.8).astype(np.float32)
    mask[:padded_rows] = 0.0
    idx = (rng.integers(0, J, size=(n, L)) * mask).astype(np.int32)
    coeff = (rng.random((m, n, L)) * mask[None]).astype(np.float32)
    cost = (rng.normal(size=(n, L)) * mask).astype(np.float32)
    b = Bucket(idx=torch.from_numpy(idx), coeff=torch.from_numpy(coeff),
               cost=torch.from_numpy(cost), mask=torch.from_numpy(mask), length=L)
    lam = torch.from_numpy(rng.random(m * J).astype(np.float32)).to(device)
    return convert_bucket(b, dtype).to(device), lam


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("L,m", [(1, 1), (8, 1), (32, 3), (64, 3), (512, 1)])
@pytest.mark.parametrize("inequality", [True, False])
def test_kernel_matches_plain_version(cuda, dtype, L, m, inequality):
    J, n = 64, 300 if L <= 64 else 20
    b, lam = _bucket(L * 10 + m, n, L, m, J, dtype, cuda)
    for gamma in (0.01, 1.0, 100.0):
        args = (b.idx, b.coeff, b.cost, b.mask, lam, gamma)
        kw = dict(radius=1.0, inequality=inequality,
                  coeff_scale=b.coeff_scale, cost_scale=b.cost_scale)
        x, hist, lin, sq = kops.fused_dual_oracle(*args, num_destinations=J, **kw)
        wx, whist, wlin, wsq = kref.dual_oracle_ref(*args, J, **kw)
        assert x.dtype == wx.dtype
        np.testing.assert_allclose(
            x.float().cpu().numpy(), wx.float().cpu().numpy(), atol=X_ATOL[dtype]
        )
        for a, w in ((hist, whist), (lin, wlin), (sq, wsq)):
            np.testing.assert_allclose(
                a.cpu().numpy(), w.cpu().numpy(), atol=3e-5, rtol=1e-5
            )
        assert float(x[:5].float().abs().max()) == 0.0


def test_kernel_is_bitwise_deterministic(cuda):
    b, lam = _bucket(1, 5000, 16, 2, 64, "float32", cuda)
    args = (b.idx, b.coeff, b.cost, b.mask, lam, 0.5)
    first = kdo.dual_oracle(*args, num_destinations=64)
    second = kdo.dual_oracle(*args, num_destinations=64)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


def test_kernel_refuses_what_it_cannot_take(cuda):
    b, lam = _bucket(2, 50, 8, 1, 64, "float32", cuda)
    args = (b.idx, b.coeff, b.cost, b.mask, lam, 1.0)
    with pytest.raises(ValueError, match="dtype"):
        kdo.dual_oracle(b.idx, b.coeff.half(), b.cost.half(), b.mask.half(),
                        lam, 1.0, num_destinations=64)
    with pytest.raises(ValueError, match="lam"):  # lam of the wrong size
        kops.fused_dual_oracle(*args[:4], torch.zeros(60_000, device=cuda), 1.0,
                               num_destinations=64)
    with pytest.raises(ValueError, match="contiguous"):
        kdo.dual_oracle(b.idx.t().contiguous().t(), *args[1:], num_destinations=64)


def _slabs(seed, widths, n, m, J, dtype, device):
    """Buckets of several widths (padded rows, repeated idx) and one lam."""
    out = [_bucket(seed + k, n if L <= 64 else 9, L, m, J, dtype, device)
           for k, L in enumerate(widths)]
    return [b for b, _ in out], out[0][1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("inequality", [True, False])
def test_whole_call_matches_plain_and_fixed_point(cuda, dtype, m, inequality):
    """One oracle call over buckets of widths 1..32 and 64 (one narrow and one
    wide launch, one finalize) against the plain whole call; A x bitwise the
    fixed-point plain sum."""
    J = 64
    buckets, lam = _slabs(7, (1, 2, 8, 32, 64), 300, m, J, dtype, cuda)
    plan = kops.plan_slab_kernel("dual_oracle", buckets, J, inequality=inequality)
    assert [p.wide for p in plan.launches] == [False, True]
    for gamma in (0.01, 1.0, 100.0):
        before, fin = kdo.launches, kdo.finalize_launches
        xs, ax, lin, sq = kops.fused_dual_oracle_call(
            buckets, lam, gamma, num_destinations=J, inequality=inequality, plan=plan)
        assert (kdo.launches - before, kdo.finalize_launches - fin) == (2, 1)
        wxs, wax, wlin, wsq = kref.dual_oracle_call_ref(buckets, lam, gamma, J,
                                                        inequality=inequality)
        for x, wx in zip(xs, wxs):
            assert x.dtype == wx.dtype
            np.testing.assert_allclose(x.float().cpu().numpy(), wx.float().cpu().numpy(),
                                       atol=X_ATOL[dtype])
        for a, w in ((ax, wax), (lin, wlin), (sq, wsq)):
            np.testing.assert_allclose(a.cpu().numpy(), w.cpu().numpy(), atol=3e-5, rtol=1e-5)
        fixed = kref.fixed_point_hist(buckets, lam, gamma, J, plan.shift,
                                      inequality=inequality)
        assert torch.equal(ax, fixed)


@pytest.mark.parametrize("J", [10_000, 40_000])
def test_ax_is_the_same_under_any_grid(cuda, J):
    """A x is exact, so three grids give the same bits, with the histogram
    in shared memory (J = 10k) and past it, in global memory (J = 40k)."""
    buckets, lam = _slabs(3, (4, 8, 16), 5000, 1, J, "float32", cuda)
    plans = [kops.plan_slab_kernel("dual_oracle", buckets, J)]
    plans += [kdo.plan_slabs("dual_oracle", buckets, J, grid=g) for g in (7, 1)]
    modes = {p.launches[0].layout.hist_mode for p in plans}
    assert modes == {kdo.HIST_GLOBAL if J > 29_000 else kdo.HIST_SHARED}
    assert len({p.launches[0].grid for p in plans}) == 3
    outs = [kdo.oracle_call(p, lam, 0.5) for p in plans]
    for xs, ax, lin, sq in outs[1:]:
        assert torch.equal(ax, outs[0][1])
        assert all(torch.equal(a, b) for a, b in zip(xs, outs[0][0]))
    fixed = kref.fixed_point_hist(buckets, lam, 0.5, J, plans[0].shift)
    assert torch.equal(outs[0][1], fixed)


def test_primal_call_is_one_launch_and_the_oracles_x(cuda):
    buckets, lam = _slabs(11, (1, 4, 16, 32), 700, 2, 64, "bfloat16", cuda)
    plan = kops.plan_slab_kernel("dual_primal", buckets, 64)
    before = kdp.launches
    xs = kops.fused_dual_primal_call(buckets, lam, 0.3, num_destinations=64, plan=plan)
    assert kdp.launches - before == 1
    oracle_xs = kops.fused_dual_oracle_call(buckets, lam, 0.3, num_destinations=64)[0]
    assert all(torch.equal(a, b) for a, b in zip(xs, oracle_xs))


def test_fused_solve_launches_kernel_and_matches_cpu(cuda):
    spec = MatchingInstanceSpec(num_sources=3000, num_destinations=60,
                                avg_degree=6.0, num_families=2, seed=4)
    edges = generate_matching_instance(spec)
    cfg = MaximizerConfig(iters_per_stage=20)
    kdo.launches = kdo.finalize_launches = 0
    kops.width_routed = 0
    packed = bucketize(edges, device=cuda)
    obj = MatchingObjective(packed, fused_oracle=True)
    on_card = Maximizer(obj, cfg).solve()
    calls = cfg.total_iters + 1
    wide = sum(b.length > 32 for b in packed.buckets)
    assert len(obj.kernel_plan("dual_oracle").launches) == 1 + wide
    assert kdo.launches == (1 + wide) * calls and kdo.finalize_launches == calls
    assert kops.width_routed == 0
    on_cpu = Maximizer(
        MatchingObjective(packed.to("cpu"), fused_oracle=True), cfg
    ).solve()
    rel = float(torch.linalg.vector_norm(on_card.lam.cpu() - on_cpu.lam)
                / torch.linalg.vector_norm(on_cpu.lam))
    assert rel <= 1e-4
    assert abs(float(on_card.g) - float(on_cpu.g)) <= 1e-5 * abs(float(on_cpu.g))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("L,m", [(1, 1), (8, 2), (32, 3), (64, 3), (8192, 1)])
@pytest.mark.parametrize("inequality", [True, False])
def test_primal_kernel_matches_plain_version_and_oracle(cuda, dtype, L, m, inequality):
    J, n = 64, 300 if L <= 64 else 7
    b, lam = _bucket(L * 10 + m + 1, n, L, m, J, dtype, cuda)
    for gamma in (0.01, 1.0, 100.0):
        args = (b.idx, b.coeff, b.cost, b.mask, lam, gamma)
        kw = dict(radius=1.0, inequality=inequality,
                  coeff_scale=b.coeff_scale, cost_scale=b.cost_scale)
        x = kops.fused_dual_primal(*args, num_destinations=J, **kw)
        want = kref.dual_primal_ref(*args, J, **kw)
        assert x.dtype == want.dtype
        np.testing.assert_allclose(
            x.float().cpu().numpy(), want.float().cpu().numpy(), atol=X_ATOL[dtype]
        )
        assert float(x[:5].float().abs().max()) == 0.0
        oracle_x = kdo.dual_oracle(*args, num_destinations=J, **kw)[0]
        assert torch.equal(x, oracle_x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("L,n,m,J", [(16, 3000, 1, 70_000), (256, 37, 3, 20_000)])
def test_primal_kernel_reads_lam_through_l2(cuda, dtype, L, n, m, J):
    """m*J past shared memory: the plan reads lam through L1/L2."""
    assert not kdo.primal_layout(L, m, J).lam_in_smem
    b, lam = _bucket(L + m, n, L, m, J, dtype, cuda)
    for gamma, inequality in ((0.01, True), (1.0, False), (100.0, True)):
        args = (b.idx, b.coeff, b.cost, b.mask, lam, gamma)
        kw = dict(radius=2.5, inequality=inequality,
                  coeff_scale=b.coeff_scale, cost_scale=b.cost_scale)
        x = kops.fused_dual_primal(*args, num_destinations=J, **kw)
        want = kref.dual_primal_ref(*args, J, **kw)
        assert x.dtype == want.dtype
        np.testing.assert_allclose(
            x.float().cpu().numpy(), want.float().cpu().numpy(), atol=X_ATOL[dtype]
        )
        assert float(x[:5].float().abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 4, 32, 64, 1024, 8192])
@pytest.mark.parametrize("inequality", [True, False])
@pytest.mark.parametrize("radius", [1.0, 2.5])
def test_simplex_kernel_matches_plain_version(cuda, dtype, L, inequality, radius):
    rng = np.random.default_rng(L)
    n = 500 if L <= 64 else 9
    v = torch.from_numpy((rng.normal(size=(n, L)) * 2).astype(np.float32))
    mask = torch.from_numpy((rng.random((n, L)) < 0.7).astype(np.float32))
    mask[:3] = 0.0
    v, mask = v.to(cuda, dtype), mask.to(cuda, dtype)
    got = kops.fused_project_simplex(v, mask, radius=radius, inequality=inequality)
    want = kref.simplex_ref(v, mask, radius, inequality=inequality)
    assert got.dtype == dtype
    atol = 3e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), atol=atol)
    assert float(got[:3].float().abs().max()) == 0.0


def test_primal_and_simplex_kernels_refuse_what_they_cannot_take(cuda):
    b, lam = _bucket(3, 50, 8, 1, 64, "float32", cuda)
    with pytest.raises(ValueError, match="dtype"):
        kdp.dual_primal(b.idx, b.coeff.half(), b.cost.half(), b.mask.half(),
                        lam, 1.0, num_destinations=64)
    with pytest.raises(ValueError, match="contiguous"):
        kdp.dual_primal(b.idx.t().contiguous().t(), b.coeff, b.cost, b.mask, lam,
                        1.0, num_destinations=64)
    with pytest.raises(ValueError, match="dtype"):
        ksp.simplex_proj(b.cost.half(), b.mask.half())
    with pytest.raises(ValueError, match="share one dtype"):
        ksp.simplex_proj(b.cost, b.mask.bfloat16())
    with pytest.raises(ValueError, match="power of two"):
        ksp.simplex_proj(b.cost[:, :6].contiguous(), b.mask[:, :6].contiguous())


def _small_solve(device, **objective_kw):
    """The solve, and the kernel launches per call of its plan: one, plus
    one per bucket wider than 32."""
    spec = MatchingInstanceSpec(num_sources=3000, num_destinations=60,
                                avg_degree=6.0, num_families=2, seed=4)
    packed = bucketize(generate_matching_instance(spec), device=device)
    obj = MatchingObjective(packed, **objective_kw)
    res = Maximizer(obj, MaximizerConfig(iters_per_stage=20)).solve()
    return res, 1 + sum(b.length > 32 for b in packed.buckets)


def _rel_lam(a, b):
    return float(torch.linalg.vector_norm(a.lam.cpu() - b.lam)
                 / torch.linalg.vector_norm(b.lam))


def test_fused_kernel_solve_launches_kernel_and_matches_cpu(cuda):
    kdp.launches = 0
    kops.width_routed = 0
    on_card, per_call = _small_solve(cuda, fused_kernel=True)
    assert kdp.launches == per_call * (MaximizerConfig(iters_per_stage=20).total_iters + 1)
    assert kops.width_routed == 0
    on_cpu, _ = _small_solve("cpu", fused_kernel=True)
    assert _rel_lam(on_card, on_cpu) <= 1e-6


def test_simplex_kernel_solve_launches_kernel_and_matches_cpu(cuda):
    ksp.launches = 0
    proj = UnitSimplexProjection(use_kernel=True)
    on_card, per_call = _small_solve(cuda, projection=proj)
    assert ksp.launches == per_call * (MaximizerConfig(iters_per_stage=20).total_iters + 1)
    on_cpu, _ = _small_solve("cpu", projection=proj)
    assert _rel_lam(on_card, on_cpu) <= 1e-6


def _candidates(seed, widths, n, dtype, device):
    """Random candidate slabs (scale 2, padded rows) and {0, 1} masks."""
    rng = np.random.default_rng(seed)
    vs, masks = [], []
    for L in widths:
        rows = n if L <= 64 else 9
        v = torch.from_numpy((rng.normal(size=(rows, L)) * 2).astype(np.float32))
        mask = torch.from_numpy((rng.random((rows, L)) < 0.7).astype(np.float32))
        mask[:3] = 0.0
        vs.append(v.to(device, dtype))
        masks.append(mask.to(device, dtype))
    return vs, masks


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inequality", [True, False])
def test_simplex_whole_call_is_one_launch_and_bitwise_plain(cuda, dtype, inequality):
    """Six buckets of widths 1..32, both row forms, in one launch."""
    vs, masks = _candidates(21, (1, 2, 4, 8, 16, 32), 3000, dtype, cuda)
    for radius in (1.0, 2.5):
        before = ksp.launches
        got = kops.fused_project_simplex_call(vs, masks, radius=radius, inequality=inequality)
        assert ksp.launches - before == 1
        for g, v, m in zip(got, vs, masks):
            assert g.dtype == dtype
            assert torch.equal(g, kref.simplex_ref(v, m, radius, inequality=inequality))
            assert float(g[:3].float().abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_simplex_one_slab_and_whole_call_are_equal(cuda, dtype):
    vs, masks = _candidates(22, (4, 16, 32, 64, 1024), 2000, dtype, cuda)
    plan = ksp.plan_simplex([tuple(v.shape) for v in vs], dtype, cuda)
    assert [p.wide for p in plan.launches] == [False, True, True]
    whole = ksp.simplex_call(plan, vs, masks)
    for w, v, m in zip(whole, vs, masks):
        assert torch.equal(w, ksp.simplex_proj(v, m))


def test_simplex_result_is_the_same_under_any_grid(cuda):
    vs, masks = _candidates(23, (2, 8, 16, 32), 20_000, torch.float32, cuda)
    shapes = [tuple(v.shape) for v in vs]
    plans = [ksp.plan_simplex(shapes, torch.float32, cuda, grid=g) for g in (None, 7, 1)]
    assert len({p.launches[0].grid for p in plans}) == 3
    outs = [ksp.simplex_call(p, vs, masks) for p in plans]
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("inequality", [True, False])
def test_simplex_row_forms_are_bitwise_plain(cuda, dtype, L, inequality):
    """Rows in registers (L <= REGISTER_MAX_WIDTH) and warp segments, at
    both radii, rows of 1 to 3000 (a partial last warp task)."""
    for n in (1, 37, 3000):
        vs, masks = _candidates(L + n, (L,), n, dtype, cuda)
        for radius in (1.0, 2.5):
            got = ksp.simplex_proj(vs[0], masks[0], radius, inequality=inequality)
            want = kref.simplex_ref(vs[0], masks[0], radius, inequality=inequality)
            assert torch.equal(got, want), (n, radius)


def test_simplex_call_refuses_what_the_plan_does_not_take(cuda):
    vs, masks = _candidates(24, (8, 16), 100, torch.float32, cuda)
    plan = ksp.plan_simplex([tuple(v.shape) for v in vs], torch.float32, cuda)
    with pytest.raises(ValueError, match="slabs"):
        ksp.simplex_call(plan, vs[:1], masks[:1])
    with pytest.raises(ValueError, match=r"\[100, 8\]"):
        ksp.simplex_call(plan, [vs[0][:50], vs[1]], [masks[0][:50], masks[1]])
    with pytest.raises(ValueError, match="dtype"):
        ksp.simplex_call(plan, [vs[0].bfloat16(), vs[1]], [masks[0].bfloat16(), masks[1]])
    flat = torch.zeros(100 * 8 + 1, device=cuda)
    shifted = flat[1:].view(100, 8)  # contiguous, 4 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        ksp.simplex_call(plan, [shifted, vs[1]], [masks[0], masks[1]])
    with pytest.raises(ValueError, match="feasible set"):
        kops.fused_project_simplex_call(vs, masks, radius=2.0, plan=plan)


# -- the dual oracle as the PDHG engine's fused prox step ----------------------------


def _pdhg_inputs(seed, buckets, J, m, device):
    """A nonzero primal x per bucket (0 on pad slots) and random duals y."""
    rng = np.random.default_rng(seed)
    xs = [torch.from_numpy(rng.random(tuple(b.cost.shape)).astype(np.float32)).to(device)
          * b.mask for b in buckets]
    y = torch.from_numpy(rng.random(m * J).astype(np.float32)).to(device)
    return xs, y


def _held_pdhg_step(step, xs, y, tau, J):
    """One whole-call step held bitwise: cost_eff against the CPU's two
    roundings, x+ against the plain whole call on the same cost_eff, A x+
    against the fixed-point plain sum."""
    got_xs, got_ax = kops.fused_pdhg_step_call(step, xs, y, tau)
    inv_tau = float(np.float32(1.0) / np.float32(tau))
    for c, x, s in zip(step.costs, xs, step.slabs):
        want = torch.sub(c.cpu(), torch.mul(x.cpu(), inv_tau))
        assert torch.equal(s.cost.cpu(), want)
    want_xs, _, _, _ = kref.dual_oracle_call_ref(step.slabs, y, inv_tau, J)
    assert all(torch.equal(a, b) for a, b in zip(got_xs, want_xs))
    fixed = kref.fixed_point_hist(step.slabs, y, inv_tau, J, step.plan.shift)
    assert torch.equal(got_ax, fixed)
    return got_xs


@pytest.mark.parametrize("L", [1, 8, 16, 32, 64])
def test_pdhg_step_is_bitwise_plain(cuda, L):
    J, m = 64, 2
    buckets, _ = _slabs(40 + L, (L,), 400, m, J, "float32", cuda)
    step = kops.plan_pdhg_step(buckets, [b.cost for b in buckets], num_destinations=J)
    xs, y = _pdhg_inputs(L, buckets, J, m, cuda)
    before, fin = kdo.launches, kdo.finalize_launches
    _held_pdhg_step(step, xs, y, 0.37, J)
    assert (kdo.launches - before, kdo.finalize_launches - fin) == (1, 1)


def test_pdhg_step_plan_is_reused_with_buffers_rewritten(cuda):
    """One plan over six buckets of widths 1-32: one oracle launch and one
    finalize per call; three iterations rewrite the cost_eff buffers in place
    (same pointers, same plan) and each step is bitwise its plain version."""
    J, m = 64, 1
    buckets, _ = _slabs(50, (1, 2, 4, 8, 16, 32), 500, m, J, "float32", cuda)
    step = kops.plan_pdhg_step(buckets, [b.cost for b in buckets], num_destinations=J)
    assert step.launches_per_call == 1
    ptrs = [s.cost.data_ptr() for s in step.slabs]
    xs, y = _pdhg_inputs(5, buckets, J, m, cuda)
    for it in range(3):
        before, fin = kdo.launches, kdo.finalize_launches
        xs = _held_pdhg_step(step, xs, y, 0.5 + 0.1 * it, J)
        assert (kdo.launches - before, kdo.finalize_launches - fin) == (1, 1)
        y = torch.clamp_min(y + 0.1 * torch.randn_like(y), 0.0)
    assert [s.cost.data_ptr() for s in step.slabs] == ptrs


def test_fused_pdhg_solve_launches_kernel_and_matches_cpu(cuda):
    spec = MatchingInstanceSpec(num_sources=3000, num_destinations=60,
                                avg_degree=6.0, num_families=2, seed=4)
    cfg = MaximizerConfig(gammas=(0.01,), iters_per_stage=400, check_every=50)
    pcfg = PDHGEngineConfig(restart="adaptive", dense="off")
    packed = bucketize(generate_matching_instance(spec), device=cuda)
    kdo.launches = kdo.finalize_launches = 0
    on_card = pdhg_raw_solve(packed, torch.zeros(packed.dual_dim, device=cuda), cfg,
                             normalize=False, fused_oracle=True, pcfg=pcfg)
    per_call = 1 + sum(b.length > 32 for b in packed.buckets)
    assert kdo.launches == per_call * 400 and kdo.finalize_launches == 400
    cpu = packed.to("cpu")
    on_cpu = pdhg_raw_solve(cpu, torch.zeros(cpu.dual_dim), cfg, normalize=False,
                            fused_oracle=True, pcfg=pcfg)
    assert abs(float(on_card.g) - float(on_cpu.g)) <= 1e-5 * abs(float(on_cpu.g))
