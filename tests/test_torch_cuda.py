"""Card-only tests of the port: the three hand-written kernels (the dual
oracle, the primal step and the simplex projection) against their plain
PyTorch versions, the dual oracle as the PDHG engine's fused prox step, and
small solves through them against the same solves on the CPU, and a
span's device clock against CUDA events; then the recurring-solve path:
the scatter-plan replay bitwise a fresh upload, a warm solve after a replay
bitwise the same solve on a fresh upload (no kernel plan outlives its
instance), and the COO PDHG baseline deterministic on the
card and ending where the CPU's does; then the service: the oracle over a
tenant axis (B stacked instances in one call) bitwise each lane's solo
call, the primal step over a list of requested rows bitwise the whole-slab
call's rows, one launch per call of each, the batched pool's lanes against
their solo solves, and a served batch bitwise the direct projection of its
snapshot on the card.  And the LM substrate (no kernel of the port): every
reduced architecture in fp32 compute on the card against the CPU (prefill
and two decode steps, rtol 1e-4 + atol 1e-5), and a bf16 MoE decode step
(MLA, the fixed-order combine, both routers) bitwise the same in two runs;
its training path: every reduced architecture's loss and gradients in fp32
on the card against the CPU (rtol 1e-4 + atol 1e-5), a few bf16 train
steps with the in-place AdamW bitwise the functional one, and the loop
resumed from a checkpoint bitwise the uninterrupted run; over a mesh of
shape (1, 1) (DTensor over a one-rank NCCL group): the sharded train step
of three reduced archs and `make_serve_fns` bitwise the single-device ones.

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
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_reduced_config
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
from repro_torch.models import Model

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


def test_span_device_clock_agrees_with_cuda_events(cuda):
    """A `device=` span's `device_ms` around dual-oracle calls agrees
    with CUDA events recorded around the same calls within 5%."""
    from repro_torch import telemetry

    spec = MatchingInstanceSpec(num_sources=200_000, num_destinations=1000,
                                avg_degree=8.0, seed=5)
    obj = MatchingObjective(bucketize(generate_matching_instance(spec), device=cuda),
                            fused_oracle=True)
    lam = torch.rand(obj.dual_dim, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(2))
    obj.calculate(lam, 0.1)  # builds the kernel and its plan
    torch.cuda.synchronize()
    tracer, want = telemetry.Tracer(), []
    prev = telemetry.set_tracer(tracer)
    try:
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            with telemetry.span("oracle", device=cuda):
                for _ in range(50):
                    obj.calculate(lam, 0.1)
            end.record()
            torch.cuda.synchronize()
            want.append(start.elapsed_time(end))
    finally:
        telemetry.set_tracer(prev)
    got = [e["args"]["device_ms"] for e in tracer.events()]
    assert len(got) == 3
    for g, w in zip(got, want):
        assert abs(g - w) <= 0.05 * w, (got, want)


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


# -- the recurring-solve path: replay on the card, plans, the COO baseline ----


def _cadence_ingestor(dtype):
    from repro_torch.instances import DeltaIngestor

    spec = MatchingInstanceSpec(num_sources=3000, num_destinations=60, avg_degree=6.0,
                                num_families=2, seed=9)
    base = generate_matching_instance(spec)
    return base, DeltaIngestor(base, row_headroom=8, dtype=dtype)


def _cadence_delta(edges, rng, n_upd=200, n_ins=3, n_del=3):
    """A mixed delta on `edges`: value and coefficient updates, inserts,
    deletes and an rhs replacement."""
    from repro_torch.instances import InstanceDelta

    m, J, I = edges.spec.num_families, edges.spec.num_destinations, edges.spec.num_sources
    perm = rng.permutation(edges.nnz)
    upd, dele = perm[:n_upd], perm[n_upd:n_upd + n_del]
    existing = set((edges.src * J + edges.dst).tolist())
    ins = []
    while len(ins) < n_ins:
        s, d = int(rng.integers(I)), int(rng.integers(J))
        if s * J + d not in existing:
            existing.add(s * J + d)
            ins.append((s, d))
    return InstanceDelta(
        insert_src=[s for s, _ in ins], insert_dst=[d for _, d in ins],
        insert_values=rng.uniform(0.1, 3.0, n_ins), insert_coeff=rng.uniform(0.1, 2.0, (m, n_ins)),
        delete_src=edges.src[dele], delete_dst=edges.dst[dele],
        update_src=edges.src[upd], update_dst=edges.dst[upd],
        update_values=edges.values[upd] * rng.uniform(0.9, 1.1, n_upd),
        update_coeff=rng.uniform(0.1, 2.0, (m, n_upd)),
        rhs=edges.rhs * rng.uniform(0.98, 1.02, edges.rhs.size),
    )


def _bitwise_instances(a, b):
    return all(torch.equal(getattr(x, k).cpu().view(torch.uint8),
                           getattr(y, k).cpu().view(torch.uint8))
               for x, y in zip(a.buckets, b.buckets) for k in ("idx", "coeff", "cost", "mask")
               ) and torch.equal(a.rhs.cpu(), b.rhs.cpu())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_replay_on_card_is_bitwise(cuda, dtype):
    """Three cadences of mixed deltas replayed on the card: each result is
    bitwise a fresh upload of the host slabs, and the pre-replay instance is
    unchanged."""
    from repro_torch.service import apply_scatter_plan, device_put_instance

    base, ing = _cadence_ingestor(dtype)
    dev = device_put_instance(ing.instance(), cuda)
    rng = np.random.default_rng(3)
    for _ in range(3):
        rep = ing.apply(_cadence_delta(ing.to_edge_list(), rng))
        assert rep.in_place
        before = device_put_instance(dev, cuda)
        new = apply_scatter_plan(dev, rep.plan)
        assert _bitwise_instances(dev, before)
        assert _bitwise_instances(new, device_put_instance(ing.instance(), cuda))
        dev = new


@pytest.mark.parametrize("fused", [True, False])
def test_no_plan_survives_a_replay(cuda, fused):
    """A warm solve on the replayed instance equals, bit for bit, the same
    warm solve on a fresh upload of the host slabs: no kernel plan,
    objective or buffer of the cold solve is reused after the replay."""
    from repro_torch.service import apply_scatter_plan, compiled_solver, device_put_instance

    _, ing = _cadence_ingestor("float32")
    dev = device_put_instance(ing.instance(), cuda)
    cold = compiled_solver(MaximizerConfig(iters_per_stage=20), normalize=True,
                           fused_oracle=fused)(dev, torch.zeros(dev.dual_dim, device=cuda))
    rep = ing.apply(_cadence_delta(ing.to_edge_list(), np.random.default_rng(5)))
    warm = compiled_solver(MaximizerConfig(gammas=(0.1, 0.01), iters_per_stage=20),
                           normalize=True, fused_oracle=fused)
    replayed = warm(apply_scatter_plan(dev, rep.plan), cold.lam)
    fresh = warm(device_put_instance(ing.instance(), cuda), cold.lam)
    assert torch.equal(replayed.lam, fresh.lam)
    assert all(torch.equal(a, b) for a, b in zip(replayed.x_slabs, fresh.x_slabs))


def test_coo_pdhg_on_card_is_deterministic_and_matches_cpu(cuda):
    """Two COO PDHG solves on the card give equal bits, and the card's
    solve ends where the CPU's does (x within atol 1e-4, the same
    convergence)."""
    from repro_torch.core import PDHGConfig, from_edge_list, solve_pdhg

    inst = generate_matching_instance(MatchingInstanceSpec(
        num_sources=2000, num_destinations=40, avg_degree=6.0, seed=5))
    cfg = PDHGConfig(max_iters=600, tol=0.0)
    a = solve_pdhg(from_edge_list(inst, device=cuda), cfg)
    b = solve_pdhg(from_edge_list(inst, device=cuda), cfg)
    assert a.iters == b.iters == 600
    assert torch.equal(a.x, b.x) and torch.equal(a.y, b.y)
    small = generate_matching_instance(MatchingInstanceSpec(
        num_sources=60, num_destinations=10, avg_degree=4.0, seed=5))
    on_card = solve_pdhg(from_edge_list(small, device=cuda), PDHGConfig(max_iters=40_000))
    on_cpu = solve_pdhg(from_edge_list(small, device="cpu"), PDHGConfig(max_iters=40_000))
    assert bool(on_card.converged) and bool(on_cpu.converged)
    np.testing.assert_allclose(on_card.x.cpu().numpy(), on_cpu.x.numpy(), atol=1e-4)


# -- the tenant axis and the row lists (the service and serving paths) -------


def _stacked(B, shapes, m, J, dtype, device, seed=0):
    """B lanes of one shape, lane b's coefficients scaled by 4^(b-1) so the
    lanes' fixed-point shifts differ; returns (lanes, stacked buckets)."""
    import dataclasses

    lanes = []
    for b in range(B):
        bucket = []
        for k, (n, L) in enumerate(shapes):
            bb, _ = _bucket(seed + 100 * b + k, n, L, m, J, dtype, device, padded_rows=3)
            bucket.append(dataclasses.replace(
                bb, coeff=(bb.coeff.float() * 4.0 ** (b - 1)).to(bb.coeff.dtype)))
        lanes.append(bucket)
    st = [Bucket(idx=torch.stack([ln[k].idx for ln in lanes]),
                 coeff=torch.stack([ln[k].coeff for ln in lanes]),
                 cost=torch.stack([ln[k].cost for ln in lanes]),
                 mask=torch.stack([ln[k].mask for ln in lanes]), length=shapes[k][1])
          for k in range(len(shapes))]
    return lanes, st


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 2, 4, 7])
def test_batched_oracle_is_bitwise_each_lanes_solo_call(cuda, dtype, B):
    J = 64
    shapes = [(300 + 17 * L, L) for L in (1, 4, 8, 32)] + [(40, 64)]
    lanes, st = _stacked(B, shapes, 2, J, dtype, cuda, seed=B)
    lam = torch.from_numpy(np.random.default_rng(B).random((B, 2 * J)).astype(np.float32)).to(cuda)
    plan = kops.plan_batched_oracle(st, J)
    kdo.launches = kdo.finalize_launches = 0
    xs, ax, lin, sq = kops.fused_dual_oracle_batched_call(st, lam, 0.05, num_destinations=J,
                                                          plan=plan)
    assert (kdo.launches, kdo.finalize_launches) == (2, 1)  # one narrow, one wide
    for b in range(B):
        solo = kops.plan_slab_kernel("dual_oracle", lanes[b], J)
        assert solo.shift == plan.lane_shifts[b]
        sx, sax, slin, ssq = kdo.oracle_call(solo, lam[b].contiguous(), 0.05)
        assert all(torch.equal(x[b], y) for x, y in zip(xs, sx))
        assert torch.equal(ax[b], sax) and torch.equal(lin[b], slin) and torch.equal(sq[b], ssq)
    # and the plain version, lane by lane, within the kernel tolerances
    want = kref.dual_oracle_batched_ref(st, lam, 0.05, J)
    for x, w in zip(xs, want[0]):
        np.testing.assert_allclose(x.float().cpu(), w.float().cpu(), atol=X_ATOL[dtype])
    np.testing.assert_allclose(ax.cpu(), want[1].cpu(), atol=3e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [1, 8, 32, 64, 1024])
def test_row_list_is_bitwise_the_whole_slab_rows(cuda, dtype, L):
    J = 64
    n = 300 if L <= 64 else 20
    b, lam = _bucket(L, n, L, 1, J, dtype, cuda, padded_rows=3)
    rows = np.asarray([n - 1, 0, 5, 5, n - 1, 2], np.int64)
    plan = kops.plan_rows([b], J)
    kdp.launches = 0
    (x, mask, idx), (x1, _, _), (x0, _, _) = kops.fused_dual_primal_rows(
        [b], [(0, rows), (0, rows[:1]), (0, rows[:0])], lam, 0.1, num_destinations=J, plan=plan)
    assert kdp.launches == (1 if L <= 32 else 2)  # wide: one per request; empty: none
    assert x.dtype == torch.float32 and x0.shape == (0, L)
    full = kops.fused_dual_primal_call([b], lam, 0.1, num_destinations=J)[0]
    direct = kref.dual_primal_ref(b.idx, b.coeff.float(), b.cost.float(), b.mask.float(),
                                  lam, 0.1, J)
    r = torch.from_numpy(rows).to(cuda)
    assert torch.equal(x, direct[r]) and torch.equal(x.to(full.dtype), full[r])
    assert torch.equal(x1, direct[r[:1]])
    assert torch.equal(mask, b.mask.float()[r]) and torch.equal(idx, b.idx[r])


@pytest.mark.parametrize("fused", [True, False])
def test_batched_pool_lanes_match_solo_on_card(cuda, fused):
    from repro_torch.instances import DeltaIngestor, InstanceDelta
    from repro_torch.service import (
        BatchedSolvePool, compiled_solver, device_put_instance, to_solve_result,
    )

    spec = MatchingInstanceSpec(num_sources=3000, num_destinations=50, avg_degree=6.0, seed=3)
    edges = generate_matching_instance(spec)
    rng = np.random.default_rng(1)
    insts = []
    for _ in range(3):
        ing = DeltaIngestor(edges, row_headroom=4)
        pick = rng.permutation(edges.nnz)[:300]
        ing.apply(InstanceDelta(update_src=edges.src[pick], update_dst=edges.dst[pick],
                                update_values=edges.values[pick] * rng.uniform(0.9, 1.1, 300)))
        insts.append(device_put_instance(ing.instance(), cuda))
    cfg = MaximizerConfig(iters_per_stage=40, gammas=(10.0, 1.0, 0.1))
    kdo.launches = kdo.finalize_launches = 0
    batch = BatchedSolvePool(cfg, normalize=True, fused_oracle=fused).solve(insts)
    if fused:  # one oracle call a batched iteration, plus the final one
        calls = len(cfg.gammas) * cfg.iters_per_stage + 1
        assert kdo.launches == kdo.finalize_launches == calls
    for inst, r in zip(insts, batch):
        s = to_solve_result(compiled_solver(cfg, True, fused)(
            inst, torch.zeros(inst.dual_dim, device=cuda)))
        rel = abs(float(r.g) - float(s.g)) / max(abs(float(s.g)), 1e-9)
        assert rel < 1e-3
        np.testing.assert_allclose(r.lam.cpu(), s.lam.cpu(), atol=5e-2)


def test_served_batch_is_bitwise_direct_on_card(cuda):
    from repro_torch.core import MaximizerConfig as Cfg
    from repro_torch.service import Scheduler, ServiceConfig
    from repro_torch.serving import DualStore, direct_allocations

    spec = MatchingInstanceSpec(num_sources=3000, num_destinations=50, avg_degree=6.0, seed=4)
    store = DualStore(history=4)
    sched = Scheduler(ServiceConfig(cold=Cfg(iters_per_stage=40), row_headroom=4),
                      dual_store=store, device=cuda)
    sched.add_tenant("t0", generate_matching_instance(spec))
    sched.run_cadence()
    snap = store.snapshot("t0")
    users = np.random.default_rng(0).choice(np.flatnonzero(snap.deg > 0), size=128)
    kdp.launches = 0
    stream = torch.cuda.Stream(cuda)
    with torch.cuda.stream(stream):  # a query on its own stream, as serve's threads
        result = store.query("t0", users)
    wide = sum(snap.instance.buckets[ba.bucket].cost.shape[-1] > 32 for ba in result.slabs)
    assert kdp.launches == 1 + wide
    xs = [x.cpu().numpy() for x in direct_allocations(snap)]
    for ba in result.slabs:
        assert np.array_equal(ba.x, xs[ba.bucket][ba.rows])


def _on_cpu(res):
    """A `SolveResult` with every tensor copied to the host."""
    cpu = lambda v: v.cpu() if isinstance(v, torch.Tensor) else v  # noqa: E731
    return res._replace(lam=res.lam.cpu(), x_slabs=tuple(x.cpu() for x in res.x_slabs),
                        g=res.g.cpu(), sigma_sq=res.sigma_sq.cpu(),
                        stats=tuple(type(s)(*map(cpu, s)) for s in res.stats))


def test_session_meters_drift_on_card(cuda):
    """Two warm cadences of a card scheduler, each delta with one insert and
    one delete: a CPU session that ingests the same deltas and absorbs the
    same solves (copied to the host) reports the same drift, relative drift
    and bound at rtol 1e-9, while the card session keeps its previous primal
    on the card; its checkpoint, restored on the card, meters the next
    cadence's drift as the original does."""
    from repro_torch.core import MaximizerConfig as Cfg
    from repro_torch.service import Scheduler, ServiceConfig, SolveSession

    spec = MatchingInstanceSpec(num_sources=3000, num_destinations=50, avg_degree=6.0, seed=8)
    base = generate_matching_instance(spec)
    config = ServiceConfig(cold=Cfg(iters_per_stage=40), warm_gammas=(0.1, 0.01), row_headroom=4)
    sched = Scheduler(config, device=cuda)
    card = sched.add_tenant("t0", base)
    host = SolveSession("t0", base, config, device="cpu")
    absorbed = []
    card_absorb = card.absorb

    def recording_absorb(res, **kw):
        absorbed.append((res, kw))
        return card_absorb(res, **kw)

    card.absorb = recording_absorb
    rng = np.random.default_rng(2)
    deltas = [_cadence_delta(base, rng, n_upd=100, n_ins=1, n_del=1)]
    for i in range(3):  # the cold solve, then two warm cadences
        if i:
            host.ingest(deltas[-1])
            report = sched.run_cadence({"t0": deltas[-1]}).reports["t0"]
            deltas.append(_cadence_delta(card.ingestor.to_edge_list(), rng, n_upd=100,
                                         n_ins=1, n_del=1))
        else:
            report = sched.run_cadence().reports["t0"]
        res, kw = absorbed[-1]
        want = host.absorb(_on_cpu(res), **{**kw, "unpack": None, "serving": None})
        for k in ("drift_l2", "drift_rel", "drift_bound"):
            if i:
                np.testing.assert_allclose(report[k], want[k], rtol=1e-9, err_msg=k)
            else:
                assert report[k] is None and want[k] is None
        assert all(t.device.type == "cuda" for t in card.prev_primal)
        assert isinstance(host.prev_primal[0], np.ndarray)
        assert np.array_equal(card.prev_primal[0].cpu().numpy(), host.prev_primal[0])
    arrays, meta = card.state_dict()
    assert isinstance(arrays["primal_keys"], np.ndarray)
    restored = SolveSession.from_state(config, arrays, meta, device=cuda)
    assert all(t.device.type == "cuda" for t in restored.prev_primal)
    card.ingest(deltas[-1])
    restored.ingest(deltas[-1])
    res, report = card.solve()
    again = restored.absorb(res, cold=False, cold_reason=None, batched=False,
                            dc_norm=report["dc_norm"])
    assert report["drift_rel"] is not None
    np.testing.assert_allclose(again["drift_rel"], report["drift_rel"], rtol=1e-9)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 2, 4, 7])
def test_batched_oracle_gamma_per_lane_is_bitwise_solo(cuda, dtype, B):
    """Kernel 1 with a 1/gamma per lane: lane b bitwise its solo call at
    gamma_b, still one narrow launch (one wide) and one finalize."""
    J = 64
    shapes = [(300 + 17 * L, L) for L in (1, 4, 8, 32)] + [(40, 64)]
    lanes, st = _stacked(B, shapes, 2, J, dtype, cuda, seed=10 + B)
    lam = torch.from_numpy(np.random.default_rng(B).random((B, 2 * J)).astype(np.float32)).to(cuda)
    gammas = torch.tensor([0.013 * 3.7 ** b for b in range(B)], dtype=torch.float32)
    plan = kops.plan_batched_oracle(st, J)
    for g in (gammas, gammas.to(cuda)):  # the table from the host or the card
        kdo.launches = kdo.finalize_launches = 0
        xs, ax, lin, sq = kops.fused_dual_oracle_batched_call(st, lam, g, num_destinations=J,
                                                              plan=plan)
        assert (kdo.launches, kdo.finalize_launches) == (2, 1)
        for b in range(B):
            solo = kops.plan_slab_kernel("dual_oracle", lanes[b], J)
            sx, sax, slin, ssq = kdo.oracle_call(solo, lam[b].contiguous(), float(gammas[b]))
            assert all(torch.equal(x[b], y) for x, y in zip(xs, sx)), b
            assert torch.equal(ax[b], sax) and torch.equal(lin[b], slin)
            assert torch.equal(sq[b], ssq)
    want = kref.dual_oracle_batched_ref(st, lam, gammas, J)
    for x, w in zip(xs, want[0]):
        np.testing.assert_allclose(x.float().cpu(), w.float().cpu(), atol=X_ATOL[dtype])


def test_batched_pdhg_step_is_b_solo_steps(cuda):
    """One batched prox step (tau per lane) equal to B solo steps: x+ and
    A x+ bitwise, one oracle launch and one finalize for all lanes."""
    J, B = 64, 4
    shapes = [(300 + 17 * L, L) for L in (1, 4, 8, 16, 32)]
    lanes, st = _stacked(B, shapes, 1, J, "float32", cuda, seed=5)
    rng = np.random.default_rng(2)
    taus = [0.37, 0.05, 1.3, 0.9]
    xs = [(torch.from_numpy(rng.random(b.cost.shape).astype(np.float32)).to(cuda) * b.mask)
          for b in st]
    y = torch.from_numpy(rng.random((B, J)).astype(np.float32)).to(cuda)
    step = kops.plan_pdhg_step_batched(st, [b.cost for b in st], taus, num_destinations=J)
    kdo.launches = kdo.finalize_launches = 0
    got_x, got_ax = kops.fused_pdhg_step_batched_call(step, xs, y)
    assert (kdo.launches, kdo.finalize_launches) == (1, 1)
    for b, tau in enumerate(taus):
        solo = kops.plan_pdhg_step(lanes[b], [bk.cost for bk in lanes[b]], num_destinations=J)
        sx, sax = kops.fused_pdhg_step_call(solo, [x[b].contiguous() for x in xs],
                                            y[b].contiguous(), tau)
        assert all(torch.equal(x[b], s) for x, s in zip(got_x, sx)), b
        assert torch.equal(got_ax[b], sax), b


def test_vectorised_unfused_oracle_lanes_are_solo_on_card(cuda):
    """The unfused batched oracle (one pass over the [B, ...] slabs) and its
    power iteration: every lane bitwise its solo call on the card, rows
    wider than 32 included."""
    from repro_torch.core.batched import BatchedObjective, lane_instance, stack_lanes
    from repro_torch.instances import BucketedInstance

    J, B, m = 64, 3, 2
    shapes = [(300 + 17 * L, L) for L in (1, 8, 32)] + [(40, 64), (12, 512)]
    lanes, st = _stacked(B, shapes, m, J, "float32", cuda, seed=7)
    rhs = torch.rand(B, m * J, generator=torch.Generator().manual_seed(0)).to(cuda) + 1.0
    stacked = BucketedInstance(buckets=tuple(st), rhs=rhs,
                               num_sources=sum(n for n, _ in shapes), num_destinations=J,
                               num_families=m)
    obj = BatchedObjective(stacked)
    lam = torch.from_numpy(np.random.default_rng(3).random((B, m * J)).astype(np.float32)).to(cuda)
    ev = obj.calculate(lam, 0.05)
    sig = obj.power_iteration(0, iters=10)
    for b in range(B):
        solo = MatchingObjective(lane_instance(stacked, b))
        e = solo.calculate(lam[b].contiguous(), 0.05)
        for field in ("g", "grad", "ax", "primal_linear", "primal_ridge"):
            assert torch.equal(getattr(ev, field)[b], torch.as_tensor(getattr(e, field))), field
        assert all(torch.equal(x[b], s) for x, s in zip(ev.x_slabs, e.x_slabs))
        assert torch.equal(sig[b], solo.power_iteration(0, iters=10))
    assert stack_lanes([lane_instance(stacked, b) for b in range(B)]).rhs.shape == rhs.shape


@pytest.mark.parametrize("fused", [True, False])
def test_batched_pdhg_solve_lanes_are_solo_on_card(cuda, fused):
    """The batched PDHG solve on the card: one oracle launch and finalize
    per batched iteration (fused), and every lane its solo solve."""
    from repro_torch.core.batched import lane_instance, stack_lanes
    from repro_torch.engines.pdhg import pdhg_raw_solve_batched

    spec = MatchingInstanceSpec(num_sources=3000, num_destinations=50, avg_degree=6.0, seed=3)
    base = bucketize(generate_matching_instance(spec), device=cuda)
    import dataclasses

    insts = [dataclasses.replace(base, buckets=tuple(
        dataclasses.replace(bk, coeff=bk.coeff * (1.0 + 0.3 * t)) for bk in base.buckets))
        for t in range(3)]
    stacked = stack_lanes(insts)
    cfg = MaximizerConfig(gammas=(0.01,), iters_per_stage=200, tol_grad=1e-3, check_every=25)
    pcfg = PDHGEngineConfig(dense="off")
    lam0 = torch.zeros(3, stacked.dual_dim, device=cuda)
    kdo.launches = kdo.finalize_launches = 0
    raw = pdhg_raw_solve_batched(stacked, lam0, cfg, True, fused, pcfg=pcfg)
    if fused:
        assert kdo.launches == kdo.finalize_launches == int(raw.iters.max())
    for b in range(3):
        s = pdhg_raw_solve(lane_instance(stacked, b), lam0[b], cfg, True, fused, pcfg=pcfg)
        assert int(raw.iters[b, 0]) == int(s.iters[0]) and int(raw.restarts[b]) == int(s.restarts)
        assert torch.equal(raw.lam[b], s.lam), b


# ---------------------------------------------------------------------------
# The LM substrate (no kernel of the port: matmuls, einsums and PyTorch ops)
# ---------------------------------------------------------------------------


def _lm_batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    if cfg.encdec:
        return {"embeds": torch.from_numpy(rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)),
                "tokens": toks[:, :1]}
    if cfg.frontend == "patch":
        P = cfg.frontend_len
        return {"embeds": torch.from_numpy(rng.normal(size=(B, P, cfg.d_model)).astype(np.float32)),
                "tokens": toks[:, : S - P]}
    return {"tokens": toks}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_reduced_arch_on_card_matches_cpu(cuda, arch):
    """Every reduced arch in fp32 compute: prefill, then two decode steps from
    its cache, on the card against the same on the CPU (rtol 1e-4 + atol
    1e-5, logits and caches)."""
    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _lm_batch(cfg, 2, 16, seed=1)
    out = {}
    with torch.no_grad():
        for dev in ("cpu", cuda):
            p, b = _to(params, dev), _to(batch, dev)
            logits, cache = model.prefill(p, b, max_seq=20)
            steps = [logits]
            pos = 1 if cfg.encdec else 16
            for t in range(2):
                tok = torch.argmax(steps[0][:, -1], -1)[:, None]  # the CPU's first token
                logits, cache = model.decode_step(p, tok.to(dev), pos + t, cache)
                steps.append(logits)
            out[str(dev)] = [s.cpu() for s in steps], {k: v.cpu() for k, v in cache.items()}
    (lc, cc), (lg, cg) = out["cpu"], out[str(cuda)]
    for a, b in zip(lg, lc):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    for k in cc:
        torch.testing.assert_close(cg[k], cc[k], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("router", ["topk", "lp"])
def test_lm_bf16_moe_decode_step_is_bitwise_repeatable(cuda, router):
    """A bf16 MoE decode step (MLA, 8 experts, shared experts, the fixed-
    order combine) gives the same bits in two runs from the same cache."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.models import Model

    cfg = get_reduced_config("deepseek-v2-236b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, router=router))
    model = Model(cfg)
    params = model._lowp(model.init(torch.Generator(device=cuda).manual_seed(0)))
    with torch.no_grad():
        _, cache = model.prefill(params, _to(_lm_batch(cfg, 4, 16, seed=2), cuda), max_seq=24)
        tok = torch.arange(4, device=cuda)[:, None] * 7
        runs = []
        for _ in range(2):
            c = {k: v.clone() for k, v in cache.items()}
            logits, c = model.decode_step(params, tok, 16, c)
            runs.append((logits, c))
    assert torch.equal(runs[0][0], runs[1][0])
    for k in cache:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_train_loss_and_grads_on_card_match_cpu(cuda, arch):
    """`value_and_grad(Model.loss)` of every reduced arch in fp32 compute on
    the card against the CPU: loss and every gradient leaf at rtol 1e-4 +
    atol 1e-5."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.training import value_and_grad
    from repro_torch.training.loop import batch_to_device
    from repro_torch.training.optimizer import tree_leaves

    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    data = SyntheticLMData(cfg, batch=2, seq=16, seed=0)(0)
    loss_c, grads_c = value_and_grad(model, params, batch_to_device(data, "cpu"))
    loss_g, grads_g = value_and_grad(model, _to(params, cuda), batch_to_device(data, cuda))
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-4, atol=1e-5)
    for a, b in zip(tree_leaves(grads_g), tree_leaves(grads_c)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-236b", "zamba2-2.7b"])
def test_lm_train_in_place_adamw_is_bitwise_functional(cuda, arch):
    """Three bf16 train steps of a reduced config: the donating step (the
    in-place AdamW) and the functional step end on the same bits."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.training import AdamWConfig, init_train_state, make_train_step
    from repro_torch.training.loop import batch_to_device
    from repro_torch.training.optimizer import tree_leaves

    model = Model(get_reduced_config(arch))
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    data = SyntheticLMData(model.cfg, batch=4, seq=32, seed=0)
    states = [init_train_state(model, device=cuda) for _ in range(2)]
    steps = [make_train_step(model, opt)[0], make_train_step(model, opt, donate=False)[0]]
    for k in range(3):
        batch = batch_to_device(data(k), cuda)
        (s0, m0), (s1, m1) = [step(st, batch) for step, st in zip(steps, states)]
        states = [s0, s1]
        assert torch.equal(m0["loss"], m1["loss"]) and torch.isfinite(m0["loss"])
    for a, b in zip(tree_leaves([s0.params, s0.opt.m, s0.opt.v]),
                    tree_leaves([s1.params, s1.opt.m, s1.opt.v])):
        assert torch.equal(a, b)


def test_lm_train_loop_resumes_bitwise_on_card(cuda, tmp_path):
    """The loop on the card, reduced qwen3-8b in bf16: 8 steps uninterrupted
    and again from the step-4 checkpoint alone, the same final bits."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import SyntheticLMData
    from repro_torch.training import AdamWConfig, TrainLoopConfig, train_loop

    cfg = get_reduced_config("qwen3-8b")
    run = lambda d: train_loop(Model(cfg), SyntheticLMData(cfg, 8, 32), AdamWConfig(),
                               TrainLoopConfig(total_steps=8, save_every=4), str(d),
                               device=cuda)
    run(tmp_path / "a")
    shutil.copytree(tmp_path / "a" / "step_00000004", tmp_path / "b" / "step_00000004")
    run(tmp_path / "b")
    full, _ = CheckpointManager(str(tmp_path / "a")).restore_flat(8)
    resumed, _ = CheckpointManager(str(tmp_path / "b")).restore_flat(8)
    assert sorted(full) == sorted(resumed)
    for k in full:
        np.testing.assert_array_equal(resumed[k], full[k], err_msg=k)


@pytest.fixture
def card_mesh(cuda):
    """A ("data", "model") mesh of shape (1, 1) over a one-rank NCCL group."""
    import socket

    from repro_torch.launch import dist as launch_dist
    from repro_torch.launch.mesh import make_mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    launch_dist.setup("cuda:0", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), "cuda")
    finally:
        launch_dist.teardown()


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-236b", "mamba2-1.3b"])
def test_lm_mesh_train_step_on_card_is_the_single_device_step(card_mesh, arch):
    """4 bf16 steps of the reduced arch over the (1, 1) mesh (DTensor over
    NCCL): every loss and grad norm bitwise the single-device step's.  The
    MoE layer's routing leaves DTensor (`models.moe._apply_moe_on_mesh`),
    so the bf16 grad of its input sums its three uses (router, dispatch,
    shared experts) in another order: held at 1e-3 relative there."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.mesh import default_profile
    from repro_torch.training import AdamWConfig, init_train_state, make_train_step
    from repro_torch.training.loop import batch_to_device
    from repro_torch.training.train_step import init_sharded_state

    cfg = get_reduced_config(arch)
    model, opt = Model(cfg), AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    data = SyntheticLMData(cfg, batch=4, seq=32, seed=0)
    gen = lambda: torch.Generator(device="cuda").manual_seed(0)
    runs = []
    for mesh in (None, card_mesh):
        if mesh is None:
            state, (step, _, _) = (init_train_state(model, gen(), device="cuda"),
                                   make_train_step(model, opt))
        else:
            profile = default_profile(cfg, mesh)
            state = init_sharded_state(model, mesh, profile, gen())
            step, _, _ = make_train_step(model, opt, mesh, profile)
        out = []
        for k in range(4):
            state, m = step(state, batch_to_device(data(k), "cuda"))
            out.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append(out)
    if cfg.moe is None:
        assert runs[0] == runs[1]
    else:
        np.testing.assert_allclose(runs[1], runs[0], rtol=1e-3, atol=0)


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-1.3b", "zamba2-2.7b"])
def test_lm_mesh_serve_fns_on_card_give_the_single_device_tokens(card_mesh, arch):
    """The reduced arch in bf16: a prefill of 4 prompts and 8 greedy decode
    steps through `make_serve_fns` over the (1, 1) mesh, the tokens and
    logits bitwise `Model.prefill` / `decode_step`'s."""
    from repro_torch.launch.mesh import default_profile
    from repro_torch.serving.lm_demo import make_serve_fns

    cfg = get_reduced_config(arch)
    model = Model(cfg)
    params = model._lowp(model.init(torch.Generator(device="cuda").manual_seed(0)))
    toks = torch.randint(0, cfg.vocab_size, (4, 16), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32).cuda()
    runs = []
    for fns, full in (((model.prefill, model.decode_step), lambda x: x),
                      (make_serve_fns(model, card_mesh, default_profile(cfg, card_mesh)),
                       lambda x: x.full_tensor())):
        logits, cache = fns[0](params, {"tokens": toks}, 24)
        out = []
        for t in range(8):
            nxt = torch.argmax(full(logits)[:, -1], -1).to(torch.int32)[:, None]
            logits, cache = fns[1](params, nxt, 16 + t, cache)
            out.append(full(logits).float().cpu())
        runs.append(torch.stack(out))
    assert torch.equal(runs[0], runs[1])
