"""The oracle's and the primal step's kernel plan, and the whole-call entry points, on the CPU.

What the plan computes without a card: the fixed-point scale of A x
(`fixed_point_shift`) and its overflow bound, the warp tasks of the one
narrow launch (every slot of every bucket exactly once), and the
shared-memory layouts, which must take every shape the per-bucket launch
plan of the previous design took.  The test-only fixed-point sum
`ref.fixed_point_hist` is held against the plain fp32 A x (atol 3e-5 + rtol
1e-5, tests/test_dual_oracle.py's tolerance), and `calculate` with
`fused_oracle=True` or `fused_kernel=True` on the CPU is bitwise what the
per-bucket loop of the previous design gave.  No JAX: none of this has a
reference counterpart.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import MatchingObjective
from repro_torch.core.objective import normalize_rows
from repro_torch.instances import (
    MatchingInstanceSpec, bucketize, generate_matching_instance,
)
from repro_torch.instances.buckets import Bucket, convert_bucket
from repro_torch.kernels import dual_oracle as kdo
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


def _bucket(rng, n, L, m, J, dtype="float32", hot=None):
    """Random slab with padded rows; `hot` sends most slots to bin 0."""
    mask = (rng.random((n, L)) < 0.8).astype(np.float32)
    mask[:3] = 0.0
    idx = rng.integers(0, J, size=(n, L))
    if hot is not None:
        idx = np.where(rng.random((n, L)) < hot, 0, idx)
    idx = (idx * mask).astype(np.int32)
    coeff = (rng.random((m, n, L)) * mask[None]).astype(np.float32)
    cost = (rng.normal(size=(n, L)) * mask).astype(np.float32)
    b = Bucket(idx=torch.from_numpy(idx), coeff=torch.from_numpy(coeff),
               cost=torch.from_numpy(cost), mask=torch.from_numpy(mask), length=L)
    return convert_bucket(b, dtype)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_fixed_point_shift_bounds_a_skewed_instance(dtype):
    rng = np.random.default_rng(0)
    J = 50
    buckets = [_bucket(rng, 400, L, 2, J, dtype, hot=0.6) for L in (4, 16, 64)]
    for b in buckets:  # one large coefficient in family 1
        b.coeff[1, 7, 0] = b.coeff[1].max() if dtype == "int8" else 37.5
    radius = 2.5
    shift = kdo.fixed_point_shift(buckets, J, radius)
    counts = np.zeros(J, np.int64)
    biggest = 0.0
    for b in buckets:
        live = b.mask.float().numpy() != 0
        counts += np.bincount(b.idx.numpy()[live], minlength=J)
        c = b.coeff.float().abs().amax(dim=(1, 2))
        if b.coeff_scale is not None:
            c = c * b.coeff_scale.reshape(-1)
        biggest = max(biggest, float(c.max()))
    bound = biggest * radius * counts.max()
    assert counts.argmax() == 0 and counts.max() > 3 * np.sort(counts)[-2]  # skewed
    assert bound * 2.0 ** shift <= 2.0 ** kdo.FIXED_POINT_BITS
    assert bound * 2.0 ** (shift + 1) > 2.0 ** kdo.FIXED_POINT_BITS  # the largest
    # the worst case of the bound itself, every live slot of the hot bin at
    # max|coeff| * radius, fits an int64 after rounding
    worst = round(float(np.float32(biggest) * np.float32(radius)) * 2.0 ** shift)
    assert worst * int(counts.max()) < 2 ** 63
    zero = [_bucket(rng, 10, 8, 1, J)]
    zero[0].coeff.zero_()
    assert kdo.fixed_point_shift(zero, J, 1.0) == kdo.MAX_SHIFT


@pytest.mark.parametrize("seed", range(4))
def test_narrow_tasks_cover_every_slot_of_every_bucket_once(seed):
    """The kernel's walk (walk_narrow/narrow_task) over the plan's task0,
    replayed in numpy: each slot of each slab is computed exactly once."""
    rng = np.random.default_rng(seed)
    widths = sorted(rng.choice([1, 2, 4, 8, 16, 32], size=rng.integers(1, 7), replace=False))
    shapes = [(int(rng.integers(1, 3000)), int(L)) for L in widths]
    task0, total = kdo.narrow_tasks(shapes)
    seen = [np.zeros(n * L, np.int64) for n, L in shapes]
    lanes = np.arange(32)
    for t in range(total):
        i = 0
        while i + 1 < len(shapes) and t >= task0[i + 1]:
            i += 1
        g0 = (t - task0[i]) * kdo.UNROLL
        n, L = shapes[i]
        for u in range(kdo.UNROLL):
            s = (g0 + u) * 32 + lanes
            np.add.at(seen[i], s[s < n * L], 1)
    assert all((c == 1).all() for c in seen)


def _parent_accepts(L, m, J):
    """The previous design's plan_launch acceptance: an fp32 [m, J]
    histogram per block (L <= 32, beside a tile's staging area) or per warp
    (wider rows, with two fp32 rows), lam staged only when it fits."""
    mJ, red = m * J, 16

    def floats(warps, lam):
        tail = mJ + (1 + m) * warps * 4 * 32 + warps if L <= 32 else warps * mJ + 2 * warps * L
        return (mJ if lam else 0) + red + tail

    if L <= 32:
        lam = 4 * floats(8, True) <= kdo.SMEM_PER_BLOCK
        return 4 * floats(8, lam) <= kdo.SMEM_PER_BLOCK
    lam = 4 * floats(1, True) <= kdo.SMEM_PER_BLOCK
    return 4 * floats(1, lam) <= kdo.SMEM_PER_BLOCK


def test_capacity_rule_accepts_every_shape_the_parent_accepted():
    accepted = refused_before = 0
    for L in (1 << k for k in range(14)):
        for m in range(1, 9):
            for J in (1, 64, 1000, 7000, 10_000, 14_500, 20_000, 29_000, 29_100, 41_000,
                      41_700, 56_000, 56_100, 100_000):
                for layout in (kdo.oracle_layout(L, m, J), kdo.primal_layout(L, m, J)):
                    assert 1 <= layout.warps and layout.smem_bytes <= kdo.SMEM_PER_BLOCK
                    if L <= 32:
                        assert layout.warps == kdo.narrow_threads(kdo.family_template(m)) // 32
                accepted += _parent_accepts(L, m, J)
                refused_before += not _parent_accepts(L, m, J)
    assert accepted > 100 and refused_before > 100  # both sides of the old gate swept
    # the boundary of the shared-memory histogram, on both sides
    assert kdo.oracle_layout(8, 1, 29_000).hist_mode == kdo.HIST_SHARED
    assert kdo.oracle_layout(8, 1, 29_100).hist_mode == kdo.HIST_GLOBAL
    assert kdo.oracle_layout(8192, 1, 20_000).hist_mode == kdo.HIST_SHARED
    assert kdo.oracle_layout(8192, 1, 21_000).hist_mode == kdo.HIST_GLOBAL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("inequality", [True, False])
def test_fixed_point_hist_matches_the_plain_sum(dtype, inequality):
    rng = np.random.default_rng(5)
    m, J = 3, 40
    buckets = [_bucket(rng, 200, L, m, J, dtype) for L in (1, 8, 32, 128)]
    lam = torch.from_numpy(rng.random(m * J).astype(np.float32))
    shift = kdo.fixed_point_shift(buckets, J, 1.0)
    for gamma in (0.05, 1.0, 50.0):
        fixed = kref.fixed_point_hist(buckets, lam, gamma, J, shift, inequality=inequality)
        _, ax, _, _ = kref.dual_oracle_call_ref(buckets, lam, gamma, J,
                                                inequality=inequality)
        assert fixed.dtype == torch.float32 and fixed.shape == (m * J,)
        np.testing.assert_allclose(fixed.numpy(), ax.numpy(), atol=3e-5, rtol=1e-5)


def _parent_calculate_fused(obj, lam, gamma):
    """The previous design's `_calculate_fused`: one per-bucket call each."""
    inst, proj = obj.instance, obj.projection
    ax2 = torch.zeros((inst.num_families, inst.num_destinations), dtype=torch.float32)
    lin = sq = 0.0
    x_slabs = []
    for b in inst.buckets:
        x, hist, b_lin, b_sq = kops.fused_dual_oracle(
            b.idx, b.coeff, b.cost, b.mask, lam, gamma,
            num_destinations=inst.num_destinations, radius=proj.radius,
            inequality=proj.inequality, coeff_scale=b.coeff_scale, cost_scale=b.cost_scale,
        )
        x_slabs.append(x)
        ax2 = ax2 + hist
        lin = lin + b_lin
        sq = sq + b_sq
    return obj._finish_eval(lam, ax2.reshape(-1), lin, 0.5 * gamma * sq, tuple(x_slabs))


class _ParentPrimal(MatchingObjective):
    """The previous design's fused primal step: one per-bucket call each."""

    def primal_candidate(self, lam, gamma):
        inst, proj = self.instance, self.projection
        return tuple(
            kops.fused_dual_primal(
                b.idx, b.coeff, b.cost, b.mask, lam, gamma,
                num_destinations=inst.num_destinations, radius=proj.radius,
                inequality=proj.inequality, coeff_scale=b.coeff_scale,
                cost_scale=b.cost_scale,
            )
            for b in inst.buckets
        )


@pytest.fixture(scope="module", params=["float32", "bfloat16", "int8"])
def cpu_instance(request):
    spec = MatchingInstanceSpec(num_sources=500, num_destinations=30, avg_degree=6.0,
                                num_families=2, seed=9)
    packed = bucketize(generate_matching_instance(spec), dtype=request.param, device="cpu")
    return normalize_rows(packed)[0]


@pytest.mark.parametrize("include_rhs", [True, False])
def test_fused_calculate_on_cpu_is_bitwise_the_per_bucket_loop(cpu_instance, include_rhs):
    lam = torch.from_numpy(np.random.default_rng(1).random(cpu_instance.dual_dim)
                           .astype(np.float32))
    for gamma in (0.05, 1.0, 20.0):
        fused = MatchingObjective(cpu_instance, include_rhs=include_rhs, fused_oracle=True)
        assert fused.kernel_plan("dual_oracle") is None  # the CPU takes no plan
        got, want = fused.calculate(lam, gamma), _parent_calculate_fused(fused, lam, gamma)
        kern = MatchingObjective(cpu_instance, include_rhs=include_rhs, fused_kernel=True)
        parent = _ParentPrimal(cpu_instance, include_rhs=include_rhs, fused_kernel=True)
        for a, b in ((got, want), (kern.calculate(lam, gamma), parent.calculate(lam, gamma))):
            for name in ("g", "grad", "primal_linear", "primal_ridge", "ax"):
                assert torch.equal(getattr(a, name), getattr(b, name)), (name, gamma)
            assert all(torch.equal(x, y) for x, y in zip(a.x_slabs, b.x_slabs))


def test_whole_calls_route_widths_the_kernels_do_not_take():
    rng = np.random.default_rng(3)
    J = 20
    buckets = [_bucket(rng, 30, 8, 1, J), _bucket(rng, 11, 12, 1, J), _bucket(rng, 9, 64, 1, J)]
    lam = torch.from_numpy(rng.random(J).astype(np.float32))
    before = kops.width_routed
    xs, ax, lin, sq = kops.fused_dual_oracle_call(buckets, lam, 0.4, num_destinations=J)
    primal = kops.fused_dual_primal_call(buckets, lam, 0.4, num_destinations=J)
    assert kops.width_routed == before + 2  # the width-12 bucket, once per call
    want = kref.dual_oracle_call_ref(buckets, lam, 0.4, J)
    assert all(torch.equal(a, b) for a, b in zip(xs, want[0]))
    assert all(torch.equal(a, b) for a, b in zip(primal, want[0]))
    assert torch.equal(ax, want[1]) and torch.equal(lin, want[2]) and torch.equal(sq, want[3])
    assert math.isfinite(float(sq))
    with pytest.raises(ValueError, match="device"):
        kops.fused_dual_oracle_call([kdo.Slab(*(t.to("meta") for t in (
            buckets[0].idx, buckets[0].coeff, buckets[0].cost, buckets[0].mask)))],
            lam.to("meta"), 0.4, num_destinations=J)
