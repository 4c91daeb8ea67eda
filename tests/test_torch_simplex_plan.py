"""The simplex kernel's plan and its whole-call entry point, on the CPU.

What the plan computes without a card: the launches of one call (every
bucket of width <= 32 in one launch, each wider bucket alone) and the warp
tasks of the narrow launch, which must cover every slot of every bucket
exactly once in either row form (a row in one thread's registers, or a
segment of a warp).  `ops.fused_project_simplex_call` on the CPU is bitwise
the per-bucket `simplex_ref` loop, routes and counts the widths the kernel
does not take, and matches the JAX package's `fused_project_simplex` (its
Pallas kernel in interpret mode) at tests/test_kernels.py's tolerances
(atol 3e-5, 2e-2 at bf16).  The unfused oracle with
`UnitSimplexProjection(use_kernel=True)` is bitwise what the per-bucket
projection loop of the previous design gave.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import MatchingObjective, UnitSimplexProjection
from repro_torch.core.objective import gather_at_lam, inv_gamma, normalize_rows
from repro_torch.instances import (
    MatchingInstanceSpec, bucketize, generate_matching_instance,
)
from repro_torch.kernels import dual_oracle as kdo
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import simplex_proj as ksp

X_ATOL = {"float32": 3e-5, "bfloat16": 2e-2}


def _walk(shapes):
    """The narrow kernel's walk (simplex_narrow: register_task or
    segment_task) over the plan's task0, replayed in numpy: how often each
    slot of each slab is computed."""
    task0, total = ksp.narrow_tasks(shapes)
    seen = [np.zeros(n * L, np.int64) for n, L in shapes]
    lanes = np.arange(32)
    for t in range(total):
        i = 0
        while i + 1 < len(shapes) and t >= task0[i + 1]:
            i += 1
        n, L = shapes[i]
        task = t - task0[i]
        if L <= ksp.REGISTER_MAX_WIDTH:  # 32 rows, one a thread
            rows = task * 32 + lanes
            rows = rows[rows < n]
            np.add.at(seen[i], (rows[:, None] * L + np.arange(L)).reshape(-1), 1)
        else:  # UNROLL groups of 32 slots
            for u in range(kdo.UNROLL):
                s = (task * kdo.UNROLL + u) * 32 + lanes
                np.add.at(seen[i], s[s < n * L], 1)
    return seen


@pytest.mark.parametrize("seed", range(4))
def test_narrow_tasks_cover_every_slot_of_every_bucket_once(seed):
    rng = np.random.default_rng(seed)
    widths = rng.choice([1, 2, 4, 8, 16, 32], size=rng.integers(1, 9))
    shapes = [(int(rng.integers(0, 700)) if k % 3 else 0, int(L))
              for k, L in enumerate(widths)]  # every third bucket empty
    groups = ksp.launch_groups(shapes)
    assert [wide for wide, _ in groups] == [False] * len(groups)
    ids = [i for _, g in groups for i in g]
    assert ids == [i for i, (n, _) in enumerate(shapes) if n > 0]
    for _, g in groups:
        sub = [shapes[i] for i in g]
        assert all((c == 1).all() for c in _walk(sub))


def test_narrow_task_counts_and_stages_by_row_form():
    """A register-form task is 32 rows, a segment-form task UNROLL groups of
    32 slots; a register row wider than 16 bytes takes a stage of v and
    mask, each [32 rows][row + 16 bytes]."""
    assert ksp.REGISTER_MAX_WIDTH == 16
    for L in (1, 2, 4, 8, 16, 32):
        for n in (1, 31, 32, 33, 1000):
            want = (-(-n // 32) if L <= ksp.REGISTER_MAX_WIDTH
                    else -(-(-(-n * L // 32)) // kdo.UNROLL))
            assert ksp.slab_tasks(n, L) == want
    fp32 = {L: ksp.stage_bytes(L, torch.float32) for L in (1, 2, 4, 8, 16, 32)}
    bf16 = {L: ksp.stage_bytes(L, torch.bfloat16) for L in (1, 2, 4, 8, 16, 32)}
    assert fp32 == {1: 0, 2: 0, 4: 0, 8: 2 * 32 * 48, 16: 2 * 32 * 80, 32: 0}
    assert bf16 == {1: 0, 2: 0, 4: 0, 8: 0, 16: 2 * 32 * 48, 32: 0}
    assert ksp.MAX_WARPS * max(fp32.values()) <= kdo.SMEM_PER_BLOCK


def test_launch_groups_give_wide_buckets_one_launch_each():
    shapes = [(50, 64), (30, 1), (0, 128), (40, 16), (7, 8192), (9, 32)]
    assert ksp.launch_groups(shapes) == [(False, (1, 3, 5)), (True, (0,)), (True, (4,))]
    many = [(10, 1 << (k % 6)) for k in range(kdo.MAX_SLABS + 3)] + [(3, 256)]
    groups = ksp.launch_groups(many)
    assert [(w, len(g)) for w, g in groups] == [(False, kdo.MAX_SLABS), (False, 3), (True, 1)]
    assert ksp.launch_groups([(0, 8), (0, 64)]) == []


def _slabs(rng, widths, n, dtype):
    """Random candidate slabs (padded rows, scale 2) and {0, 1} masks."""
    dt = getattr(torch, dtype)
    vs, masks = [], []
    for L in widths:
        rows = n if L <= 64 else 5
        v = torch.from_numpy((rng.normal(size=(rows, L)) * 2).astype(np.float32))
        mask = torch.from_numpy((rng.random((rows, L)) < 0.7).astype(np.float32))
        mask[:2] = 0.0
        vs.append(v.to(dt))
        masks.append(mask.to(dt))
    return vs, masks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inequality", [True, False])
def test_whole_call_on_cpu_is_bitwise_the_per_bucket_loop(dtype, inequality):
    rng = np.random.default_rng(11)
    vs, masks = _slabs(rng, (1, 2, 4, 8, 16, 32, 64, 12, 512), 40, dtype)
    before = kops.width_routed
    for radius in (1.0, 2.5):
        got = kops.fused_project_simplex_call(vs, masks, radius=radius, inequality=inequality)
        want = [kref.simplex_ref(v, m, radius, inequality=inequality) for v, m in zip(vs, masks)]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        assert all(float(g[:2].float().abs().max()) == 0.0 for g in got)
    assert kops.width_routed == before + 2  # the width-12 slab, once per call


def test_whole_call_routes_only_widths_the_kernel_does_not_take():
    rng = np.random.default_rng(2)
    vs, masks = _slabs(rng, (12, 3, 16384), 6, "float32")
    before = kops.width_routed
    got = kops.fused_project_simplex_call(vs, masks)
    assert kops.width_routed == before + 3
    assert all(torch.equal(g, kref.simplex_ref(v, m)) for g, v, m in zip(got, vs, masks))
    meta = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        kops.fused_project_simplex_call([meta], [meta])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inequality", [True, False])
def test_whole_call_matches_reference_kernel(dtype, inequality):
    rng = np.random.default_rng(5)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    widths = (1, 2, 4, 8, 16, 32, 64)
    vj = [jnp.asarray((rng.normal(size=(11, L)) * 3).astype(np.float32), jdt) for L in widths]
    mj = [jnp.asarray((rng.random((11, L)) < 0.75).astype(np.float32), jdt) for L in widths]
    mj = [m.at[0].set(0) for m in mj]
    vt = [convert.tensor_from_numpy(np.asarray(v), "cpu") for v in vj]
    mt = [convert.tensor_from_numpy(np.asarray(m), "cpu") for m in mj]
    got = kops.fused_project_simplex_call(vt, mt, radius=2.5, inequality=inequality)
    for g, v, m, L in zip(got, vj, mj, widths):
        want = jops.fused_project_simplex(v, m, radius=2.5, inequality=inequality,
                                          interpret=True)
        assert str(g.dtype).removeprefix("torch.") == str(want.dtype)
        np.testing.assert_allclose(g.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   atol=X_ATOL[dtype], err_msg=f"L={L}")
        assert float(g[0].float().abs().max()) == 0.0


class _ParentSimplex(MatchingObjective):
    """The previous design's unfused primal step: the projection called on
    each bucket's candidate in turn."""

    def primal_candidate(self, lam, gamma):
        inst = self.instance
        lam2 = lam.reshape(inst.num_families, inst.num_destinations)
        ginv = inv_gamma(gamma)
        return tuple(
            self.projection(-(gather_at_lam(b.coeff, b.idx, lam2) + b.cost) * ginv, b.mask)
            for b in self._buckets
        )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("inequality", [True, False])
def test_simplex_kernel_calculate_on_cpu_is_bitwise_the_per_bucket_loop(dtype, inequality):
    spec = MatchingInstanceSpec(num_sources=400, num_destinations=25, avg_degree=6.0,
                                num_families=2, seed=3)
    inst = normalize_rows(bucketize(generate_matching_instance(spec), dtype=dtype,
                                    device="cpu"))[0]
    proj = UnitSimplexProjection(radius=1.5, inequality=inequality, use_kernel=True)
    obj = MatchingObjective(inst, projection=proj)
    assert obj.kernel_plan("simplex_proj") is None  # the CPU takes no plan
    parent = _ParentSimplex(inst, projection=proj)
    lam = torch.from_numpy(np.random.default_rng(4).random(inst.dual_dim).astype(np.float32))
    for gamma in (0.05, 1.0, 20.0):
        a, b = obj.calculate(lam, gamma), parent.calculate(lam, gamma)
        for name in ("g", "grad", "primal_linear", "primal_ridge", "ax"):
            assert torch.equal(getattr(a, name), getattr(b, name)), (name, gamma)
        assert all(torch.equal(x, y) for x, y in zip(a.x_slabs, b.x_slabs))
