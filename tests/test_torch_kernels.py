"""Port parity: the primal-step and simplex kernels' dispatch, against the JAX package.

On the CPU `ops.fused_dual_primal` and `ops.fused_project_simplex` take the
kernels' plain versions; they must match the reference's Pallas kernels
run in interpret mode at the reference's tolerances (tests/test_kernels.py:
atol 3e-5, 2e-2 for bf16), keep the input's dtype, and route widths the
kernels do not take by the width rule.  `MatchingObjective(fused_kernel=True)`
and `projection=UnitSimplexProjection(use_kernel=True)` match the reference
objective with the same options within g rtol 1e-5 and grad atol 3e-5, and a
short solve with each matches the reference's stage by stage (g traces
1e-5 rel, lam 1e-5 rel-L2) with the reference's power-iteration start
vector.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.core import Maximizer as JaxMaximizer
from repro.core import MaximizerConfig as JaxConfig
from repro.core.objective import MatchingObjective as JaxObjective
from repro.core.objective import normalize_rows as jax_normalize_rows
from repro.core.projections import UnitSimplexProjection as JaxSimplex
from repro.instances import MatchingInstanceSpec as JaxSpec
from repro.instances import bucketize as jax_bucketize
from repro.instances import generate_matching_instance as jax_generate
from repro.instances.buckets import Bucket as JaxBucket
from repro.instances.buckets import convert_bucket as jax_convert_bucket
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import Maximizer, MaximizerConfig, MatchingObjective
from repro_torch.core import objective as tobj
from repro_torch.core.projections import UnitSimplexProjection
from repro_torch.kernels import ops as tops

X_ATOL = {"float32": 3e-5, "bfloat16": 2e-2, "int8": 3e-5}


def _slab(dtype, n, L, m, J, seed):
    """One random bucket (padded rows included) as JAX arrays and as port
    tensors, in a slab dtype, and a random lam."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((n, L)) < 0.8).astype(np.float32)
    mask[:3] = 0.0
    idx = (rng.integers(0, J, size=(n, L)) * mask).astype(np.int32)
    coeff = (rng.random((m, n, L)) * mask[None]).astype(np.float32)
    cost = (rng.normal(size=(n, L)) * mask).astype(np.float32)
    bj = jax_convert_bucket(
        JaxBucket(idx=idx, coeff=coeff, cost=cost, mask=mask, length=L), dtype
    )
    t = lambda a: None if a is None else convert.tensor_from_numpy(a, "cpu")
    bt = dict(idx=t(bj.idx), coeff=t(bj.coeff), cost=t(bj.cost), mask=t(bj.mask),
              coeff_scale=t(bj.coeff_scale), cost_scale=t(bj.cost_scale))
    return bj, bt, rng.random(m * J).astype(np.float32)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("L", [4, 64])
@pytest.mark.parametrize("m", [1, 3])
def test_fused_dual_primal_matches_reference_kernel(dtype, L, m):
    J, n = 32, 29
    bj, bt, lam = _slab(dtype, n, L, m, J, seed=7 * L + m)
    for gamma in (0.01, 1.0, 100.0):
        want = jops.fused_dual_primal(
            bj.idx, bj.coeff, bj.cost, bj.mask, jnp.asarray(lam), jnp.float32(gamma),
            num_destinations=J, interpret=True,
            coeff_scale=bj.coeff_scale, cost_scale=bj.cost_scale,
        )
        got = tops.fused_dual_primal(
            bt["idx"], bt["coeff"], bt["cost"], bt["mask"],
            convert.lam_from_numpy(lam, "cpu"), gamma, num_destinations=J,
            coeff_scale=bt["coeff_scale"], cost_scale=bt["cost_scale"],
        )
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=X_ATOL[dtype],
                                   err_msg=f"gamma={gamma}")
        assert float(got[:3].abs().max()) == 0.0


@pytest.mark.parametrize("inequality", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_project_simplex_matches_reference_kernel(inequality, dtype):
    rng = np.random.default_rng(5)
    v = (rng.normal(size=(9, 32)) * 4).astype(np.float32)
    mask = (rng.random((9, 32)) < 0.8).astype(np.float32)
    mask[0] = 0.0
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jops.fused_project_simplex(
        jnp.asarray(v, jdt), jnp.asarray(mask, jdt), radius=2.5,
        inequality=inequality, interpret=True,
    )
    vt = convert.tensor_from_numpy(np.asarray(jnp.asarray(v, jdt)), "cpu")
    mt = convert.tensor_from_numpy(np.asarray(jnp.asarray(mask, jdt)), "cpu")
    got = tops.fused_project_simplex(vt, mt, radius=2.5, inequality=inequality)
    assert got.dtype == vt.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), atol=X_ATOL[dtype])
    assert float(got[0].abs().max()) == 0.0
    rows = _f32(got).sum(axis=1)[1:]
    if inequality:
        assert (rows <= 2.5 + 0.05).all()
    else:
        np.testing.assert_allclose(rows, 2.5, atol=0.05)


def test_fused_project_simplex_routes_wide_rows_by_width():
    rng = np.random.default_rng(1)
    v = rng.normal(size=(2, 16384)).astype(np.float32)
    mask = np.ones_like(v)
    want = jops.fused_project_simplex(jnp.asarray(v), jnp.asarray(mask), interpret=True)
    before = tops.width_routed
    got = tops.fused_project_simplex(torch.from_numpy(v), torch.from_numpy(mask))
    assert tops.width_routed == before + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def test_kernel_entry_points_refuse_other_devices():
    v = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        tops.fused_project_simplex(v, v)


@pytest.fixture(scope="module")
def small_instance():
    spec = JaxSpec(num_sources=60, num_destinations=12, avg_degree=4.0,
                   num_families=2, seed=7)
    pj, _ = jax_normalize_rows(jax_bucketize(jax_generate(spec)))
    return pj, convert.instance_from_reference(pj, device="cpu")


_PORT_KW = {
    "fused_kernel": dict(fused_kernel=True),
    "simplex_kernel": dict(projection=UnitSimplexProjection(use_kernel=True)),
}
_JAX_KW = {
    "fused_kernel": dict(fused_kernel=True, kernel_interpret=True),
    "simplex_kernel": dict(projection=JaxSimplex(use_kernel=True, interpret=True)),
}


@pytest.mark.parametrize("mode", ["fused_kernel", "simplex_kernel"])
def test_objective_with_kernel_matches_reference(small_instance, mode):
    pj, pt = small_instance
    lam = np.random.default_rng(0).random(pj.dual_dim).astype(np.float32)
    want = JaxObjective(pj, **_JAX_KW[mode]).calculate(jnp.asarray(lam), 0.5)
    got = MatchingObjective(pt, **_PORT_KW[mode]).calculate(
        convert.lam_from_numpy(lam, "cpu"), 0.5
    )
    np.testing.assert_allclose(float(got.g), float(want.g), rtol=1e-5)
    np.testing.assert_allclose(got.grad.numpy(), np.asarray(want.grad), atol=3e-5)
    for x_t, x_j in zip(got.x_slabs, want.x_slabs):
        np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=3e-5)


def test_fused_kernel_objective_needs_the_simplex(small_instance):
    from repro_torch.core.projections import BoxProjection

    _, pt = small_instance
    obj = MatchingObjective(pt, projection=BoxProjection(), fused_kernel=True)
    with pytest.raises(ValueError, match="simplex"):
        obj.calculate(torch.zeros(pt.dual_dim), 1.0)


def test_use_kernel_keeps_the_default_projection():
    assert UnitSimplexProjection() == UnitSimplexProjection(use_kernel=False)
    assert hash(UnitSimplexProjection()) == hash(UnitSimplexProjection(1.0, True))
    assert UnitSimplexProjection(use_kernel=True) != UnitSimplexProjection()


@pytest.fixture
def jax_start_vector(monkeypatch):
    """Make the port draw the reference's power-iteration start vector."""

    def start_vector(n, seed, device):
        u0 = jax.random.normal(jax.random.key(seed), (n,), jnp.float32)
        return torch.from_numpy(np.array(u0)).to(device)

    monkeypatch.setattr(tobj, "start_vector", start_vector)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.fixture(scope="module")
def solve_instance():
    # the instance of tests/test_torch_solve.py: on the 60 x 12 one above the
    # last stage (gamma = 0.01) amplifies fp32 reduction-order noise to 2e-5
    # in g even between the two packages' plain solves
    spec = JaxSpec(num_sources=300, num_destinations=40, avg_degree=5.0,
                   num_families=2, seed=7)
    pj, _ = jax_normalize_rows(jax_bucketize(jax_generate(spec)))
    return pj, convert.instance_from_reference(pj, device="cpu")


@pytest.mark.parametrize("mode", ["fused_kernel", "simplex_kernel"])
def test_solve_with_kernel_matches_reference(solve_instance, jax_start_vector, mode):
    pj, pt = solve_instance
    cfg = dict(iters_per_stage=25)
    want = JaxMaximizer(JaxObjective(pj, **_JAX_KW[mode]), JaxConfig(**cfg)).solve()
    got = Maximizer(MatchingObjective(pt, **_PORT_KW[mode]), MaximizerConfig(**cfg)).solve()
    for st_t, st_j in zip(got.stats, want.stats):
        tr_t, tr_j = st_t.g.numpy(), np.asarray(st_j.g)
        assert np.max(np.abs(tr_t - tr_j) / (np.abs(tr_j) + 1e-9)) <= 1e-5
    assert _rel(got.lam.numpy(), want.lam) <= 1e-5
    assert _rel(float(got.g), float(want.g)) <= 1e-5
