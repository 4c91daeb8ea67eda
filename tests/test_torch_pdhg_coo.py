"""Port parity: the COO PDHG baseline (`core.pdhg`) against the JAX package.

`from_edge_list` gives the reference's rows, cols and vals exactly, and c,
q, u exactly.  K x and K'y sum each segment exactly in int64 fixed point and
round once, so each is within one fp32 ulp of the float64 sum of the fp32
products, and within rtol 1e-6 of the reference's fp32 scatter-adds (which
round at every add); a segment of at most two entries is bitwise the
reference's (one rounding either way).  With the reference's
power-iteration start vector, `solve_pdhg` runs the same iteration count
to the same `converged` as the JAX solve, with x and y within atol 1e-4,
and matches scipy's HiGHS as tests/test_pdhg.py asserts (primal objective
within rel 5e-3).  Two port solves give equal bits.  The cases of
tests/test_pdhg.py run on the port unchanged.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch
from scipy.optimize import linprog

from repro.core.pdhg import PDHGConfig as JaxPDHGConfig
from repro.core.pdhg import from_edge_list as jax_from_edge_list
from repro.core.pdhg import solve_pdhg as jax_solve_pdhg
from repro.instances import MatchingInstanceSpec as JaxSpec
from repro.instances import generate_matching_instance as jax_generate
from repro_torch import convert
from repro_torch.core import COOLP, PDHGConfig, from_edge_list, solve_pdhg
from repro_torch.core import pdhg as tpdhg
from repro_torch.instances import MatchingInstanceSpec, generate_matching_instance


@pytest.fixture
def jax_start_vector(monkeypatch):
    """Make the port draw the reference's power-iteration start vector."""

    def start_vector(n, seed, device):
        u0 = jax.random.normal(jax.random.key(seed), (n,), jnp.float32)
        return torch.from_numpy(np.array(u0)).to(device)

    monkeypatch.setattr(tpdhg, "start_vector", start_vector)


def _pair(**spec):
    return (generate_matching_instance(MatchingInstanceSpec(**spec)),
            jax_generate(JaxSpec(**spec)))


@pytest.mark.parametrize("m", [1, 2])
def test_from_edge_list_and_matvecs_equal_reference(m):
    inst, inst_j = _pair(num_sources=50, num_destinations=8, avg_degree=3.0,
                         num_families=m, seed=8)
    lp, lp_j = from_edge_list(inst, device="cpu"), jax_from_edge_list(inst_j)
    for k in ("rows", "cols", "vals", "c", "q", "u"):
        got, want = getattr(lp, k).numpy(), np.asarray(getattr(lp_j, k))
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert (lp.num_rows, lp.num_cols) == (lp_j.num_rows, lp_j.num_cols)
    rng = np.random.default_rng(m)
    x = rng.standard_normal(lp.num_cols).astype(np.float32)
    y = rng.standard_normal(lp.num_rows).astype(np.float32)
    kx, kty = lp.K(torch.from_numpy(x)).numpy(), lp.KT(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(kx, np.asarray(lp_j.K(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(kty, np.asarray(lp_j.KT(jnp.asarray(y))), rtol=1e-6, atol=1e-6)
    if m == 1:  # every column holds two entries
        np.testing.assert_array_equal(kty, np.asarray(lp_j.KT(jnp.asarray(y))))
    # within one ulp of the float64 sum of the fp32 products
    rows, cols, vals = (np.asarray(getattr(lp_j, k)) for k in ("rows", "cols", "vals"))
    for got, key, other, v, n in ((kx, rows, cols, x, lp.num_rows),
                                  (kty, cols, rows, y, lp.num_cols)):
        exact = np.zeros(n)
        np.add.at(exact, key, (vals * v[other]).astype(np.float64))
        ulp = np.spacing(np.abs(exact).astype(np.float32))
        assert np.all(np.abs(got - exact) <= ulp)
    # a COOLP converted from the reference's is the same matrix
    back = convert.coolp_from_reference(lp_j, device="cpu")
    np.testing.assert_array_equal(back.K(torch.from_numpy(x)).numpy(),
                                  lp.K(torch.from_numpy(x)).numpy())


def _linprog_obj(inst):
    spec = inst.spec
    A, b, c = inst.to_dense()
    J = spec.num_destinations
    cols = inst.src * J + inst.dst
    S = np.zeros((spec.num_sources, inst.nnz))
    S[inst.src, np.arange(inst.nnz)] = 1.0
    r = linprog(
        c[cols], A_ub=np.vstack([A[:, cols], S]),
        b_ub=np.concatenate([b, np.ones(spec.num_sources)]),
        bounds=(0, 1), method="highs",
    )
    return r.fun


@pytest.mark.parametrize("seed", [5, 6])
def test_solve_matches_reference_and_linprog(jax_start_vector, seed):
    inst, inst_j = _pair(num_sources=60, num_destinations=10, avg_degree=4.0, seed=seed)
    res = solve_pdhg(from_edge_list(inst, device="cpu"), PDHGConfig(max_iters=40_000))
    want = jax_solve_pdhg(jax_from_edge_list(inst_j), JaxPDHGConfig(max_iters=40_000))
    assert res.iters == int(want.iters) and res.iters_used == (res.iters,)
    assert bool(res.converged) and bool(want.converged)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-4)
    np.testing.assert_allclose(res.y.numpy(), np.asarray(want.y), rtol=0, atol=1e-4)
    fun = _linprog_obj(inst)
    rel = abs(float(res.primal_obj) - fun) / abs(fun)
    assert rel < 5e-3, (float(res.primal_obj), fun)


def test_two_solves_equal_bits():
    inst, _ = _pair(num_sources=60, num_destinations=10, avg_degree=4.0, seed=5)
    cfg = PDHGConfig(max_iters=600, tol=0.0)
    a = solve_pdhg(from_edge_list(inst, device="cpu"), cfg)
    b = solve_pdhg(from_edge_list(inst, device="cpu"), cfg)
    assert a.iters == b.iters == 600
    assert torch.equal(a.x, b.x) and torch.equal(a.y, b.y)
    for sa, sb in zip(a.stats[0], b.stats[0]):
        assert torch.equal(sa, sb)


# -- tests/test_pdhg.py on the port --------------------------------------------


def test_pdhg_feasibility():
    inst = generate_matching_instance(
        MatchingInstanceSpec(num_sources=80, num_destinations=8, avg_degree=3.0, seed=7))
    lp = from_edge_list(inst, device="cpu")
    res = solve_pdhg(lp, PDHGConfig(max_iters=30_000))
    x = res.x.numpy()
    assert (x >= -1e-6).all() and (x <= 1 + 1e-6).all()
    kx = lp.K(res.x).numpy()
    q = lp.q.numpy()
    assert np.maximum(kx - q, 0).max() / (1 + np.abs(q).max()) < 1e-3


def test_explicit_row_blowup():
    """The unstructured formulation carries (m+1)x the nnz."""
    inst = generate_matching_instance(MatchingInstanceSpec(
        num_sources=50, num_destinations=8, avg_degree=3.0, num_families=2, seed=8))
    lp = from_edge_list(inst, device="cpu")
    assert isinstance(lp, COOLP)
    assert lp.rows.shape[0] == 3 * inst.nnz
