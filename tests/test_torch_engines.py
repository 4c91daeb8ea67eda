"""Port parity: the solver engines against the JAX package.

On tests/test_engines.py's 60 x 10 instance, the port's `pdhg_raw_solve`
runs every variant the reference's tests run (bucketed and dense, fused and
unfused, the four restart schemes) and is held against the JAX solve of the
same variant: g within rtol 1e-5 for fusion and density and 1e-3 for the
restart schemes (the reference's own bounds, tests/test_engines.py:69, :85,
:105), with the same iteration count.  The port draws the reference's
power-iteration start vector, so both solves take the same sigma^2.
The primal x is held at the reference's atol 1e-4.  For the fused
bucketed variant that bound is taken on a solve whose `cost_eff = c -
x/tau` rounds once, as the reference's CPU run computes it (XLA:CPU
contracts the product and the difference into one FMA): the port rounds
twice, as the card does, and on this LP, whose optimal face is not a
point, that one-ulp difference in a fifth of the slots every step moves
the 13,000-iteration x 1.3e-4 along the face while g, lam and the
iteration count still agree (ROADMAP Queue 3).
`project_simplex_cmp` is held to the JAX one at 2e-6 (values) and 1e-5
(gradients); `agd_raw_solve` and `normalize_rows_traced` at 1e-5 and 1e-6;
the engine selector's state loads across the two packages both ways.
"""
import functools
from unittest import mock

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.core import MaximizerConfig as JaxConfig
from repro.core.objective import normalize_rows as jax_normalize_rows
from repro.core.objective import normalize_rows_traced as jax_normalize_rows_traced
from repro.core.projections import project_simplex_cmp as jax_project_simplex_cmp
from repro.engines.agd import agd_raw_solve as jax_agd_raw_solve
from repro.engines.pdhg import PDHGEngineConfig as JaxPDHGConfig
from repro.engines.pdhg import pdhg_raw_solve as jax_pdhg_raw_solve
from repro.engines.selector import EngineSelector as JaxSelector
from repro.instances import MatchingInstanceSpec as JaxSpec
from repro.instances import bucketize as jax_bucketize
from repro.instances import generate_matching_instance as jax_generate
from repro_torch import convert
from repro_torch.core import MaximizerConfig
from repro_torch.core import objective as tobj
from repro_torch.core.objective import normalize_rows_traced
from repro_torch.core.projections import project_simplex, project_simplex_cmp
from repro_torch.engines import ENGINES, EngineSelector, RawSolve, resolve_engine
from repro_torch.engines.agd import agd_raw_solve
from repro_torch.engines.pdhg import PDHGEngineConfig, _use_dense, pdhg_raw_solve
from repro_torch.kernels import ops as tops

SPEC = dict(num_sources=60, num_destinations=10, avg_degree=4.0, seed=5)
PACKED_J = jax_bucketize(jax_generate(JaxSpec(**SPEC)))
PACKED = convert.instance_from_reference(PACKED_J, device="cpu")
PDHG_CFG = dict(gammas=(0.01,), iters_per_stage=20_000, tol_grad=1e-4, check_every=50)


def _jax_start_vector(n, seed, device):
    u0 = jax.random.normal(jax.random.key(seed), (n,), jnp.float32)
    return torch.from_numpy(np.array(u0)).to(device)


@pytest.fixture(autouse=True)
def jax_start_vector(monkeypatch):
    """Make the port draw the reference's power-iteration start vector."""
    monkeypatch.setattr(tobj, "start_vector", _jax_start_vector)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _jax_pdhg(restart="none", dense="auto", fused=True):
    return _cached_solve("jax", restart, dense, fused)


def _pdhg(restart="none", dense="auto", fused=True, cost_eff_roundings=2):
    return _cached_solve("port", restart, dense, fused, cost_eff_roundings)


def _cost_eff_rounded_once(cost, x, inv_tau, tmp, out):
    """`cost - x * inv_tau` rounded once, as an FMA rounds it: the product of
    two fp32 values is exact in fp64, so only the difference rounds (to
    fp64 and then to fp32, which differ from one rounding only on ties)."""
    out.copy_((cost.double() - x.double() * inv_tau).float())


@functools.lru_cache(maxsize=None)
def _cached_solve(package, restart, dense, fused, cost_eff_roundings=2):
    """Each variant's solve once per module (they take 1-10 s on the CPU)."""
    if package == "jax":
        return jax_pdhg_raw_solve(
            PACKED_J, jnp.zeros(PACKED_J.dual_dim, jnp.float32), JaxConfig(**PDHG_CFG),
            normalize=False, fused_oracle=fused,
            pcfg=JaxPDHGConfig(restart=restart, dense=dense))
    write = {2: tops._write_cost_eff, 1: _cost_eff_rounded_once}[cost_eff_roundings]
    with mock.patch.object(tops, "_write_cost_eff", write):
        return pdhg_raw_solve(
            PACKED, torch.zeros(PACKED.dual_dim), MaximizerConfig(**PDHG_CFG),
            normalize=False, fused_oracle=fused,
            pcfg=PDHGEngineConfig(restart=restart, dense=dense))


def _assert_x_close(got, want, atol=1e-4):
    for a, b in zip(got.x_slabs, want.x_slabs):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol)


# -- PDHG against the reference -------------------------------------------------


@pytest.mark.parametrize("dense,fused", [("off", False), ("off", True), ("on", True)])
def test_pdhg_matches_reference(dense, fused):
    got, want = _pdhg(dense=dense, fused=fused), _jax_pdhg(dense=dense, fused=fused)
    assert isinstance(got, RawSolve)
    np.testing.assert_allclose(float(got.g), float(want.g), rtol=1e-5)
    assert int(got.iters[0]) == int(want.iters[0])
    assert _rel(got.lam.numpy(), want.lam) < 1e-4
    np.testing.assert_allclose(float(got.sigma_sq), float(want.sigma_sq), rtol=1e-5)
    assert [tuple(x.shape) for x in got.x_slabs] == [tuple(x.shape) for x in want.x_slabs]
    if dense == "off" and fused:  # cost_eff rounded as the reference's CPU run rounds it
        got = _pdhg(dense=dense, fused=fused, cost_eff_roundings=1)
        assert int(got.iters[0]) == int(want.iters[0])
    _assert_x_close(got, want)


@pytest.mark.parametrize("restart", ["ergodic", "adaptive", "halpern"])
def test_pdhg_restart_schemes_match_reference(restart):
    got, want = _pdhg(restart=restart), _jax_pdhg(restart=restart)
    np.testing.assert_allclose(float(got.g), float(want.g), rtol=1e-3)
    assert int(got.restarts) == int(want.restarts) > 0
    assert int(got.iters[0]) == int(want.iters[0])
    # the reference's own test: every scheme reaches the no-restart objective
    np.testing.assert_allclose(float(got.g), float(_pdhg().g), rtol=1e-3)
    if restart == "adaptive":
        assert int(got.iters[0]) < int(_pdhg().iters[0])


def test_pdhg_dense_matches_bucketed():
    """The reference's dense-vs-bucketed test at its bounds: g, lam, and x
    (atol 1e-4) with the bucketed solve's cost_eff rounded once, as the
    reference's CPU run rounds it (the module docstring says why)."""
    a, b = _pdhg(dense="off"), _pdhg(dense="on")
    np.testing.assert_allclose(float(a.g), float(b.g), rtol=1e-5)
    assert _rel(b.lam.numpy(), a.lam.numpy()) < 1e-4
    assert [tuple(x.shape) for x in a.x_slabs] == [tuple(x.shape) for x in b.x_slabs]
    for xa, xb, bk in zip(a.x_slabs, b.x_slabs, PACKED.buckets):
        pad = bk.mask == 0  # the merge/split round trip leaves pad slots at 0
        assert float(xa[pad].abs().sum()) == 0.0 and float(xb[pad].abs().sum()) == 0.0
        assert float(xb.sum(-1).max()) <= 1.0 + 1e-5
    _assert_x_close(_pdhg(dense="off", cost_eff_roundings=1), b)


def test_pdhg_cost_eff_is_rounded_twice():
    """The port writes cost_eff as a product and then a difference, each
    rounded (the card's arithmetic, which chip_smoke holds bitwise); on
    random inputs that differs from one rounding in some slots, by an ulp."""
    rng = np.random.default_rng(4)
    cost = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    x = torch.from_numpy(rng.random((64, 8)).astype(np.float32))
    inv_tau = tops._inv_tau(0.37)
    two, one = torch.empty_like(cost), torch.empty_like(cost)
    tops._write_cost_eff(cost, x, inv_tau, torch.empty_like(x), two)
    _cost_eff_rounded_once(cost, x, inv_tau, None, one)
    assert torch.equal(two, torch.sub(cost, torch.mul(x, inv_tau)))
    assert not torch.equal(two, one)
    assert float((two - one).abs().max()) <= float(one.abs().max()) * 2.0 ** -23


@pytest.mark.parametrize("inequality", [True, False])
def test_fused_pdhg_step_matches_reference(inequality):
    """One fused prox step per bucket, and the whole call over every bucket,
    against the reference's `fused_pdhg_step` (interpret mode): x atol 3e-5,
    A x atol 3e-5 + rtol 1e-5 (tests/test_dual_oracle.py's bounds)."""
    from repro.kernels import ops as jops

    rng = np.random.default_rng(3)
    tau = np.float32(0.37)
    y = rng.random(PACKED.dual_dim).astype(np.float32)
    xs = [rng.random(b.cost.shape).astype(np.float32) * b.mask.numpy()
          for b in PACKED.buckets]
    step = tops.plan_pdhg_step(PACKED.buckets, [b.cost for b in PACKED.buckets],
                               num_destinations=10, inequality=inequality)
    got_xs, got_ax = tops.fused_pdhg_step_call(
        step, [torch.from_numpy(x) for x in xs], torch.from_numpy(y), float(tau))
    want_ax = np.zeros(PACKED.dual_dim, np.float32)
    for bt, bj, x, gx in zip(PACKED.buckets, PACKED_J.buckets, xs, got_xs):
        wx, wh = jops.fused_pdhg_step(
            bj.idx, bj.coeff, bj.cost, bj.mask, jnp.asarray(x), jnp.asarray(y),
            jnp.float32(tau), num_destinations=10, inequality=inequality, interpret=True)
        tx, th = tops.fused_pdhg_step(
            bt.idx, bt.coeff, bt.cost, bt.mask, torch.from_numpy(x), torch.from_numpy(y),
            float(tau), num_destinations=10, inequality=inequality)
        np.testing.assert_allclose(tx.numpy(), np.asarray(wx), atol=3e-5)
        np.testing.assert_allclose(th.numpy(), np.asarray(wh), atol=3e-5, rtol=1e-5)
        assert torch.equal(gx, tx)  # the whole call is the per-bucket step
        want_ax += np.asarray(wh).reshape(-1)
    np.testing.assert_allclose(got_ax.numpy(), want_ax, atol=3e-5, rtol=1e-5)
    assert step.plan is None and step.launches_per_call == 0  # the CPU has no plan


def test_pdhg_fused_matches_unfused():
    a, b = _pdhg(dense="off", fused=False), _pdhg(dense="off", fused=True)
    np.testing.assert_allclose(float(a.g), float(b.g), rtol=1e-5)


def test_pdhg_warm_start_uses_fewer_iters():
    cold = _pdhg(restart="adaptive")
    warm = pdhg_raw_solve(
        PACKED, cold.lam, MaximizerConfig(**PDHG_CFG), normalize=False, fused_oracle=True,
        sigma_sq=cold.sigma_sq, pcfg=PDHGEngineConfig(restart="adaptive"))
    assert int(warm.iters[0]) < int(cold.iters[0])


def test_dense_gate_and_config():
    buckets, J = PACKED.buckets, SPEC["num_destinations"]
    assert _use_dense(buckets, J, PDHGEngineConfig(dense="on"))
    assert not _use_dense(buckets, J, PDHGEngineConfig(dense="off"))
    assert _use_dense(buckets, J, PDHGEngineConfig(dense="auto"))
    assert not _use_dense(buckets, J, PDHGEngineConfig(dense="auto", dense_max_cells=8))
    for kw in (dict(dense="sometimes"), dict(restart="often"), dict(step_margin=1.0)):
        with pytest.raises(ValueError):
            PDHGEngineConfig(**kw)


def test_pdhg_refuses_non_simplex_sets():
    from repro_torch.formulation import capacity_cap_formulation

    comp = capacity_cap_formulation().compile(PACKED)
    with pytest.raises(NotImplementedError, match="simplex"):
        pdhg_raw_solve(comp.instance, torch.zeros(PACKED.dual_dim),
                       MaximizerConfig(**PDHG_CFG), normalize=False)


# -- the sort-free projection -----------------------------------------------------


def _cmp_inputs(seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(40, 8)).astype(np.float32)
    mask = (rng.random((40, 8)) > 0.25).astype(np.float32)
    mask[:, 0] = 1.0  # no empty rows
    return v, mask


@pytest.mark.parametrize("inequality", [True, False])
def test_project_simplex_cmp_matches_reference(inequality):
    v, mask = _cmp_inputs(0)
    want = jax_project_simplex_cmp(jnp.asarray(v), jnp.asarray(mask), inequality=inequality)
    got = project_simplex_cmp(torch.from_numpy(v), torch.from_numpy(mask),
                              inequality=inequality)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    sort = project_simplex(torch.from_numpy(v), torch.from_numpy(mask),
                           inequality=inequality)
    np.testing.assert_allclose(got.numpy(), sort.numpy(), atol=2e-6)


@pytest.mark.parametrize("inequality", [True, False])
def test_project_simplex_cmp_grad_matches_reference(inequality):
    rng = np.random.default_rng(1)
    v = rng.normal(size=(12, 5)).astype(np.float32)
    mask = np.ones((12, 5), np.float32)
    mask[::3, 4] = 0.0
    want = jax.grad(lambda u: jnp.sum(jax_project_simplex_cmp(
        u, jnp.asarray(mask), inequality=inequality) ** 3))(jnp.asarray(v))
    vt = torch.from_numpy(v).requires_grad_(True)
    loss = (project_simplex_cmp(vt, torch.from_numpy(mask), inequality=inequality) ** 3).sum()
    (got,) = torch.autograd.grad(loss, vt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_project_simplex_cmp_masked_and_feasible():
    rng = np.random.default_rng(2)
    v = torch.from_numpy(rng.normal(size=(16, 6)).astype(np.float32) - 2.0)
    mask = torch.ones(16, 6)
    # strictly-interior points are fixed points of the inequality projection
    np.testing.assert_allclose(project_simplex_cmp(v, mask).numpy(),
                               torch.clamp_min(v, 0.0).numpy(), atol=1e-6)
    mask[:, 3:] = 0.0
    out = project_simplex_cmp(torch.from_numpy(
        rng.normal(size=(16, 6)).astype(np.float32) + 5.0), mask)
    assert float(out[:, 3:].abs().max()) == 0.0
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, atol=1e-5)


# -- AGD engine and the traced normalization ---------------------------------------

AGD_SPEC = dict(num_sources=300, num_destinations=40, avg_degree=5.0, num_families=2,
                seed=7)


@pytest.fixture(scope="module")
def agd_instances():
    pj = jax_bucketize(jax_generate(JaxSpec(**AGD_SPEC)))
    return pj, convert.instance_from_reference(pj, device="cpu")


def test_normalize_rows_traced_matches_reference(agd_instances):
    pj, pt = agd_instances
    want, d_want = jax_normalize_rows_traced(pj)
    got, d_got = normalize_rows_traced(pt)
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_want), rtol=1e-6)
    np.testing.assert_allclose(got.rhs.numpy(), np.asarray(want.rhs), rtol=1e-6)
    for bg, bw in zip(got.buckets, want.buckets):
        np.testing.assert_allclose(bg.coeff.numpy(), np.asarray(bw.coeff), rtol=1e-6)
        assert torch.equal(bg.idx, torch.from_numpy(np.asarray(bw.idx)))


@pytest.mark.parametrize("normalize,fused", [(True, False), (False, True), (True, True)])
def test_agd_raw_solve_matches_reference(agd_instances, normalize, fused):
    pj, pt = agd_instances
    if not normalize:  # the host-normalized instance, as the CLI solves it
        pj = jax_normalize_rows(pj)[0]
        pt = convert.instance_from_reference(pj, device="cpu")
    cfg = dict(iters_per_stage=25)
    want = jax_agd_raw_solve(pj, jnp.zeros(pj.dual_dim, jnp.float32), JaxConfig(**cfg),
                             normalize, fused)
    got = agd_raw_solve(pt, torch.zeros(pt.dual_dim), MaximizerConfig(**cfg), normalize,
                        fused)
    np.testing.assert_allclose(float(got.sigma_sq), float(want.sigma_sq), rtol=1e-5)
    np.testing.assert_allclose(got.etas.numpy(), np.asarray(want.etas), rtol=1e-5)
    assert got.iters.tolist() == np.asarray(want.iters).tolist()
    assert _rel(got.lam.numpy(), want.lam) <= 1e-5
    np.testing.assert_allclose(float(got.g), float(want.g), rtol=1e-5)
    for st_t, st_j in zip(got.stats, want.stats):
        np.testing.assert_allclose(st_t.g.numpy(), np.asarray(st_j.g), rtol=1e-5)


def test_agd_engine_early_stop_and_sigma_reuse(agd_instances):
    pj, pt = agd_instances
    cfg = dict(gammas=(1e3, 1e2, 10.0), iters_per_stage=60, tol_grad=0.2, tol_viol=0.05,
               check_every=10)
    want = jax_agd_raw_solve(pj, jnp.zeros(pj.dual_dim, jnp.float32), JaxConfig(**cfg),
                             True, True)
    got = resolve_engine("agd").raw_solve(
        pt, torch.zeros(pt.dual_dim), MaximizerConfig(**cfg), normalize=True,
        fused_oracle=True)
    assert got.iters.tolist() == np.asarray(want.iters).tolist()
    assert min(got.iters.tolist()) < 60
    again = resolve_engine("agd").raw_solve(
        pt, torch.zeros(pt.dual_dim), MaximizerConfig(**cfg), normalize=True,
        fused_oracle=True, sigma_sq=got.sigma_sq)
    assert torch.equal(again.lam, got.lam)


# -- the engine selector ------------------------------------------------------------


def test_selector_exploration_is_deterministic_rotation():
    sel, ref = EngineSelector(), JaxSelector()
    orders = {t: sel.exploration_order(t) for t in ("a", "b", "c", "d")}
    for t, order in orders.items():
        assert sorted(order) == sorted(ENGINES)
        assert sel.exploration_order(t) == order == ref.exploration_order(t)
    assert {order[0] for order in orders.values()} == set(ENGINES)


def test_selector_routes_to_cheaper_engine():
    sel = EngineSelector(explore_cadences=1)
    t = "tenant"
    first, second = sel.exploration_order(t)
    assert sel.choose(t) == first
    sel.observe(t, first, iters=900, converged=True)
    assert sel.choose(t) == second  # still exploring
    sel.observe(t, second, iters=200, converged=True)
    assert sel.choose(t) == second  # cheaper engine wins
    for _ in range(8):  # drift: the cheap engine degrades
        sel.observe(t, second, iters=5000, converged=True)
    assert sel.choose(t) == first


def test_selector_penalizes_non_convergence():
    sel = EngineSelector(explore_cadences=1, penalty=2.0)
    e0, e1 = sel.exploration_order("x")
    sel.observe("x", e0, iters=1000, converged=False)  # scores 2000
    sel.observe("x", e1, iters=1500, converged=True)  # scores 1500
    assert sel.choose("x") == e1


def test_selector_rejects_unknown_engine():
    with pytest.raises(ValueError):
        EngineSelector().observe("t", "simplex", iters=10, converged=True)
    with pytest.raises(ValueError):
        EngineSelector(decay=1.0)


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_selector_state_loads_across_packages(direction):
    writer, reader = ((EngineSelector, JaxSelector) if direction == "port_to_reference"
                      else (JaxSelector, EngineSelector))
    sel = writer(decay=0.5, explore_cadences=2, penalty=3.0)
    for t in ("a", "b"):
        for i, e in enumerate(ENGINES):
            sel.observe(t, e, iters=100 + 300 * i, converged=t == "a")
    clone = reader()
    clone.load_state(sel.state_dict())
    assert clone.state_dict() == sel.state_dict()
    for t in ("a", "b", "never-seen"):
        assert clone.choose(t) == sel.choose(t)


def test_resolve_engine_registry():
    for name in ENGINES:
        assert resolve_engine(name).name == name
    with pytest.raises(ValueError):
        resolve_engine("auto")  # a policy, not an engine
