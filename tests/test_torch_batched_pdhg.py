"""Port parity: the batched PDHG solve (`engines.pdhg.pdhg_raw_solve_batched`,
the service's batched `engine="pdhg"` groups) against the JAX package's
`jax.vmap(pdhg_raw_solve)` and against the port's own solo solves.

Three lanes of tests/test_engines.py's 60 x 10 instance, each with its
coefficients scaled and its costs shifted by seeded numpy noise, so that
each lane has its own sigma_max(A)^2, tau and sig.  PDHG budgets of 1000
iterations with checks every 25 and tolerance 1e-2: the lanes stop apart,
after 375 to 800 iterations, so a stopped lane's freezing is what is
compared.

  * Against the reference, per lane, on the dense path and on the fused and
    unfused bucketed paths (`dense="off"`), with the `none` and `adaptive`
    restart schemes: the same iteration count (and restart count), g
    within rtol 1e-5 (fusion and density, tests/test_engines.py:69, :85;
    1e-3 for the restart schemes, :105), lam within 1e-4 rel-L2 and x
    within atol 1e-4 (:73, :80).  The port draws the reference's power
    iteration start vector, so both solves take the same sigma^2.
  * Each lane against the port's own solo `pdhg_raw_solve`: bitwise (lam,
    x, g, traces, iterations, restarts) with all four restart schemes on
    the dense and unfused bucketed paths, and two on the fused one (the
    schemes differ only in host logic the paths share; the fused path's
    plain version is the slow one on the CPU).
  * `compiled_batch_solver(engine="pdhg")` and its `_fixed_sigma` form
    through `service/engine.py`: the batched solve, lane for lane.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.core import MaximizerConfig as JaxConfig
from repro.engines.pdhg import PDHGEngineConfig as JaxPDHGConfig
from repro.engines.pdhg import pdhg_raw_solve as jax_pdhg_raw_solve
from repro.instances import MatchingInstanceSpec as JaxSpec
from repro.instances import bucketize as jax_bucketize
from repro.instances import generate_matching_instance as jax_generate
from repro_torch import convert
from repro_torch.core import MaximizerConfig
from repro_torch.core import objective as tobj
from repro_torch.core.batched import lane_instance
from repro_torch.engines.pdhg import PDHGEngineConfig, pdhg_raw_solve, pdhg_raw_solve_batched
from repro_torch.service import (
    compiled_batch_solver,
    compiled_batch_solver_fixed_sigma,
    to_solve_results,
)

SPEC = dict(num_sources=60, num_destinations=10, avg_degree=4.0, seed=5)
B = 3
CFG = dict(gammas=(0.01,), iters_per_stage=1000, tol_grad=1e-2, check_every=25)


def _lanes_reference():
    """B lanes of the reference instance: coefficients times U(0.5, 1.5) and
    costs plus N(0, 0.1) on the real slots, seeded per lane."""
    base = jax_bucketize(jax_generate(JaxSpec(**SPEC)))
    lanes = []
    for b in range(B):
        rng = np.random.default_rng(100 + b)
        buckets = []
        for bk in base.buckets:
            coeff, cost, mask = (np.asarray(a) for a in (bk.coeff, bk.cost, bk.mask))
            coeff = coeff * rng.uniform(0.5, 1.5, coeff.shape).astype(np.float32)
            cost = cost + (rng.normal(0.0, 0.1, cost.shape) * mask).astype(np.float32)
            buckets.append(dataclasses.replace(bk, coeff=jnp.asarray(coeff),
                                               cost=jnp.asarray(cost)))
        lanes.append(dataclasses.replace(base, buckets=tuple(buckets)))
    return lanes


LANES_J = _lanes_reference()
STACKED_J = jax.tree.map(lambda *xs: jnp.stack(xs), *LANES_J)
STACKED = convert.stacked_from_reference(LANES_J, "cpu")
LAM0 = torch.zeros(B, STACKED.dual_dim)


@pytest.fixture(autouse=True)
def jax_start_vector(monkeypatch):
    """Make the port draw the reference's power-iteration start vector."""
    def start_vector(n, seed, device):
        u0 = jax.random.normal(jax.random.key(seed), (n,), jnp.float32)
        return torch.from_numpy(np.array(u0)).to(device)

    monkeypatch.setattr(tobj, "start_vector", start_vector)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@functools.lru_cache(maxsize=None)
def _jax_batched(restart, dense, fused):
    """The reference's vmapped solve of every lane (one compile each)."""
    cfg, pcfg = JaxConfig(**CFG), JaxPDHGConfig(restart=restart, dense=dense)
    fn = jax.jit(jax.vmap(lambda inst, lam0: jax_pdhg_raw_solve(
        inst, lam0, cfg, False, fused, None, pcfg)))
    return fn(STACKED_J, jnp.zeros((B, STACKED_J.dual_dim), jnp.float32))


@functools.lru_cache(maxsize=None)
def _batched(restart, dense, fused):
    return pdhg_raw_solve_batched(STACKED, LAM0, MaximizerConfig(**CFG), False, fused,
                                  pcfg=PDHGEngineConfig(restart=restart, dense=dense))


VARIANTS = [("none", "on", False), ("none", "off", True), ("none", "off", False),
            ("adaptive", "off", True), ("adaptive", "on", False)]


@pytest.mark.parametrize("restart,dense,fused", VARIANTS)
def test_batched_pdhg_matches_vmapped_reference(restart, dense, fused):
    got, want = _batched(restart, dense, fused), _jax_batched(restart, dense, fused)
    iters = [int(i) for i in got.iters[:, 0]]
    assert len(set(iters)) > 1  # the lanes stop apart
    assert iters == [int(i) for i in np.asarray(want.iters)[:, 0]]
    assert [int(r) for r in got.restarts] == [int(r) for r in np.asarray(want.restarts)]
    if restart == "adaptive":
        assert int(got.restarts.sum()) > 0
    rtol = 1e-5 if restart == "none" else 1e-3
    for b in range(B):
        np.testing.assert_allclose(float(got.g[b]), float(want.g[b]), rtol=rtol)
        np.testing.assert_allclose(float(got.sigma_sq[b]), float(want.sigma_sq[b]), rtol=1e-5)
        np.testing.assert_allclose(float(got.etas[b, 0]), float(want.etas[b, 0]), rtol=1e-5)
        assert _rel(got.lam[b].numpy(), want.lam[b]) < 1e-4, b
        for x, wx in zip(got.x_slabs, want.x_slabs):
            assert tuple(x[b].shape) == tuple(np.asarray(wx[b]).shape)
            np.testing.assert_allclose(x[b].numpy(), np.asarray(wx[b]), atol=1e-4)
        assert got.stats[0].g[b].shape == np.asarray(want.stats[0].g[b]).shape
    assert len({round(float(s), 6) for s in got.sigma_sq}) == B  # a step size per lane


@pytest.mark.parametrize("restart,dense,fused", [
    *[(r, d, False) for r in ("none", "adaptive", "ergodic", "halpern") for d in ("on", "off")],
    ("adaptive", "off", True), ("halpern", "off", True)])
def test_batched_pdhg_lanes_are_solo_solves(restart, dense, fused):
    """Every lane bitwise the port's solo solve of that lane."""
    pcfg = PDHGEngineConfig(restart=restart, dense=dense, restart_every=50)
    cfg = MaximizerConfig(**CFG)
    got = pdhg_raw_solve_batched(STACKED, LAM0, cfg, False, fused, pcfg=pcfg)
    for b in range(B):
        solo = pdhg_raw_solve(lane_instance(STACKED, b), LAM0[b], cfg, False, fused,
                              pcfg=pcfg)
        assert torch.equal(got.lam[b], solo.lam), b
        assert torch.equal(got.g[b], solo.g), b
        assert all(torch.equal(x[b], s) for x, s in zip(got.x_slabs, solo.x_slabs))
        assert int(got.iters[b, 0]) == int(solo.iters[0])
        assert int(got.restarts[b]) == int(solo.restarts)
        for field in ("g", "grad_norm", "max_violation"):
            assert torch.equal(getattr(got.stats[0], field)[b],
                               getattr(solo.stats[0], field)), field
        assert float(got.sigma_sq[b]) == float(solo.sigma_sq)


def test_compiled_batch_solver_pdhg():
    """The service's batched entries route engine="pdhg" to the batched
    solve (normalized lanes, each lane's own sigma), and the fixed-sigma form
    echoes the given per-lane sigma_sq and solves as the batched solve given
    them does."""
    cfg, fused = MaximizerConfig(**CFG), False
    raw = compiled_batch_solver(cfg, True, fused, engine="pdhg")(STACKED, LAM0)
    want = pdhg_raw_solve_batched(STACKED, LAM0, cfg, True, fused)
    assert torch.equal(raw.lam, want.lam) and torch.equal(raw.iters, want.iters)
    results = to_solve_results(raw)
    assert len(results) == B and len({r.iters_used for r in results}) > 1
    for b, r in enumerate(results):
        solo = pdhg_raw_solve(lane_instance(STACKED, b), LAM0[b], cfg, True, fused)
        assert torch.equal(r.lam, solo.lam)
        assert r.iters_used == (int(solo.iters[0]),) and r.restarts == int(solo.restarts)
    sigmas = raw.sigma_sq * 1.5
    fixed = compiled_batch_solver_fixed_sigma(cfg, True, fused, engine="pdhg")(
        STACKED, LAM0, sigmas)
    assert torch.equal(fixed.sigma_sq, sigmas)
    want = pdhg_raw_solve_batched(STACKED, LAM0, cfg, True, fused, sigma_sq=sigmas)
    assert torch.equal(fixed.lam, want.lam) and torch.equal(fixed.iters, want.iters)
    assert not torch.equal(fixed.lam, raw.lam)
