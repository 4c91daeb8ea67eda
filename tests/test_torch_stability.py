"""Port parity: stability control (`core.stability`) against the JAX package.

`drift_bound` equals the reference's exactly and `primal_drift` within
1e-6 rel on the same slabs.  The cases of tests/test_stability.py run on
the port unchanged (the drift bound holds empirically; a larger gamma drifts
less; `RecurringSolver` reports drift).  A two-day `RecurringSolver` run
gives the reference's report keys, its drift values within rtol 1e-4, and
lam within 1e-5 rel-L2, the bound tests/test_torch_solve.py holds the
Maximizer to (25 iterations per stage, the reference's power-iteration
start vector); a resized third day cold-starts with the reference's
`cold_start_reason`.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.core import MaximizerConfig as JaxConfig
from repro.core import RecurringSolver as JaxRecurringSolver
from repro.core import drift_bound as jax_drift_bound
from repro.core import primal_drift as jax_primal_drift
from repro.instances import MatchingInstanceSpec as JaxSpec
from repro.instances import bucketize as jax_bucketize
from repro.instances import generate_matching_instance as jax_generate
from repro_torch import convert
from repro_torch.core import (
    Maximizer,
    MaximizerConfig,
    MatchingObjective,
    RecurringSolver,
    drift_bound,
    primal_drift,
)
from repro_torch.core import objective as tobj
from repro_torch.instances import (
    MatchingInstanceSpec,
    bucketize,
    generate_matching_instance,
)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.fixture
def jax_start_vector(monkeypatch):
    """Make the port draw the reference's power-iteration start vector."""

    def start_vector(n, seed, device):
        u0 = jax.random.normal(jax.random.key(seed), (n,), jnp.float32)
        return torch.from_numpy(np.array(u0)).to(device)

    monkeypatch.setattr(tobj, "start_vector", start_vector)


def _perturbed_pair(scale=0.02, seed=31, generate=generate_matching_instance,
                    spec_cls=MatchingInstanceSpec, num_destinations=12):
    spec = spec_cls(
        num_sources=200, num_destinations=num_destinations, avg_degree=4.0, seed=seed
    )
    a = generate(spec)
    b = dataclasses.replace(a)
    rng = np.random.default_rng(seed + 1)
    noise = 1.0 + scale * rng.standard_normal(a.nnz)
    b.values = a.values * noise
    b.coeff = a.coeff * noise
    return a, b


def _cpu(inst):
    return bucketize(inst, device="cpu")


@pytest.mark.parametrize("args", [(0.5, 2.0), (0.05, 3.0, 1.5, 20.0), (1e-3, 0.0, 4.0)])
def test_drift_bound_equals_reference(args):
    assert drift_bound(*args) == jax_drift_bound(*args)


def test_primal_drift_equals_reference():
    rng = np.random.default_rng(3)
    x1 = [rng.random((40, L)).astype(np.float32) for L in (1, 4, 16)]
    x2 = [x + 0.01 * rng.standard_normal(x.shape).astype(np.float32) for x in x1]
    got = primal_drift([torch.from_numpy(x) for x in x1], [torch.from_numpy(x) for x in x2])
    want = jax_primal_drift([jnp.asarray(x) for x in x1], [jnp.asarray(x) for x in x2])
    assert got.shape == () and got.dtype == torch.float32
    assert _rel(float(got), float(want)) <= 1e-6


# -- tests/test_stability.py on the port ---------------------------------------


@pytest.mark.parametrize("gamma", [0.05, 0.5])
def test_drift_bound_holds(gamma):
    """||x*(lam1;c1) - x*(lam2;c2)|| <= (sigma||dlam|| + ||dc||)/gamma."""
    a, b = _perturbed_pair()
    pa, pb = _cpu(a), _cpu(b)
    cfg = MaximizerConfig(gammas=(gamma,), iters_per_stage=400)
    ra = Maximizer(MatchingObjective(pa), cfg).solve()
    rb = Maximizer(MatchingObjective(pb), cfg).solve(lam0=ra.lam)
    drift = float(primal_drift(ra.x_slabs, rb.x_slabs))
    dc = float(np.sqrt(sum(
        float(torch.sum((x.cost - y.cost) ** 2)) for x, y in zip(pa.buckets, pb.buckets)
    )))
    # sigma_max of the raw instances (not normalized here)
    sig = float(np.sqrt(max(float(ra.sigma_sq), float(rb.sigma_sq))))
    dlam = float(torch.linalg.vector_norm(ra.lam - rb.lam))
    # the A^T(dlam) term also carries the dA perturbation; grant 10% slack
    bound = drift_bound(gamma, dc_norm=dc * 1.5, dlam_norm=dlam, sigma_max=sig)
    assert drift <= bound * 1.1, (drift, bound)


def test_larger_gamma_less_drift():
    a, b = _perturbed_pair()
    pa, pb = _cpu(a), _cpu(b)
    drifts = {}
    for gamma in (0.05, 1.0):
        cfg = MaximizerConfig(gammas=(gamma,), iters_per_stage=300)
        ra = Maximizer(MatchingObjective(pa), cfg).solve()
        rb = Maximizer(MatchingObjective(pb), cfg).solve(lam0=ra.lam)
        drifts[gamma] = float(primal_drift(ra.x_slabs, rb.x_slabs))
    assert drifts[1.0] <= drifts[0.05] + 1e-6, drifts


def test_recurring_solver_reports_drift():
    a, b = _perturbed_pair()
    rs = RecurringSolver(MaximizerConfig(iters_per_stage=100))
    _, rep0 = rs.solve(_cpu(a))
    assert rep0 == {}
    _, rep1 = rs.solve(_cpu(b))
    assert rep1["drift_l2"] >= 0
    assert rep1["gamma_floor"] == 0.01


# -- a recurring run against the reference's -----------------------------------


def test_recurring_solver_matches_reference(jax_start_vector):
    """Two days, then a resized day: the same report keys and values as the
    reference's driver, lam within 1e-5 rel-L2 each day."""
    days_j = [*_perturbed_pair(generate=jax_generate, spec_cls=JaxSpec),
              _perturbed_pair(generate=jax_generate, spec_cls=JaxSpec, num_destinations=9)[0]]
    cfg = dict(iters_per_stage=25)
    rs, jrs = RecurringSolver(MaximizerConfig(**cfg)), JaxRecurringSolver(JaxConfig(**cfg))
    for day, inst_j in enumerate(days_j):
        packed_j = jax_bucketize(inst_j)
        res, rep = rs.solve(convert.instance_from_reference(packed_j, device="cpu"))
        jres, jrep = jrs.solve(packed_j)
        assert set(rep) == set(jrep), day
        for k, v in jrep.items():
            if isinstance(v, float):
                np.testing.assert_allclose(rep[k], v, rtol=1e-4, atol=1e-6)
            else:
                assert rep[k] == v
        assert _rel(res.lam.numpy(), jres.lam) <= 1e-5, day
    assert sorted(rep) == ["cold_start_reason"]
    assert rep["cold_start_reason"] == "dual_dim_drift"
