"""Port parity: the multi-tenant service (`service.pool`, `session`,
`scheduler`, the batched half of `engine`) against the JAX package.

The reference tests' instance (120 sources x 10 destinations, degree 4,
`row_headroom=4`), seeded numpy deltas given to both packages.

  * The port's batched pool against the JAX vmapped pool, lane by lane:
    fused oracle, unfused, and the fixed-sigma variant, with the reference's
    power-iteration start vector: the same per-lane `iters_used`, lam within
    1e-5 rel-L2 (the bound `tests/test_torch_deltas.py` holds the
    single-tenant cadence to).  The stops are decisive there (tolerances
    1e-2, checks every 10 iterations), and the lanes stop at different
    chunks, so a converged lane's freezing is what is compared.  At the
    reference tests' tolerances (1e-4, checks every 25) the stop test sits
    on a knife edge for this instance: the reference's own vmapped pool and
    its solo solves disagree on the iterations of 2 to 4 of the 4 lanes,
    and the port's on 2 (ROADMAP, Queue 3).
  * The batched pool against the port's own sequential solves, at the
    reference's bounds (`tests/test_service.py`: 1e-3 rel g, 5e-2 lam atol);
    on the CPU each lane is in fact bitwise its solo solve.
  * `stack_instances` refuses mismatched shapes.

The scheduler, the pipelined cadences and sigma reuse are held in
`tests/test_torch_scheduler.py`.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro import service as jsvc
from repro import telemetry as jtel
from repro.core import MaximizerConfig as JaxConfig
from repro.instances import DeltaIngestor as JaxIngestor
from repro.instances import InstanceDelta as JaxDelta
from repro.instances import MatchingInstanceSpec as JaxSpec
from repro.instances import generate_matching_instance as jax_generate
from repro_torch import telemetry
from repro_torch.core import MaximizerConfig
from repro_torch.core import objective as tobj
from repro_torch.instances import (
    DeltaIngestor,
    InstanceDelta,
    MatchingInstanceSpec,
    bucketize,
    generate_matching_instance,
)
from repro_torch.service import (
    BatchedSolvePool,
    ServiceConfig,
    compile_cache_report,
    compiled_solver,
    device_put_instance,
    shape_signature,
    stack_instances,
    to_solve_result,
)

SPEC = dict(num_sources=120, num_destinations=10, avg_degree=4.0, seed=21)
BASE = generate_matching_instance(MatchingInstanceSpec(**SPEC))
BASE_J = jax_generate(JaxSpec(**SPEC))
COLD = dict(iters_per_stage=120, tol_grad=1e-4, tol_viol=1e-4)
# early stops that fire decisively on this instance (see the docstring)
DECISIVE = dict(iters_per_stage=100, tol_grad=1e-2, tol_viol=1e-2, check_every=10,
                gammas=(1e2, 10.0, 1.0, 0.1))
SERVICE = dict(warm_gammas=(0.1, 0.01), drift_sla_rel=0.5, row_headroom=4)


def _service(cold=COLD, **kw):
    return ServiceConfig(cold=MaximizerConfig(**cold), **{**SERVICE, **kw})


def _jax_service(cold=COLD, **kw):
    return jsvc.ServiceConfig(cold=JaxConfig(**cold), **{**SERVICE, **kw})


@pytest.fixture(autouse=True)
def fresh_telemetry():
    prev = (telemetry.set_registry(telemetry.MetricsRegistry()),
            jtel.set_registry(jtel.MetricsRegistry()))
    yield
    telemetry.set_registry(prev[0])
    jtel.set_registry(prev[1])


@pytest.fixture
def jax_start_vector(monkeypatch):
    """Make the port draw the reference's power-iteration start vector."""
    def start_vector(n, seed, device):
        u0 = jax.random.normal(jax.random.key(seed), (n,), jnp.float32)
        return torch.from_numpy(np.array(u0)).to(device)

    monkeypatch.setattr(tobj, "start_vector", start_vector)


def _perturb(edge_list, rng, frac=0.1):
    """The reference tests' cost-update delta, as numpy arrays."""
    n = max(1, int(frac * edge_list.nnz))
    idx = rng.permutation(edge_list.nnz)[:n]
    return dict(update_src=edge_list.src[idx], update_dst=edge_list.dst[idx],
                update_values=edge_list.values[idx] * rng.uniform(0.9, 1.1, n))


def _tenants(n=4):
    """The reference's `_tenant_instances`: n ingestors of BASE, each after
    one seeded cost delta; the port's and the reference's, side by side."""
    rng = np.random.default_rng(7)
    out, out_j = [], []
    for _ in range(n):
        d = _perturb(BASE_J, rng)
        ing, ing_j = DeltaIngestor(BASE, row_headroom=4), JaxIngestor(BASE_J, row_headroom=4)
        ing.apply(InstanceDelta(**d))
        ing_j.apply(JaxDelta(**d))
        out.append(device_put_instance(ing.instance(), "cpu"))
        out_j.append(jsvc.device_put_instance(ing_j.instance()))
    return out, out_j


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("variant", ["unfused", "fused", "fixed_sigma"])
def test_batched_pool_matches_reference_per_lane(jax_start_vector, variant):
    insts, insts_j = _tenants(4)
    fused = variant != "unfused"
    cfg = DECISIVE
    pool = BatchedSolvePool(MaximizerConfig(**cfg), normalize=True, fused_oracle=fused)
    pool_j = jsvc.BatchedSolvePool(JaxConfig(**cfg), normalize=True, fused_oracle=fused)
    lam0s = sigmas = lam0s_j = sigmas_j = None
    if variant == "fixed_sigma":  # warm lanes from a cold batch, each its own sigma
        first, first_j = pool.solve(insts), pool_j.solve(insts_j)
        lam0s, lam0s_j = [r.lam for r in first], [r.lam for r in first_j]
        sigmas, sigmas_j = ([float(r.sigma_sq) for r in first],
                            [float(r.sigma_sq) for r in first_j])
        for r, rj in zip(first, first_j):
            assert _rel(r.lam, rj.lam) <= 1e-5
    batch = pool.solve(insts, lam0s, sigmas)
    batch_j = pool_j.solve(insts_j, lam0s_j, sigmas_j)
    assert len({r.iters_used for r in batch}) > 1  # the lanes stop apart
    for b, (r, rj) in enumerate(zip(batch, batch_j)):
        assert r.iters_used == tuple(int(i) for i in rj.iters_used), b
        assert _rel(r.lam, rj.lam) <= 1e-5, b
        np.testing.assert_allclose(float(r.g), float(rj.g), rtol=1e-5)
        np.testing.assert_allclose(r.steps, rj.steps, rtol=1e-5)
        assert len(r.stats) == len(rj.stats)
        for st, sj in zip(r.stats, rj.stats):
            assert st.g.shape == np.asarray(sj.g).shape
    if variant == "fixed_sigma":
        assert [float(r.sigma_sq) for r in batch] == [np.float32(s) for s in sigmas]


@pytest.mark.parametrize("fused", [False, True])
def test_batched_pool_matches_sequential(fused):
    """The reference's bounds (tests/test_service.py); on the CPU every lane
    is bitwise its solo solve."""
    insts, _ = _tenants(3)
    assert len({shape_signature(i) for i in insts}) == 1
    cfg = MaximizerConfig(**COLD)
    batch = BatchedSolvePool(cfg, normalize=True, fused_oracle=fused).solve(insts)
    for inst, b in zip(insts, batch):
        s = to_solve_result(compiled_solver(cfg, True, fused)(inst, torch.zeros(inst.dual_dim)))
        rel = abs(float(b.g) - float(s.g)) / max(abs(float(s.g)), 1e-9)
        assert rel < 1e-3
        np.testing.assert_allclose(b.lam.numpy(), s.lam.numpy(), atol=5e-2)
        assert b.iters_used == s.iters_used
        assert torch.equal(b.lam, s.lam)
    report = compile_cache_report()
    assert any(k.startswith("batch:") and f"fused={fused}" in k for k in report)


def test_stack_instances_rejects_mismatched_shapes():
    insts, _ = _tenants(2)
    other = bucketize(generate_matching_instance(
        MatchingInstanceSpec(**{**SPEC, "seed": 33})), device="cpu")
    assert shape_signature(other) != shape_signature(insts[0])
    with pytest.raises(ValueError, match="shape signature"):
        stack_instances([insts[0], other])
    with pytest.raises(ValueError, match="empty"):
        stack_instances([])
