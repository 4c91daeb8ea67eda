"""Port parity: power iteration, the AGD Maximizer and the solve CLI, against the JAX package.

With the port's start vector replaced by the reference's, the power
iteration matches within 1e-5 rel, and a full continuation solve matches
stage by stage: g traces within 1e-5 rel and lam within 1e-5 rel-L2 (the
reference's own trajectory bound, tests/test_dual_oracle.py), with identical
`iters_used` when early stopping is on.  With each package's own start
vector the sigma^2 estimates differ, so only the final g is compared,
within 1e-3 rel.
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
from repro.instances import MatchingInstanceSpec as JaxSpec
from repro.instances import bucketize as jax_bucketize
from repro.instances import generate_matching_instance as jax_generate
from repro_torch import convert
from repro_torch.core import Maximizer, MaximizerConfig, MatchingObjective
from repro_torch.core import objective as tobj
from repro_torch.launch import solve as tsolve


@pytest.fixture(scope="module")
def instances():
    spec = JaxSpec(num_sources=300, num_destinations=40, avg_degree=5.0,
                   num_families=2, seed=7)
    pj, _ = jax_normalize_rows(jax_bucketize(jax_generate(spec)))
    return pj, convert.instance_from_reference(pj, device="cpu")


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


def test_power_iteration_matches(instances, jax_start_vector):
    pj, pt = instances
    want = jax.jit(lambda k: JaxObjective(pj).power_iteration(k, 30))(
        jax.random.key(0)
    )
    got = MatchingObjective(pt).power_iteration(0, iters=30)
    assert _rel(float(got), float(want)) <= 1e-5


@pytest.mark.parametrize("fused", [False, True])
def test_solve_matches_reference(instances, jax_start_vector, fused):
    pj, pt = instances
    cfg = dict(iters_per_stage=25)
    want = JaxMaximizer(JaxObjective(pj), JaxConfig(**cfg)).solve()
    got = Maximizer(
        MatchingObjective(pt, fused_oracle=fused), MaximizerConfig(**cfg)
    ).solve()
    assert _rel(float(got.sigma_sq), float(want.sigma_sq)) <= 1e-5
    for st_t, st_j in zip(got.stats, want.stats):
        tr_t, tr_j = st_t.g.numpy(), np.asarray(st_j.g)
        assert tr_t.shape == tr_j.shape
        dev = np.max(np.abs(tr_t - tr_j) / (np.abs(tr_j) + 1e-9))
        assert dev <= 1e-5, dev
    assert _rel(got.lam.numpy(), want.lam) <= 1e-5
    assert _rel(float(got.g), float(want.g)) <= 1e-5
    np.testing.assert_allclose(got.steps, want.steps, rtol=1e-5)


def test_early_stop_iters_match_reference(instances, jax_start_vector):
    pj, pt = instances
    # the first four stages: past gamma = 1 a stage cut short leaves the
    # later, stiffer stages to amplify fp32 reduction-order noise in lam
    cfg = dict(gammas=(1e3, 1e2, 10.0, 1.0), iters_per_stage=60,
               tol_grad=0.2, tol_viol=0.05, check_every=10)
    want = JaxMaximizer(JaxObjective(pj), JaxConfig(**cfg)).solve()
    got = Maximizer(
        MatchingObjective(pt, fused_oracle=True), MaximizerConfig(**cfg)
    ).solve()
    assert got.iters_used == want.iters_used
    assert min(got.iters_used) < 60  # the criterion fired somewhere
    for st_t, st_j in zip(got.stats, want.stats):
        np.testing.assert_allclose(
            st_t.g.numpy(), np.asarray(st_j.g), rtol=1e-5, atol=1e-6
        )
    assert _rel(got.lam.numpy(), want.lam) <= 1e-5


def test_solve_with_own_start_vector(instances):
    pj, pt = instances
    want = JaxMaximizer(JaxObjective(pj), JaxConfig(iters_per_stage=25)).solve()
    got = Maximizer(
        MatchingObjective(pt, fused_oracle=True), MaximizerConfig(iters_per_stage=25)
    ).solve()
    assert _rel(float(got.g), float(want.g)) <= 1e-3


def test_cli_runs_on_cpu(capsys):
    assert tsolve.main([
        "--sources", "300", "--destinations", "20", "--iters-per-stage", "10",
        "--fused-oracle", "--device", "cpu",
    ]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("generated ") and "slab_dtype=float32" in out[0]
    assert "60/60 iters, engine=agd" in out[1]
    g = float(out[2].split()[2])
    assert np.isfinite(g)


@pytest.mark.parametrize(
    "flags",
    [["--formulation", "fairness-floor"], ["--engine", "pdhg"],
     ["--formulation", "budget-pacing"], ["--formulation", "capacity-cap"]],
)
def test_cli_refuses_unported_options(capsys, flags):
    with pytest.raises(SystemExit) as exc:
        tsolve.main(["--device", "cpu", "--sources", "50", *flags])
    assert exc.value.code != 0
    assert "not ported yet" in capsys.readouterr().err
