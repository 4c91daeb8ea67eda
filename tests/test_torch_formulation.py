"""Port parity: the formulation layer against the JAX package.

Each preset compiles in both packages to the same spec (feasible sets,
term scales, name), the same lowered projections and the same rhs; the
feasible sets' `contains()` agree on the same points; `primal_objective`
is the oracle's decomposition (tests/test_objective.py's rtol 1e-5) and the
reference's value; a short `CompiledFormulation.solve` of each preset ends
at the JAX solve's g within rtol 1e-5 and lam within 1e-5 rel-L2 (the port
draws the reference's start vector, as tests/test_torch_solve.py does);
`lower_spec`'s lowering table and the validation errors are the reference's
(tests/test_formulation.py:301, :309); the fused paths refuse non-simplex
and non-unit-scale formulations (:335); and `formulation_from_reference`
rebuilds every preset's spec.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

import repro.formulation as jform
from repro.core import MaximizerConfig as JaxConfig
from repro.core.objective import MatchingObjective as JaxObjective
from repro.core.objective import normalize_rows as jax_normalize_rows
from repro.instances import MatchingInstanceSpec as JaxSpec
from repro.instances import bucketize as jax_bucketize
from repro.instances import generate_matching_instance as jax_generate
from repro_torch import convert
from repro_torch import formulation as tform
from repro_torch.core import MatchingObjective, MaximizerConfig, normalize_rows
from repro_torch.core import objective as tobj
from repro_torch.core.projections import BoxCutProjection, UnitSimplexProjection
from repro_torch.core.sharding import shard_instance

PRESETS = ["matching", "capacity-cap", "fairness-floor", "budget-pacing"]


def _scaled(seed=7, I=400, J=23, m=2):
    """tests/test_formulation.py's instance, in both packages."""
    spec = JaxSpec(num_sources=I, num_destinations=J, avg_degree=4.0, num_families=m,
                   seed=seed)
    pj, _ = jax_normalize_rows(jax_bucketize(jax_generate(spec)))
    return pj, convert.instance_from_reference(pj, device="cpu")


@pytest.fixture(scope="module")
def scaled():
    return _scaled()


@pytest.fixture
def jax_start_vector(monkeypatch):
    def start_vector(n, seed, device):
        u0 = jax.random.normal(jax.random.key(seed), (n,), jnp.float32)
        return torch.from_numpy(np.array(u0)).to(device)

    monkeypatch.setattr(tobj, "start_vector", start_vector)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _fields(obj):
    return type(obj).__name__, dataclasses.asdict(obj)


def _alike(port, ref) -> bool:
    """Same class name and the same value in every field the port has (the
    reference's projections also carry a Pallas `interpret` flag)."""
    return (type(port).__name__ == type(ref).__name__ and all(
        getattr(ref, f.name) == getattr(port, f.name) for f in dataclasses.fields(port)))


# -- compile ---------------------------------------------------------------------


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_compile_alike(scaled, preset):
    pj, pt = scaled
    cj = jform.scenario_formulation(preset).compile(pj)
    ct = tform.scenario_formulation(preset).compile(pt)
    assert ct.spec.name == cj.spec.name
    assert (ct.spec.cost_scale, ct.spec.ridge_weight) == (cj.spec.cost_scale,
                                                          cj.spec.ridge_weight)
    assert [_fields(s) for s in ct.spec.feasible] == [_fields(s) for s in cj.spec.feasible]
    assert all(_alike(p, q) for p, q in zip(ct.projections, cj.projections))
    assert len(ct.projections) == len(pt.buckets)
    np.testing.assert_array_equal(ct.instance.rhs.numpy(), np.asarray(cj.instance.rhs))
    obj_t, obj_j = ct.objective(), cj.objective()
    assert (obj_t.cost_scale, obj_t.ridge_weight) == (obj_j.cost_scale, obj_j.ridge_weight)
    assert _alike(obj_t.projection, obj_j.projection)
    assert ct.sharded_instance().formulation is None
    assert _alike(ct.projection, cj.projection)


@pytest.mark.parametrize("preset", PRESETS)
def test_formulation_from_reference_round_trips(scaled, preset):
    pj, pt = scaled
    cj = jform.scenario_formulation(preset, 0.3).compile(pj)
    ct = tform.scenario_formulation(preset, 0.3).compile(pt)
    assert convert.formulation_from_reference(cj.spec) == ct.spec
    carried = convert.instance_from_reference(cj.instance, device="cpu")
    assert carried.formulation == ct.spec
    assert torch.equal(carried.rhs, ct.instance.rhs)


def test_scaled_terms_compile_alike(scaled):
    pj, pt = scaled
    kw = lambda f: dict(feasible_sets=f.CappedSimplex(cap=0.4),  # noqa: E731
                        terms=(f.LinearCost(scale=2.0), f.RidgeSmoothing(weight=0.5)),
                        couplings=(f.PackedCoupling(rhs_scale=0.8),), name="mixed")
    cj = jform.Formulation(**kw(jform)).compile(pj)
    ct = tform.Formulation(**kw(tform)).compile(pt)
    assert convert.formulation_from_reference(cj.spec) == ct.spec
    np.testing.assert_array_equal(ct.instance.rhs.numpy(), np.asarray(cj.instance.rhs))


# -- feasible sets -----------------------------------------------------------------

SETS = [
    ("Box", dict(lo=0.0, hi=0.6)),
    ("Simplex", dict(radius=1.0)),
    ("Simplex", dict(radius=2.0, inequality=False)),
    ("CappedSimplex", dict(cap=0.4)),
    ("FairnessFloor", dict(floor=0.05, hi=0.8)),
    ("BudgetPacedBox", dict(pace=0.3, budget=1.5)),
]


@pytest.mark.parametrize("name,kw", SETS)
def test_contains_agrees(name, kw):
    rng = np.random.default_rng(11)
    set_t, set_j = getattr(tform, name)(**kw), getattr(jform, name)(**kw)
    mask = (rng.random((64, 8)) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    got, want = [], []
    for trial in range(24):
        w = rng.random((64, 8)).astype(np.float32) * rng.choice([0.05, 0.3, 1.0, 3.0])
        if trial % 3 == 0:  # projected points: inside the set
            w = set_t.lower()(torch.from_numpy(w), torch.from_numpy(mask)).numpy()
        w = w * mask
        if trial % 4 == 1:
            w[0, -1] = 0.5  # a value on a pad slot (or a real slot)
        got.append(set_t.contains(torch.from_numpy(w), torch.from_numpy(mask)))
        want.append(set_j.contains(w, mask))
    assert got == want
    assert any(want) and not all(want)


def test_lowering_table():
    assert tform.Simplex().lower() == UnitSimplexProjection()
    assert tform.CappedSimplex(cap=0.4).lower() == BoxCutProjection(lo=0.0, hi=0.4, radius=1.0)
    assert isinstance(tform.FairnessFloor(floor=0.02).lower(), BoxCutProjection)
    for name, kw in SETS:
        assert _alike(getattr(tform, name)(**kw).lower(), getattr(jform, name)(**kw).lower())


def test_validation_errors():
    _, pt = _scaled(seed=16, I=40, J=5, m=1)
    bad_count = len(pt.buckets) + 2  # never 1 (shared) nor per-bucket
    with pytest.raises(ValueError, match="feasible sets"):
        tform.lower_spec(tform.FormulationSpec(feasible=(tform.Simplex(),) * bad_count), pt)
    with pytest.raises(ValueError):
        tform.Formulation(terms=(tform.LinearCost(), tform.LinearCost())).compile(pt)
    with pytest.raises(ValueError):
        tform.Formulation(terms=(tform.RidgeSmoothing(weight=0.0),)).compile(pt)
    with pytest.raises(ValueError):
        tform.Formulation(couplings=()).compile(pt)
    with pytest.raises(ValueError):
        tform.Formulation(couplings=(tform.PackedCoupling(sense="ge"),)).compile(pt)
    with pytest.raises(ValueError):
        tform.Formulation(couplings=(tform.PackedCoupling(families=3),)).compile(pt)
    with pytest.raises(ValueError):
        tform.scenario_formulation("nope")
    with pytest.raises(ValueError):
        tform.CappedSimplex(cap=-0.1).validate()
    with pytest.raises(ValueError):
        tform.Box(lo=1.0, hi=0.0).validate()
    with pytest.raises(ValueError):
        tform.FairnessFloor(floor=0.5, radius=0.1).validate()
    with pytest.raises(ValueError):
        tform.Formulation(
            feasible_sets=(tform.Simplex(), tform.CappedSimplex())).shared_projection()


def test_per_bucket_sets_lower_per_bucket():
    _, pt = _scaled(seed=16, I=40, J=5, m=1)
    sets = tuple(tform.CappedSimplex(cap=0.2 + 0.1 * i) for i in range(len(pt.buckets)))
    comp = tform.Formulation(feasible_sets=sets, name="per_bucket").compile(pt)
    obj = comp.objective()
    assert [obj._proj(i) for i in range(len(sets))] == [s.lower() for s in sets]
    with pytest.raises(ValueError, match="per-bucket"):
        comp.projection
    x = obj.calculate(torch.zeros(obj.dual_dim), 1.0).x_slabs
    for s, xs in zip(sets, x):
        assert float(xs.max()) <= s.cap + 1e-6


def test_fused_paths_reject_non_simplex_formulations():
    _, pt = _scaled(seed=17, I=40, J=5, m=1)
    comp = tform.capacity_cap_formulation(cap=0.5).compile(pt)
    for kw in (dict(fused_oracle=True), dict(fused_kernel=True)):
        obj = comp.objective(**kw)
        with pytest.raises(ValueError, match="simplex"):
            obj.calculate(torch.zeros(obj.dual_dim), 1.0)
    scaled_terms = tform.Formulation(terms=(tform.LinearCost(scale=2.0),)).compile(pt)
    obj = scaled_terms.objective(fused_oracle=True)
    with pytest.raises(ValueError, match="unit term scales"):
        obj.calculate(torch.zeros(obj.dual_dim), 1.0)


# -- the objective -----------------------------------------------------------------


@pytest.mark.parametrize("gamma", [0.05, 1.0])
def test_primal_objective_matches_decomposition(scaled, gamma):
    pj, pt = scaled
    lam = np.random.default_rng(2).random(pt.dual_dim).astype(np.float32)
    for form_t, form_j in ((None, None),
                           (tform.Formulation(terms=(tform.LinearCost(scale=2.0),
                                                     tform.RidgeSmoothing(weight=0.5))),
                            jform.Formulation(terms=(jform.LinearCost(scale=2.0),
                                                     jform.RidgeSmoothing(weight=0.5))))):
        obj = MatchingObjective(pt) if form_t is None else form_t.compile(pt).objective()
        objj = JaxObjective(pj) if form_j is None else form_j.compile(pj).objective()
        ev = obj.calculate(torch.from_numpy(lam), gamma)
        got = float(obj.primal_objective(ev.x_slabs, gamma))
        np.testing.assert_allclose(got, float(ev.primal_linear) + float(ev.primal_ridge),
                                   rtol=1e-5)
        want = objj.primal_objective(tuple(jnp.asarray(x.numpy()) for x in ev.x_slabs),
                                     gamma)
        np.testing.assert_allclose(got, float(want), rtol=1e-5)


def test_scaled_terms_match_the_reference_oracle(scaled):
    pj, pt = scaled
    kw = lambda f: dict(terms=(f.LinearCost(scale=2.0), f.RidgeSmoothing(weight=0.5)))  # noqa: E731
    obj = tform.Formulation(**kw(tform)).compile(pt).objective()
    objj = jform.Formulation(**kw(jform)).compile(pj).objective()
    lam = np.random.default_rng(0).random(pt.dual_dim).astype(np.float32)
    ev, evj = obj.calculate(torch.from_numpy(lam), 1.0), objj.calculate(jnp.asarray(lam), 1.0)
    assert _rel(ev.grad.numpy(), evj.grad) <= 1e-6
    np.testing.assert_allclose(float(ev.g), float(evj.g), rtol=1e-5)


def test_matching_primitives_are_bitwise_legacy():
    _, pt = _scaled(seed=3)
    cfg = MaximizerConfig(iters_per_stage=20)
    from repro_torch.core import Maximizer

    legacy = Maximizer(MatchingObjective(pt), cfg).solve()
    prim = tform.matching_formulation().compile(pt).solve(cfg)
    assert torch.equal(prim.lam, legacy.lam)


def test_rhs_scale_coupling_lowered_once():
    _, pt = _scaled(seed=9, I=60, J=7, m=1)
    comp = tform.capacity_cap_formulation(cap=0.9, rhs_scale=0.5).compile(pt)
    np.testing.assert_allclose(comp.instance.rhs.numpy(), 0.5 * pt.rhs.numpy(), rtol=1e-6)
    obj = comp.objective()
    ev = obj.calculate(torch.zeros(obj.dual_dim), 1.0)
    np.testing.assert_allclose(ev.grad.numpy(), ev.ax.numpy() - 0.5 * pt.rhs.numpy(),
                               atol=1e-6)


def test_spec_rides_through_normalize_and_sharding():
    _, pt = _scaled(seed=0, I=50, J=5, m=1)
    comp = tform.capacity_cap_formulation(cap=0.3).compile(pt)
    assert normalize_rows(comp.instance)[0].formulation == comp.spec
    assert tobj.normalize_rows_traced(comp.instance)[0].formulation == comp.spec
    assert shard_instance(comp.instance, 0, 1).formulation == comp.spec
    assert tform.strip(comp.instance).formulation is None
    assert tform.attach(pt, comp.spec).formulation == comp.spec


# -- solves ------------------------------------------------------------------------


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_solve_matches_reference(scaled, jax_start_vector, preset):
    pj, pt = scaled
    cfg = dict(iters_per_stage=20)
    want = jform.scenario_formulation(preset).compile(pj).solve(JaxConfig(**cfg))
    got = tform.scenario_formulation(preset).compile(pt).solve(MaximizerConfig(**cfg))
    np.testing.assert_allclose(float(got.g), float(want.g), rtol=1e-5)
    assert _rel(got.lam.numpy(), want.lam) <= 1e-5
    for x, b in zip(got.x_slabs, pt.buckets):
        pad = b.mask == 0
        assert float(x[pad].abs().sum()) == 0.0


def test_scenarios_hold_their_constraints(scaled):
    """tests/test_formulation.py's end-to-end checks of the three scenarios
    (a fairness floor cannot keep the row sum of a row with more than
    radius / floor edges, so only its floor is held, as there)."""
    _, pt = scaled
    cfg = MaximizerConfig(iters_per_stage=20)
    cap = tform.capacity_cap_formulation(cap=0.4).compile(pt).solve(cfg)
    floor = tform.fairness_floor_formulation(floor=0.05).compile(pt).solve(cfg)
    pace = tform.budget_pacing_formulation(pace=0.3, budget=1.5).compile(pt).solve(cfg)
    for b, xc, xf, xp in zip(pt.buckets, cap.x_slabs, floor.x_slabs, pace.x_slabs):
        real, pad = b.mask > 0, b.mask == 0
        assert float(xc.max()) <= 0.4 + 1e-5 and float(xc.min()) >= -1e-6
        assert float((xc * b.mask).sum(-1).max()) <= 1.0 + 1e-4
        if bool(real.any()):
            assert float(xf[real].min()) >= 0.05 - 1e-5
        assert float(xf[pad].abs().sum()) == 0.0
        assert float(xp.max()) <= 0.3 + 1e-5
        assert float((xp * b.mask).sum(-1).max()) <= 1.5 + 1e-4
