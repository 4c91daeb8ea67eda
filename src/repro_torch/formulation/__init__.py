"""Operator-centric formulation layer (port of `repro.formulation`).

Composable problem descriptions over one dual oracle:

    from repro_torch.formulation import Formulation, CappedSimplex

    comp = Formulation(feasible_sets=CappedSimplex(cap=0.5)).compile(packed)
    res = comp.solve(MaximizerConfig())              # unchanged Maximizer
    raw = AGD_ENGINE.raw_solve(comp.instance, lam0, cfg, normalize=False)

A `Formulation(feasible_sets, terms, couplings)` lowers via `.compile` onto
the existing oracle/kernels: feasible sets to `ProjectionMap`s
(`FeasibleSet.lower()`), terms to oracle scales, couplings to an rhs
transform — packaged as a `FormulationSpec` the `MatchingObjective` shim
resolves when the objective is built.  New constraint families need no
solve-loop changes; docs/formulation.md describes the catalog and the
lowering rules of the reference, which this package follows.
"""
from repro_torch.formulation.couplings import Coupling, PackedCoupling
from repro_torch.formulation.feasible import (
    Box,
    BudgetPacedBox,
    CappedSimplex,
    FairnessFloor,
    FeasibleSet,
    Simplex,
)
from repro_torch.formulation.formulation import (
    SCENARIOS,
    CompiledFormulation,
    Formulation,
    attach,
    budget_pacing_formulation,
    capacity_cap_formulation,
    fairness_floor_formulation,
    matching_formulation,
    scenario_formulation,
    strip,
)
from repro_torch.formulation.spec import FormulationSpec, LoweredFormulation, lower_spec
from repro_torch.formulation.terms import LinearCost, RidgeSmoothing, Term

__all__ = [
    "Coupling",
    "PackedCoupling",
    "Box",
    "BudgetPacedBox",
    "CappedSimplex",
    "FairnessFloor",
    "FeasibleSet",
    "Simplex",
    "SCENARIOS",
    "CompiledFormulation",
    "Formulation",
    "attach",
    "budget_pacing_formulation",
    "capacity_cap_formulation",
    "fairness_floor_formulation",
    "matching_formulation",
    "scenario_formulation",
    "strip",
    "FormulationSpec",
    "LoweredFormulation",
    "lower_spec",
    "LinearCost",
    "RidgeSmoothing",
    "Term",
]
