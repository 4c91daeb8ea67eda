"""Formulation — composable problem descriptions over one dual oracle (port of
`repro.formulation.formulation`).

A `Formulation(feasible_sets, terms, couplings)` is a declarative
composition, and `.compile(instance)` lowers it onto the existing
oracle/kernel stack —

    feasible sets -> per-bucket ProjectionMap          (FeasibleSet.lower)
    terms         -> (cost_scale, ridge_weight) scalars (terms.resolve_terms)
    couplings     -> a one-time rhs transform           (couplings.resolve_couplings)

— packaged as a `FormulationSpec` attached to the instance.  From there the
`Maximizer`, the `DistributedMaximizer` and the engines dispatch it
unchanged through the `MatchingObjective` shim.

The compile opens a `formulation_compile` span and bumps the reference's
counters (`repro_torch.telemetry`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import torch

from repro_torch import telemetry
from repro_torch.core.maximizer import Maximizer, MaximizerConfig, SolveResult
from repro_torch.core.objective import MatchingObjective
from repro_torch.core.projections import ProjectionMap
from repro_torch.formulation.couplings import Coupling, PackedCoupling, resolve_couplings
from repro_torch.formulation.feasible import (
    BudgetPacedBox,
    CappedSimplex,
    FairnessFloor,
    FeasibleSet,
    Simplex,
)
from repro_torch.formulation.spec import FormulationSpec, lower_spec
from repro_torch.formulation.terms import LinearCost, RidgeSmoothing, Term, resolve_terms
from repro_torch.instances.buckets import BucketedInstance

__all__ = [
    "Formulation",
    "CompiledFormulation",
    "attach",
    "strip",
    "matching_formulation",
    "capacity_cap_formulation",
    "fairness_floor_formulation",
    "budget_pacing_formulation",
    "scenario_formulation",
    "SCENARIOS",
]


def attach(
    instance: BucketedInstance, spec: FormulationSpec
) -> BucketedInstance:
    """Return the instance carrying `spec` as its static formulation field."""
    return dataclasses.replace(instance, formulation=spec)


def strip(instance: BucketedInstance) -> BucketedInstance:
    """Drop the formulation spec."""
    if getattr(instance, "formulation", None) is None:
        return instance
    return dataclasses.replace(instance, formulation=None)


@dataclasses.dataclass(frozen=True)
class Formulation:
    """Declarative composition of feasible sets, objective terms, couplings.

    `feasible_sets` is one shared `FeasibleSet` or a per-bucket tuple.
    Defaults reproduce the ridge-regularized matching formulation exactly.
    """

    feasible_sets: Union[FeasibleSet, tuple[FeasibleSet, ...]] = Simplex()
    terms: tuple[Term, ...] = (LinearCost(), RidgeSmoothing())
    couplings: tuple[Coupling, ...] = (PackedCoupling(),)
    name: str = "matching"

    @property
    def feasible_tuple(self) -> tuple[FeasibleSet, ...]:
        fs = self.feasible_sets
        return (fs,) if isinstance(fs, FeasibleSet) else tuple(fs)

    def shared_projection(self) -> ProjectionMap:
        """Lower the (shared) feasible set without an instance — for callers
        like `DistributedMaximizer(projection=...)`."""
        sets = self.feasible_tuple
        if len(set(sets)) != 1:
            raise ValueError(
                f"formulation {self.name!r} has per-bucket feasible sets; "
                "compile against an instance to lower them"
            )
        sets[0].validate()
        return sets[0].lower()

    def compile(self, instance: BucketedInstance) -> "CompiledFormulation":
        """Lower the composition onto `instance` (span and counters emitted).

        Returns a `CompiledFormulation` whose `.instance` carries the spec —
        ready for `Maximizer`, the engines, and (spec-stripped, projection
        passed explicitly) the sharded solve.
        """
        reg = telemetry.get_registry()
        t0 = time.perf_counter()
        with telemetry.span(
            "formulation_compile",
            formulation=self.name,
            primitives=len(self.feasible_tuple),
        ):
            sets = self.feasible_tuple
            if not sets:
                raise ValueError("a Formulation needs at least one FeasibleSet")
            for s in sets:
                s.validate()
            cost_scale, ridge_weight = resolve_terms(self.terms)
            rhs_scale = resolve_couplings(self.couplings, instance)
            spec = FormulationSpec(
                feasible=sets,
                cost_scale=cost_scale,
                ridge_weight=ridge_weight,
                name=self.name,
            )
            # validates set-count vs bucket-count and that every set lowers
            lowered = lower_spec(spec, instance)
            rhs = instance.rhs if rhs_scale == 1.0 else instance.rhs * rhs_scale
            compiled_inst = dataclasses.replace(instance, rhs=rhs, formulation=spec)
        dt = time.perf_counter() - t0
        reg.inc("formulation_compiles_total", 1, formulation=self.name)
        reg.inc("formulation_primitives_total", len(sets), formulation=self.name)
        reg.observe("formulation_compile_seconds", dt, formulation=self.name)
        return CompiledFormulation(
            formulation=self,
            spec=spec,
            instance=compiled_inst,
            projections=lowered.projections,
        )


@dataclasses.dataclass(frozen=True, eq=False)
class CompiledFormulation:
    """A formulation lowered against one packed instance.

    * `instance` — spec-carrying `BucketedInstance`; hand it to the engines
      (`repro_torch.engines`) or to `objective()` below.
    * `projections` — the lowered per-bucket `ProjectionMap`s (the
      sharded solve takes the shared one via `projection=`).
    """

    formulation: Formulation
    spec: FormulationSpec
    instance: BucketedInstance
    projections: tuple[ProjectionMap, ...]

    @property
    def projection(self) -> ProjectionMap:
        """The shared projection (raises if the buckets differ)."""
        if len(set(self.projections)) != 1:
            raise ValueError(
                f"formulation {self.spec.name!r} lowers per-bucket "
                "projections; use .projections"
            )
        return self.projections[0]

    def sharded_instance(self) -> BucketedInstance:
        """Spec-stripped instance for `DistributedMaximizer` (pass
        `projection=self.projection` alongside), as the reference has it."""
        return strip(self.instance)

    def objective(self, **objective_kwargs) -> MatchingObjective:
        """The dual oracle for this compiled formulation (the shim resolves
        the attached spec; kwargs = fused_kernel/fused_oracle/include_rhs/...)."""
        return MatchingObjective(self.instance, **objective_kwargs)

    def solve(
        self,
        config: MaximizerConfig = MaximizerConfig(),
        lam0: Optional[torch.Tensor] = None,
        **objective_kwargs,
    ) -> SolveResult:
        """One-shot solve through the unchanged Maximizer."""
        return Maximizer(self.objective(**objective_kwargs), config).solve(lam0)


# ---------------------------------------------------------------------------
# Scenario presets — each new workload is a composition, not a solver change.
# ---------------------------------------------------------------------------


def matching_formulation(radius: float = 1.0) -> Formulation:
    """The paper's ridge-regularized matching LP, expressed as primitives.

    Compiling this against an instance reproduces the legacy
    `MatchingObjective` bit-for-bit (same projection, unit term scales,
    untouched rhs).
    """
    return Formulation(feasible_sets=Simplex(radius), name="matching")


def capacity_cap_formulation(
    cap: float = 0.5, radius: float = 1.0, rhs_scale: float = 1.0
) -> Formulation:
    """Capacity caps: no destination takes more than `cap` of a source's
    unit allocation; optional fleet-wide rhs tightening."""
    return Formulation(
        feasible_sets=CappedSimplex(cap=cap, radius=radius),
        couplings=(PackedCoupling(rhs_scale=rhs_scale),),
        name="capacity_cap",
    )


def fairness_floor_formulation(
    floor: float = 0.02, hi: float = 1.0, radius: float = 1.0
) -> Formulation:
    """Fairness floors: every eligible edge gets at least `floor` allocation."""
    return Formulation(
        feasible_sets=FairnessFloor(floor=floor, hi=hi, radius=radius),
        name="fairness_floor",
    )


def budget_pacing_formulation(
    pace: float = 0.25, budget: float = 2.0
) -> Formulation:
    """Budget pacing (box + cut): per-edge spend rate `pace`, row budget."""
    return Formulation(
        feasible_sets=BudgetPacedBox(pace=pace, budget=budget),
        name="budget_pacing",
    )


SCENARIOS = {
    "matching": matching_formulation,
    "capacity-cap": capacity_cap_formulation,
    "fairness-floor": fairness_floor_formulation,
    "budget-pacing": budget_pacing_formulation,
}


def scenario_formulation(
    name: str, param: Optional[float] = None
) -> Formulation:
    """Build a preset scenario by CLI name; `param` overrides the primary
    knob (cap / floor / pace) when given."""
    try:
        builder = SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown formulation scenario {name!r}; "
            f"choose from {sorted(SCENARIOS)}"
        ) from None
    return builder(param) if param is not None else builder()
