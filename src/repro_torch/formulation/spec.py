"""FormulationSpec — the compiled, instance-attachable formulation record
(port of `repro.formulation.spec`).

`Formulation.compile(instance)` lowers the declarative composition down to
this frozen, hashable spec and attaches it to `BucketedInstance.formulation`.
`MatchingObjective.__post_init__` reads it and resolves the per-bucket
projections and term scales through `lower_spec` below, which is the whole
dispatch mechanism: the maximizer, the sharded solve and the engines need no
change for a new formulation.

This module imports only the feasible-set catalog (never the objective), so
`core/objective.py` can import it lazily without a cycle.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Union

from repro_torch.core.projections import ProjectionMap
from repro_torch.formulation.feasible import FeasibleSet

__all__ = ["FormulationSpec", "LoweredFormulation", "lower_spec"]


@dataclasses.dataclass(frozen=True)
class FormulationSpec:
    """Static compile output: per-bucket feasible sets + lowered term scales.

    `feasible` holds either one shared set (applied to every bucket) or one
    set per bucket, in bucket order.  All fields are hashable, as in the
    reference, where the spec is a static pytree field.
    """

    feasible: tuple[FeasibleSet, ...]
    cost_scale: float = 1.0
    ridge_weight: float = 1.0
    name: str = "matching"


class LoweredFormulation(NamedTuple):
    projections: tuple[ProjectionMap, ...]  # one per bucket
    cost_scale: float
    ridge_weight: float
    name: str


def lower_spec(
    spec: FormulationSpec, instance=None, *, num_buckets: Union[int, None] = None
) -> LoweredFormulation:
    """Lower a spec to the per-bucket `ProjectionMap`s the oracle executes.

    `instance` (or `num_buckets`) fixes how a shared feasible set broadcasts;
    a per-bucket tuple must match the instance's bucket count exactly.
    """
    if num_buckets is None:
        num_buckets = len(instance.buckets) if instance is not None else None
    sets = spec.feasible
    if num_buckets is not None:
        if len(sets) == 1:
            sets = sets * num_buckets
        elif len(sets) != num_buckets:
            raise ValueError(
                f"formulation {spec.name!r} declares {len(spec.feasible)} "
                f"feasible sets for {num_buckets} buckets (give one shared "
                "set or exactly one per bucket)"
            )
    return LoweredFormulation(
        projections=tuple(s.lower() for s in sets),
        cost_scale=spec.cost_scale,
        ridge_weight=spec.ridge_weight,
        name=spec.name,
    )
