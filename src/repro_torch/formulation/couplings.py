"""Coupling constraints — the shared rows A x <= b tying sources together
(port of `repro.formulation.couplings`).

The packed `BucketedInstance` already materialises the coupling block as its
[m, J]-shaped rhs plus the per-bucket coefficient slabs; a `Coupling`
primitive therefore lowers to an *rhs transform* applied once at compile
time, never to solve-loop changes.  Today one kind is supported:

  PackedCoupling(families, sense="le", rhs_scale) — the instance's packed
  coupling family block, optionally tightened/loosened by scaling b
  (e.g. rhs_scale=0.8 reserves 20% capacity headroom fleet-wide).

The dual ascent maximises over lam >= 0, which encodes `A x <= b`; an "eq"
or "ge" sense would need a sign-free dual block, which the maximizer does
not implement — compile rejects it rather than silently mis-solving.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.instances.buckets import BucketedInstance

__all__ = ["Coupling", "PackedCoupling", "resolve_couplings"]


class Coupling:
    """Marker base for coupling primitives (frozen, hashable subclasses)."""


@dataclasses.dataclass(frozen=True)
class PackedCoupling(Coupling):
    name: str = "packed"
    # expected number of constraint families; None = accept the instance's
    families: Optional[int] = None
    sense: str = "le"  # only "le" lowers onto the lam >= 0 dual ascent
    rhs_scale: float = 1.0

    def validate(self, instance: BucketedInstance) -> None:
        if self.sense != "le":
            raise ValueError(
                f"coupling {self.name!r}: sense={self.sense!r} is not "
                "lowerable — the dual ascent over lam >= 0 encodes 'le' rows"
            )
        if self.rhs_scale <= 0:
            raise ValueError(
                f"coupling {self.name!r}: rhs_scale={self.rhs_scale} must be > 0"
            )
        if (
            self.families is not None
            and self.families != instance.num_families
        ):
            raise ValueError(
                f"coupling {self.name!r} declares {self.families} families "
                f"but the instance packs {instance.num_families}"
            )


def resolve_couplings(
    couplings: Sequence[Coupling], instance: BucketedInstance
) -> float:
    """Validate the composition against the packed instance; return the
    combined rhs scale (compile applies it to `instance.rhs` once)."""
    scale = 1.0
    seen_packed = False
    for c in couplings:
        if not isinstance(c, PackedCoupling):
            raise ValueError(
                f"unsupported coupling {c!r}: only PackedCoupling lowers "
                "onto the bucketed-ELL layout"
            )
        if seen_packed:
            raise ValueError(
                "duplicate PackedCoupling: the packed instance has one "
                "coupling block; scale its rhs instead of repeating it"
            )
        seen_packed = True
        c.validate(instance)
        scale *= c.rhs_scale
    if not seen_packed:
        raise ValueError(
            "a Formulation needs exactly one PackedCoupling describing the "
            "instance's A x <= b block"
        )
    return scale
