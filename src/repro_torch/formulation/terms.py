"""Objective terms — the composable pieces of the regularized objective
(port of `repro.formulation.terms`).

The smoothed dual oracle solves

    min_x  cost_scale * c'x  +  ridge_weight * (gamma/2) ||x||^2
    s.t.   A x <= b,  x_i in C_i,

so a term composition lowers to exactly two scalars: the linear-cost scale
and the ridge (smoothing) weight.  Both default to 1.0, reproducing the
legacy matching objective bit-for-bit; any other composition (a re-weighted
cost, a stronger smoother) still needs *zero* solve-loop changes because the
scales fold into the oracle's existing `z = -(A^T lam + c)/gamma` step.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

__all__ = ["Term", "LinearCost", "RidgeSmoothing", "resolve_terms"]


class Term:
    """Marker base for objective terms (frozen, hashable subclasses)."""


@dataclasses.dataclass(frozen=True)
class LinearCost(Term):
    """The linear objective `scale * c'x` over the instance's packed costs."""

    scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class RidgeSmoothing(Term):
    """The gamma-smoothing ridge `weight * (gamma/2) ||x||^2` (paper eq. 2).

    The weight multiplies every continuation stage's gamma; the schedule
    itself stays a `MaximizerConfig` concern.
    """

    weight: float = 1.0


def resolve_terms(terms: Sequence[Term]) -> tuple[float, float]:
    """Lower a term composition to `(cost_scale, ridge_weight)`.

    At most one term of each kind; an omitted kind keeps its default scale
    of 1.0 (the ridge is the solver's smoother, so it is always present —
    `RidgeSmoothing(weight=0)` is rejected because the oracle's closed-form
    primal step divides by gamma).
    """
    cost_scale: float | None = None
    ridge_weight: float | None = None
    for t in terms:
        if isinstance(t, LinearCost):
            if cost_scale is not None:
                raise ValueError("duplicate LinearCost term")
            cost_scale = float(t.scale)
        elif isinstance(t, RidgeSmoothing):
            if ridge_weight is not None:
                raise ValueError("duplicate RidgeSmoothing term")
            ridge_weight = float(t.weight)
        else:
            raise ValueError(
                f"unsupported term {t!r}: the oracle lowers LinearCost and "
                "RidgeSmoothing compositions"
            )
    if ridge_weight is not None and ridge_weight <= 0:
        raise ValueError(
            f"RidgeSmoothing weight must be > 0 (got {ridge_weight}): the "
            "closed-form primal step divides by the smoothed gamma"
        )
    return (
        1.0 if cost_scale is None else cost_scale,
        1.0 if ridge_weight is None else ridge_weight,
    )
