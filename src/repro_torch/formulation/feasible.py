"""FeasibleSet primitives — the operator-centric feasible-region catalog
(port of `repro.formulation.feasible`).

A `FeasibleSet` describes the per-source feasible polytope C_i declaratively;
`lower()` translates it to the `ProjectionMap` the dual oracle actually
executes (the port's `core/projections.py`; the reference's property suite,
tests/test_feasible_sets.py, covers idempotence, non-expansiveness and
membership of every set).

Catalog (paper Table 1 / DuaLip constraint families):

  Box(lo, hi)                elementwise bounds
  Simplex(radius)            {w >= 0, sum w <= radius} (or == with
                             inequality=False) — the matching feasible set
  CappedSimplex(cap, radius) capacity caps: {0 <= w <= cap, sum w <= radius}
  FairnessFloor(floor, hi,   minimum exposure per eligible edge:
                radius)      {floor <= w <= hi, sum w <= radius}
  BudgetPacedBox(pace,       budget pacing ("box + cut"):
                 budget)     {0 <= w <= pace, sum w <= budget}

All sets are frozen dataclasses — hashable, so they can ride inside the
`FormulationSpec` attached to a `BucketedInstance`.  `contains()` is the
host-side membership predicate (numpy arrays or tensors on any device); it
honours the padding convention (masked-out entries must be exactly zero and
are exempt from bounds).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.projections import (
    BoxCutProjection,
    BoxProjection,
    ProjectionMap,
    UnitSimplexProjection,
)

__all__ = [
    "FeasibleSet",
    "Box",
    "Simplex",
    "CappedSimplex",
    "FairnessFloor",
    "BudgetPacedBox",
]


class FeasibleSet:
    """Declarative per-source feasible region; `lower()` yields its projector.

    Subclasses implement:
      * `lower() -> ProjectionMap` — the executable projection operator
      * `contains(w, mask) -> bool` — host-side membership (property tests)
    New constraint families implement only this pair; the oracle, maximizer,
    sharding and service layers are reused unchanged (paper §5).
    """

    def lower(self) -> ProjectionMap:
        raise NotImplementedError

    def contains(self, w, mask, atol: float = 1e-4) -> bool:
        raise NotImplementedError

    def validate(self) -> None:
        """Raise ValueError on parameters that make the set empty/degenerate."""


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def _split(w, mask):
    w, mask = _host(w), _host(mask)
    return w, mask, w[mask > 0], w[mask <= 0]


def _pads_zero(pad: np.ndarray) -> bool:
    return bool(pad.size == 0 or np.all(pad == 0.0))


@dataclasses.dataclass(frozen=True)
class Box(FeasibleSet):
    """Elementwise bounds {lo <= w <= hi} on real entries."""

    lo: float = 0.0
    hi: float = 1.0

    def validate(self) -> None:
        if self.lo > self.hi:
            raise ValueError(f"Box: lo={self.lo} > hi={self.hi}")

    def lower(self) -> ProjectionMap:
        return BoxProjection(self.lo, self.hi)

    def contains(self, w, mask, atol: float = 1e-4) -> bool:
        _, _, real, pad = _split(w, mask)
        ok = np.all(real >= self.lo - atol) and np.all(real <= self.hi + atol)
        return bool(ok) and _pads_zero(pad)


@dataclasses.dataclass(frozen=True)
class Simplex(FeasibleSet):
    """The matching feasible set {w >= 0, sum w <= radius} per source row.

    `inequality=False` is the equality variant {w >= 0, sum w == radius}.
    Lowers to `UnitSimplexProjection` — with default parameters this is
    *exactly* the legacy `MatchingObjective` projection, which is what makes
    the primitive-built matching formulation bit-compatible.
    """

    radius: float = 1.0
    inequality: bool = True

    def validate(self) -> None:
        if self.radius <= 0:
            raise ValueError(f"Simplex: radius={self.radius} must be > 0")

    def lower(self) -> ProjectionMap:
        return UnitSimplexProjection(self.radius, self.inequality)

    def contains(self, w, mask, atol: float = 1e-4) -> bool:
        w_, mask_, real, pad = _split(w, mask)
        sums = (w_ * (mask_ > 0)).sum(-1)
        ok = np.all(real >= -atol)
        if self.inequality:
            ok = ok and np.all(sums <= self.radius + atol)
        else:
            # rows with at least one real entry must sum to the radius
            has_real = (mask_ > 0).any(-1)
            ok = ok and np.all(np.abs(sums[has_real] - self.radius) <= atol)
        return bool(ok) and _pads_zero(pad)


@dataclasses.dataclass(frozen=True)
class CappedSimplex(FeasibleSet):
    """Capacity caps: {0 <= w <= cap, sum w <= radius}.

    The per-edge cap prevents any single destination from absorbing a
    source's whole allocation (DuaLip's BoxCut with lo = 0).
    """

    cap: float = 0.5
    radius: float = 1.0
    bisect_iters: int = 64

    def validate(self) -> None:
        if self.cap <= 0 or self.radius <= 0:
            raise ValueError(
                f"CappedSimplex: cap={self.cap}, radius={self.radius} must be > 0"
            )

    def lower(self) -> ProjectionMap:
        return BoxCutProjection(0.0, self.cap, self.radius, self.bisect_iters)

    def contains(self, w, mask, atol: float = 1e-4) -> bool:
        w_, mask_, real, pad = _split(w, mask)
        sums = (w_ * (mask_ > 0)).sum(-1)
        ok = (
            np.all(real >= -atol)
            and np.all(real <= self.cap + atol)
            and np.all(sums <= self.radius + atol)
        )
        return bool(ok) and _pads_zero(pad)


@dataclasses.dataclass(frozen=True)
class FairnessFloor(FeasibleSet):
    """Fairness floors: {floor <= w <= hi, sum w <= radius} on real entries.

    Every *eligible* edge receives at least `floor` allocation (minimum
    exposure).  Feasibility requires floor * row_degree <= radius; rows with
    more eligible edges than radius/floor make the set empty — `compile`
    cannot see per-row degrees, so callers pick `floor` against the max
    bucket width (see docs/formulation.md worked example).
    """

    floor: float = 0.02
    hi: float = 1.0
    radius: float = 1.0
    bisect_iters: int = 64

    def validate(self) -> None:
        if not (0 <= self.floor <= self.hi):
            raise ValueError(
                f"FairnessFloor: need 0 <= floor <= hi, got "
                f"floor={self.floor}, hi={self.hi}"
            )
        if self.radius < self.floor:
            raise ValueError(
                f"FairnessFloor: radius={self.radius} < floor={self.floor} "
                "is empty for every non-degenerate row"
            )

    def lower(self) -> ProjectionMap:
        return BoxCutProjection(
            self.floor, self.hi, self.radius, self.bisect_iters
        )

    def contains(self, w, mask, atol: float = 1e-4) -> bool:
        w_, mask_, real, pad = _split(w, mask)
        sums = (w_ * (mask_ > 0)).sum(-1)
        ok = (
            np.all(real >= self.floor - atol)
            and np.all(real <= self.hi + atol)
            and np.all(sums <= self.radius + atol)
        )
        return bool(ok) and _pads_zero(pad)


@dataclasses.dataclass(frozen=True)
class BudgetPacedBox(FeasibleSet):
    """Budget pacing ("box + cut"): {0 <= w <= pace, sum w <= budget}.

    `pace` caps the per-edge spend rate, `budget` caps the row total; the
    same BoxCut lowering as capacity caps with pacing semantics — the point
    of the primitive catalog is that such families are declarations, not
    solver changes.
    """

    pace: float = 0.25
    budget: float = 2.0
    bisect_iters: int = 64

    def validate(self) -> None:
        if self.pace <= 0 or self.budget <= 0:
            raise ValueError(
                f"BudgetPacedBox: pace={self.pace}, budget={self.budget} "
                "must be > 0"
            )

    def lower(self) -> ProjectionMap:
        return BoxCutProjection(0.0, self.pace, self.budget, self.bisect_iters)

    def contains(self, w, mask, atol: float = 1e-4) -> bool:
        w_, mask_, real, pad = _split(w, mask)
        sums = (w_ * (mask_ > 0)).sum(-1)
        ok = (
            np.all(real >= -atol)
            and np.all(real <= self.pace + atol)
            and np.all(sums <= self.budget + atol)
        )
        return bool(ok) and _pads_zero(pad)
