"""Stability control for recurring solves (port of `repro.core.stability`).

The ridge term makes the primal map Lipschitz in the problem data: since
x*_gamma(lam) = Pi_C(-(A^T lam + c)/gamma) and projections onto convex sets
are nonexpansive,

    || x*(lam1; c1) - x*(lam2; c2) ||_2
        <= (1/gamma) * ( ||A^T (lam1 - lam2)||_2 + ||c1 - c2||_2 )
        <= (1/gamma) * ( sigma_max(A) ||lam1 - lam2||_2 + ||c1 - c2||_2 ).

Exposing gamma therefore bounds run-to-run primal drift.  This module
provides the bound, an empirical drift meter, and a warm-started
recurring-solve driver (prior-day duals as lam0).  `RecurringSolver` keeps
the reference's default objective (the unfused oracle); the fused recurring
cadence runs through `repro_torch.service.engine.compiled_solver`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core.maximizer import Maximizer, MaximizerConfig, SolveResult
from repro_torch.core.objective import MatchingObjective
from repro_torch.instances.buckets import BucketedInstance

__all__ = ["drift_bound", "primal_drift", "RecurringSolver"]


def drift_bound(
    gamma: float,
    dc_norm: float,
    dlam_norm: float = 0.0,
    sigma_max: float = 1.0,
) -> float:
    """Upper bound on ||x1 - x2||_2 under data perturbation (see module doc)."""
    return (sigma_max * dlam_norm + dc_norm) / gamma


def _sq_norm(slabs: Sequence[torch.Tensor]) -> torch.Tensor:
    return sum(torch.dot(a.reshape(-1), a.reshape(-1)) for a in slabs)


def primal_drift(
    x1: Sequence[torch.Tensor], x2: Sequence[torch.Tensor]
) -> torch.Tensor:
    """||x1 - x2||_2 across bucket slabs (same packing required)."""
    return torch.sqrt(_sq_norm([a - b for a, b in zip(x1, x2)]))


@dataclasses.dataclass
class RecurringSolver:
    """Recurring-cadence driver: warm-start each solve from yesterday's duals.

    Holds the last dual iterate; each `solve(instance)` warm-starts from it.
    The `gamma` floor of the continuation schedule is the stability knob.
    """

    config: MaximizerConfig = dataclasses.field(default_factory=MaximizerConfig)
    lam_prev: Optional[torch.Tensor] = None
    x_prev: Optional[tuple[torch.Tensor, ...]] = None

    def solve(self, inst: BucketedInstance) -> tuple[SolveResult, dict]:
        obj = MatchingObjective(inst)
        lam0 = self.lam_prev
        cold_start_reason = None
        if lam0 is not None and tuple(lam0.shape) != (obj.dual_dim,):
            # Shape drift: a resized instance (different destination/family
            # count) makes yesterday's duals meaningless.  Fall back to a
            # cold start and say so.
            lam0 = None
            self.x_prev = None
            cold_start_reason = "dual_dim_drift"
        res = Maximizer(obj, self.config).solve(lam0=lam0)
        report = {}
        if cold_start_reason is not None:
            report["cold_start_reason"] = cold_start_reason
        slabs_comparable = self.x_prev is not None and [
            x.shape for x in self.x_prev
        ] == [x.shape for x in res.x_slabs]
        if slabs_comparable:
            drift = float(primal_drift(res.x_slabs, self.x_prev))
            x_norm = float(torch.sqrt(_sq_norm(res.x_slabs)))
            report.update(
                drift_l2=drift,
                drift_rel=drift / max(x_norm, 1e-12),
                gamma_floor=self.config.gammas[-1],
            )
        self.lam_prev = res.lam
        self.x_prev = res.x_slabs
        return res, report
