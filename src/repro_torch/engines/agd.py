"""AGD engine (port of `repro.engines.agd`): the paper's smoothed-dual
continuation solve behind the engine contract.

The full gamma-continuation schedule of accelerated projected dual ascent,
with convergence-based early stopping per stage when the config carries
tolerances, on the Maximizer's own stage loops (`core.maximizer`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import telemetry
from repro_torch.core.batched import BatchedObjective, batched_continuation, normalize_lanes
from repro_torch.core.maximizer import (
    MaximizerConfig,
    StageStats,
    _stage_scan,
    _stage_scan_early,
    local_calculate,
    step_size,
)
from repro_torch.core.objective import MatchingObjective, normalize_rows_traced
from repro_torch.engines.base import RawSolve
from repro_torch.instances.buckets import BucketedInstance

__all__ = ["AGDEngine", "AGD_ENGINE", "agd_raw_solve", "agd_raw_solve_batched"]


def agd_raw_solve(
    inst: BucketedInstance,
    lam0: torch.Tensor,
    cfg: MaximizerConfig,
    normalize: bool,
    fused_oracle: bool = False,
    sigma_sq: Optional[torch.Tensor] = None,
) -> RawSolve:
    """The full continuation solve of `inst` from `lam0`.

    ``sigma_sq=None`` runs the power iteration (cfg.power_iters steps); a
    given estimate skips it (a warm cadence whose coefficients have not
    changed).  ``normalize`` applies the Jacobi scaling on the device first
    (`normalize_rows_traced`).
    """
    if normalize:
        inst, _ = normalize_rows_traced(inst)
    obj = MatchingObjective(inst, fused_oracle=fused_oracle)
    calc = local_calculate(obj)
    if sigma_sq is None:
        with telemetry.span("power_iteration", device=inst.device):
            sigma_sq = obj.power_iteration(cfg.seed, iters=cfg.power_iters)
    lam = lam0
    stats: list[StageStats] = []
    etas: list[torch.Tensor] = []
    iters: list[int] = []
    for k, gamma in enumerate(cfg.gammas):
        eta = step_size(cfg, sigma_sq, gamma).to(lam.dtype)
        with telemetry.span("stage", device=inst.device, stage=k, gamma=float(gamma)):
            if cfg.early_stop:
                # single process: the local convergence predicate is the global one
                lam, st, _, used = _stage_scan_early(
                    calc, lam, gamma, eta, cfg.iters_per_stage,
                    acceleration=cfg.acceleration,
                    adaptive_restart=cfg.adaptive_restart,
                    tol_grad=cfg.tol_grad,
                    tol_viol=cfg.tol_viol,
                    check_every=cfg.check_every,
                )
            else:
                lam, st, _ = _stage_scan(
                    calc, lam, gamma, eta, cfg.iters_per_stage,
                    acceleration=cfg.acceleration,
                    adaptive_restart=cfg.adaptive_restart,
                )
                used = cfg.iters_per_stage
        stats.append(st)
        etas.append(eta)
        iters.append(used)
    final = obj.calculate(lam, cfg.gammas[-1])
    return RawSolve(
        lam=lam,
        x_slabs=final.x_slabs,
        g=final.g,
        stats=tuple(stats),
        sigma_sq=sigma_sq,
        etas=torch.stack(etas),
        iters=torch.tensor(iters, dtype=torch.int32),
        # AGD's momentum resets happen inside the stage loop and are not
        # counted; the restart count is a PDHG concept
        restarts=torch.zeros((), dtype=torch.int32),
    )


def agd_raw_solve_batched(
    stacked: BucketedInstance,
    lam0: torch.Tensor,
    cfg: MaximizerConfig,
    normalize: bool,
    fused_oracle: bool = False,
    sigma_sq: Optional[torch.Tensor] = None,
) -> RawSolve:
    """The continuation solve of every lane of a stacked instance from
    `lam0` [B, m*J], in one AGD loop over the lanes (`core.batched`): every
    `RawSolve` field gains the lane dimension.  ``sigma_sq`` [B] skips the
    power iteration of every lane."""
    if normalize:
        stacked = normalize_lanes(stacked)
    obj = BatchedObjective(stacked, fused_oracle=fused_oracle)
    if sigma_sq is None:
        with telemetry.span("power_iteration", device=stacked.device):
            sigma_sq = obj.power_iteration(cfg.seed, iters=cfg.power_iters)
    lam, final, stats, etas, iters = batched_continuation(obj, lam0, cfg, sigma_sq)
    return RawSolve(
        lam=lam, x_slabs=final.x_slabs, g=final.g, stats=stats, sigma_sq=sigma_sq,
        etas=etas, iters=iters,
        restarts=torch.zeros(lam.shape[0], dtype=torch.int32, device=lam.device),
    )


class AGDEngine:
    """Engine-protocol wrapper over `agd_raw_solve`."""

    name = "agd"

    @staticmethod
    def raw_solve(
        inst,
        lam0,
        cfg: MaximizerConfig,
        *,
        normalize: bool,
        fused_oracle: bool = False,
        sigma_sq=None,
    ) -> RawSolve:
        return agd_raw_solve(inst, lam0, cfg, normalize, fused_oracle, sigma_sq)


AGD_ENGINE = AGDEngine()
