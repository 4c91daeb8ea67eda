"""Engine contract (port of `repro.engines.base`).

A solver *engine* runs one full solve of a `BucketedInstance` and returns a
`RawSolve`.  Two engines ship:

  * ``"agd"``  — smoothed-dual accelerated gradient ascent with
    gamma-continuation (the paper's Maximizer; `repro_torch.engines.agd`);
  * ``"pdhg"`` — structured primal-dual hybrid gradient on the same
    bucketed-ELL form, with restarts and relative-residual termination
    (`repro_torch.engines.pdhg`).

The contract every engine satisfies:

  * **solve**: ``raw_solve(inst, lam0, cfg, normalize=..., fused_oracle=...,
    sigma_sq=None) -> RawSolve`` derives every hyperparameter from the shared
    `MaximizerConfig` (budgets, tolerances, check cadence), runs the power
    iteration itself when ``sigma_sq`` is None and reuses the caller's
    estimate otherwise (sigma_max(A) is a function of A alone).
  * **warm state**: the dual vector ``lam`` lives in the SAME [m*J] space for
    every engine (the coupling-row multipliers, Jacobi-scaled when
    ``normalize``), so yesterday's duals warm-start either engine.
  * **stats**: ``RawSolve.stats`` is a tuple of `StageStats` traces and
    ``iters`` the per-stage iteration counts (PDHG emits one stage at
    `check_every` resolution).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Protocol, runtime_checkable

import torch

from repro_torch.core.maximizer import MaximizerConfig, StageStats

__all__ = ["ENGINES", "Engine", "RawSolve", "resolve_engine"]

#: Engine names the service accepts; "auto" is a scheduler policy on top
#: (`repro_torch.engines.selector`), not an engine.
ENGINES: tuple[str, ...] = ("agd", "pdhg")


class RawSolve(NamedTuple):
    """Output of one engine solve, on the instance's device."""

    lam: torch.Tensor  # [dual_dim]
    x_slabs: tuple[torch.Tensor, ...]
    g: torch.Tensor  # final objective value (scalar; engine-native sign)
    stats: tuple[StageStats, ...]  # one per stage
    sigma_sq: torch.Tensor
    etas: torch.Tensor  # [num_stages] step sizes
    iters: torch.Tensor  # [num_stages] iterations executed (int32)
    restarts: torch.Tensor  # scalar int32: momentum/anchor restarts taken


@runtime_checkable
class Engine(Protocol):
    """Engine object: a name plus the raw-solve entry point."""

    name: str

    def raw_solve(
        self,
        inst,
        lam0: torch.Tensor,
        cfg: MaximizerConfig,
        *,
        normalize: bool,
        fused_oracle: bool = False,
        sigma_sq: Optional[torch.Tensor] = None,
    ) -> RawSolve:
        ...


def resolve_engine(name: str) -> Engine:
    """Engine registry lookup; raises ValueError on unknown names."""
    from repro_torch.engines.agd import AGD_ENGINE
    from repro_torch.engines.pdhg import PDHG_ENGINE

    engines = {"agd": AGD_ENGINE, "pdhg": PDHG_ENGINE}
    try:
        return engines[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; choose from {ENGINES}"
        ) from None
