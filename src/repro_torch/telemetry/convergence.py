"""Convergence telemetry: per-solve traces + stall detection (port of
`repro.telemetry.convergence`).

The maximizer already materializes per-iteration `(g, grad_norm,
max_violation)` traces and per-stage `iters_used` in `SolveResult.stats`
(tensors on the solve's device).  `ConvergenceTrace.from_result` lifts them
(one device-to-host copy per stage, of the three traces stacked, after the
solve; no per-iteration host syncs) into a structured per-solve record:

  * per-stage traces truncated to the iterations actually executed;
  * per-stage `iters_used` vs the padded budget, and whether the early-stop
    predicate fired (`converged[s]`);
  * a stall flag: early stopping was configured but the final (gamma-floor)
    stage exhausted its budget without the predicate firing — the solve's
    quality claim is the floor stage's convergence, so that is the stage a
    stall is defined on.

`StallDetector` aggregates stalls per tenant across cadences and flags
tenants stalled `patience` consecutive solves — the "this tenant's budget no
longer fits its instance" alarm, exported as
``convergence_stalled_solves_total`` / ``convergence_consecutive_stalls``.

PDHG parity: `core.pdhg.solve_pdhg` emits the same `stats` shape (a 1-tuple
of `StageStats` at check-frequency resolution) plus `iters_used`, so one
`ConvergenceTrace` covers both engines (`engine="agd" | "pdhg"`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.telemetry.registry import MetricsRegistry, get_registry

__all__ = ["StageTrace", "ConvergenceTrace", "StallDetector"]


@dataclasses.dataclass(frozen=True)
class StageTrace:
    """One continuation stage's iteration traces, truncated to `iters_used`.

    `trace_stride` is the iterations-per-trace-entry resolution: 1 for AGD
    (per-iteration traces), `check_every` for PDHG (residuals are only
    computed at check points).  `iters_used`/`budget` are always iterations.
    """

    g: np.ndarray
    grad_norm: np.ndarray
    max_violation: np.ndarray
    iters_used: int
    budget: int
    converged: bool  # early-stop predicate fired before the budget ran out
    trace_stride: int = 1

    def summary(self) -> dict[str, Any]:
        last = lambda a: float(a[-1]) if a.size else None
        return {
            "iters_used": self.iters_used,
            "budget": self.budget,
            "converged": self.converged,
            "g_final": last(self.g),
            "grad_norm_final": last(self.grad_norm),
            "max_violation_final": last(self.max_violation),
        }


@dataclasses.dataclass(frozen=True)
class ConvergenceTrace:
    """Structured per-solve convergence record (host numpy, post-fence)."""

    tenant: str
    cadence: int
    engine: str  # "agd" | "pdhg"
    mode: str  # "cold" | "warm" | "oneshot"
    stages: tuple[StageTrace, ...]
    early_stop: bool  # a stop predicate was configured at all

    @property
    def total_iters_used(self) -> int:
        return sum(s.iters_used for s in self.stages)

    @property
    def total_budget(self) -> int:
        return sum(s.budget for s in self.stages)

    @property
    def stalled(self) -> bool:
        """Early stopping configured, yet the gamma-floor stage never
        converged within its budget — the drift-SLA quality claim rests on
        that stage, so its exhaustion is the stall signal."""
        return bool(
            self.early_stop and self.stages and not self.stages[-1].converged
        )

    @classmethod
    def from_result(
        cls,
        res,  # core.maximizer.SolveResult or core.pdhg.PDHGResult
        *,
        tenant: str = "",
        cadence: int = 0,
        engine: str = "agd",
        mode: str = "oneshot",
        stage_budget: Optional[int] = None,
        trace_stride: int = 1,
    ) -> "ConvergenceTrace":
        """Build from an already-returned solve result.

        Reads `res.stats` (a tuple of StageStats whose arrays the solve
        already computed) and `res.iters_used`; the only work here is the
        device→host copy of those trace arrays, sized by the iteration
        budget, performed once per solve.

        `trace_stride` handles engines whose traces are coarser than one
        entry per iteration (PDHG records residuals every `check_every`
        iterations): budgets and `iters_used` stay in iterations while the
        trace arrays are truncated at entry resolution.
        """
        stats = tuple(res.stats)
        iters_used = getattr(res, "iters_used", None)
        early_stop = iters_used is not None
        stride = max(1, int(trace_stride))
        stages = []
        for s, st in enumerate(stats):
            g, gn, mv = _host_traces(st)
            budget = (
                int(g.shape[0]) * stride
                if stage_budget is None
                else int(stage_budget)
            )
            used = int(iters_used[s]) if early_stop else budget
            used = max(0, min(used, budget))
            n = min(-(-used // stride), int(g.shape[0]))
            stages.append(
                StageTrace(
                    g=g[:n],
                    grad_norm=gn[:n],
                    max_violation=mv[:n],
                    iters_used=used,
                    budget=budget,
                    converged=bool(early_stop and used < budget),
                    trace_stride=stride,
                )
            )
        return cls(
            tenant=tenant,
            cadence=int(cadence),
            engine=engine,
            mode=mode,
            stages=tuple(stages),
            early_stop=early_stop,
        )

    def summary(self) -> dict[str, Any]:
        """Compact JSON-able view — what the JSONL exporter records."""
        final = self.stages[-1].summary() if self.stages else {}
        return {
            "tenant": self.tenant,
            "cadence": self.cadence,
            "engine": self.engine,
            "mode": self.mode,
            "num_stages": len(self.stages),
            "iters_used": [s.iters_used for s in self.stages],
            "stage_budgets": [s.budget for s in self.stages],
            "total_iters_used": self.total_iters_used,
            "total_budget": self.total_budget,
            "converged_by_stage": [s.converged for s in self.stages],
            "early_stop": self.early_stop,
            "stalled": self.stalled,
            "g_final": final.get("g_final"),
            "grad_norm_final": final.get("grad_norm_final"),
            "max_violation_final": final.get("max_violation_final"),
        }

    def record(self, registry: Optional[MetricsRegistry] = None) -> None:
        """Fold this solve's convergence telemetry into the registry."""
        reg = registry or get_registry()
        labels = dict(tenant=self.tenant, engine=self.engine, mode=self.mode)
        reg.inc("convergence_solves_total", 1, **labels)
        reg.inc("convergence_iters_total", self.total_iters_used, **labels)
        reg.observe(
            "convergence_iters_used", self.total_iters_used, engine=self.engine
        )
        if self.total_budget:
            reg.set_gauge(
                "convergence_budget_utilization",
                self.total_iters_used / self.total_budget,
                tenant=self.tenant,
            )


def _host_traces(st) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(g, grad_norm, max_violation) of one stage as host numpy arrays: the
    three traces of a tensor stage cross to the host in one copy."""
    if isinstance(st.g, torch.Tensor):
        both = torch.stack([st.g, st.grad_norm, st.max_violation]).cpu().numpy()
        return both[0], both[1], both[2]
    return np.asarray(st.g), np.asarray(st.grad_norm), np.asarray(st.max_violation)


class StallDetector:
    """Flags tenants whose early-stop predicate keeps failing to fire.

    One stalled solve may just be a noisy cadence; `patience` consecutive
    stalls (default 1 — flag immediately) marks the tenant.  State is
    per-detector; the service layer keeps one per scheduler lifetime.
    """

    def __init__(self, patience: int = 1):
        self.patience = max(1, int(patience))
        self._consecutive: dict[str, int] = {}
        self.flagged: set[str] = set()

    def observe(
        self, trace: ConvergenceTrace, registry: Optional[MetricsRegistry] = None
    ) -> bool:
        """Record one solve; returns True when the tenant is (now) flagged."""
        reg = registry or get_registry()
        key = trace.tenant or "<default>"
        if trace.stalled:
            self._consecutive[key] = self._consecutive.get(key, 0) + 1
            reg.inc("convergence_stalled_solves_total", 1, tenant=key)
        else:
            self._consecutive[key] = 0
            self.flagged.discard(key)
        n = self._consecutive[key]
        reg.set_gauge("convergence_consecutive_stalls", n, tenant=key)
        if n >= self.patience:
            self.flagged.add(key)
        return key in self.flagged
