"""Maximizer — accelerated dual ascent with gamma-continuation (port of
`repro.core.maximizer`).

Nesterov-accelerated projected gradient ascent on the smoothed dual g(lam)
over lam >= 0, with the analytic step eta = gamma / sigma_max(A)^2 (clipped
to the paper's range), the paper's six-stage continuation schedule, and
O'Donoghue–Candès adaptive restart.  Jacobi preconditioning is an instance
transform (`objective.normalize_rows`) applied beforehand.

The reference's `lax.scan` is a Python loop here.  Everything a step
decides (the restart test `g < g_prev`, the lam >= 0 clamp) stays on the
device: the fixed-budget stage never waits for the device, and the
early-stopping stage waits once per `check_every` chunk, as the reference's
`while_loop` of scanned chunks does.

Each stage runs inside a `telemetry.span("stage")` and the power iteration
inside `telemetry.span("power_iteration")`, as in the reference; a span
reads the host clock only, so it measures the enqueue of device work.

The stage loops take `calculate(lam, gamma, comm) -> (DualEval, comm)`:
`comm` is an opaque per-process communication state threaded through the
iterations (the error-feedback accumulator of the sharded solve's
compressed all-reduce, `core.sharding`); the single-device solve passes
None through.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import telemetry
from repro_torch.core.objective import DualEval, MatchingObjective

__all__ = [
    "MaximizerConfig",
    "StageStats",
    "SolveResult",
    "Maximizer",
    "PAPER_GAMMA_SCHEDULE",
    "step_size",
]

# Paper §7.2: six-stage geometric schedule.
PAPER_GAMMA_SCHEDULE: tuple[float, ...] = (1e3, 1e2, 10.0, 1.0, 1e-1, 1e-2)


def step_size(
    cfg: "MaximizerConfig", sigma_sq: torch.Tensor, gamma: float
) -> torch.Tensor:
    """Analytic AGD step eta = step_scale * gamma / sigma_max(A)^2, clipped
    to the paper's range."""
    eta = cfg.step_scale * gamma / torch.clamp_min(sigma_sq, 1e-20)
    return torch.clamp(eta, cfg.min_step, cfg.max_step)


@dataclasses.dataclass(frozen=True)
class MaximizerConfig:
    gammas: tuple[float, ...] = PAPER_GAMMA_SCHEDULE
    iters_per_stage: int = 200
    step_scale: float = 1.0
    min_step: float = 1e-5  # paper §7.2 AGD step-size range
    max_step: float = 1e-1
    acceleration: bool = True
    adaptive_restart: bool = True
    power_iters: int = 30
    seed: int = 0
    # Early stopping: a stage exits once ||grad g|| <= tol_grad * max(1, |g|)
    # and max(0, Ax-b) <= tol_viol, checked every `check_every` iterations.
    # Both None keeps the fixed-budget stage.
    tol_grad: Optional[float] = None
    tol_viol: Optional[float] = None
    check_every: int = 25

    @property
    def total_iters(self) -> int:
        return self.iters_per_stage * len(self.gammas)

    @property
    def early_stop(self) -> bool:
        return self.tol_grad is not None or self.tol_viol is not None

    @property
    def stage_iter_budget(self) -> int:
        """Worst-case iterations per stage (chunking rounds the budget up)."""
        if not self.early_stop:
            return self.iters_per_stage
        chunk = max(1, min(self.check_every, self.iters_per_stage))
        return -(-self.iters_per_stage // chunk) * chunk

    @property
    def total_iter_budget(self) -> int:
        return self.stage_iter_budget * len(self.gammas)


class StageStats(NamedTuple):
    g: torch.Tensor  # [T] dual objective trace
    grad_norm: torch.Tensor  # [T] ||grad g||
    max_violation: torch.Tensor  # [T] max(0, Ax - b)


class SolveResult(NamedTuple):
    lam: torch.Tensor
    x_slabs: tuple[torch.Tensor, ...]
    g: torch.Tensor  # final dual objective
    stats: tuple[StageStats, ...]  # one per continuation stage
    sigma_sq: torch.Tensor  # power-iteration estimate of sigma_max(A)^2
    steps: tuple[float, ...]  # per-stage step sizes actually used
    # per-stage iterations executed; None when early stopping is disabled
    iters_used: Optional[tuple[int, ...]] = None
    # explicit solver restarts taken (PDHG anchor/average restarts); None for
    # engines that do not count them (AGD's in-loop momentum resets)
    restarts: Optional[int] = None

    @property
    def total_iters_used(self) -> Optional[int]:
        return None if self.iters_used is None else int(sum(self.iters_used))


class _Carry(NamedTuple):
    lam_prev: torch.Tensor
    lam: torch.Tensor
    tk: torch.Tensor  # momentum counter (float)
    g_prev: torch.Tensor
    comm: object  # opaque per-process communication state (error feedback)


Calculate = Callable[[torch.Tensor, float, object], tuple[DualEval, object]]


def local_calculate(objective: MatchingObjective) -> Calculate:
    """The single-device stage `calculate`: the objective's, with the
    communication state passed through untouched."""
    return lambda lam, gamma, comm: (objective.calculate(lam, gamma), comm)


def _agd_body(
    calculate: Calculate,
    gamma: float,
    eta: torch.Tensor,
    *,
    acceleration: bool,
    adaptive_restart: bool,
) -> Callable:
    """One accelerated projected dual-ascent iteration: carry -> (carry, traces)."""

    def body(carry: _Carry):
        mu = carry.lam
        if acceleration:
            beta = (carry.tk - 1.0) / (carry.tk + 2.0)
            mu = mu + beta * (carry.lam - carry.lam_prev)
        mu = torch.clamp_min(mu, 0.0)
        ev, comm = calculate(mu, gamma, carry.comm)
        lam_next = torch.clamp_min(mu + eta * ev.grad, 0.0)
        if adaptive_restart:
            tk_next = torch.where(ev.g < carry.g_prev, 1.0, carry.tk + 1.0)
        else:
            tk_next = carry.tk + 1.0
        gn = torch.linalg.vector_norm(ev.grad)
        viol = torch.clamp_min(ev.grad, 0.0).max()
        new = _Carry(
            lam_prev=carry.lam, lam=lam_next, tk=tk_next, g_prev=ev.g, comm=comm
        )
        return new, (ev.g, gn, viol)

    return body


def _init_carry(lam0: torch.Tensor, comm0: object) -> _Carry:
    return _Carry(
        lam_prev=lam0,
        lam=lam0,
        tk=torch.ones((), dtype=lam0.dtype, device=lam0.device),
        g_prev=torch.full((), -torch.inf, dtype=lam0.dtype, device=lam0.device),
        comm=comm0,
    )


def _run(body: Callable, carry, steps: int):
    """`steps` iterations of `body`; traces stacked per trace as [steps]."""
    traces = []
    for _ in range(steps):
        carry, t = body(carry)
        traces.append(t)
    return carry, tuple(torch.stack(ts) for ts in zip(*traces))


def _stage_scan(
    calculate: Calculate,
    lam0: torch.Tensor,
    gamma: float,
    eta: torch.Tensor,
    iters: int,
    *,
    acceleration: bool,
    adaptive_restart: bool,
    comm0: object = None,
) -> tuple[torch.Tensor, StageStats, object]:
    """One continuation stage of accelerated projected dual ascent:
    `(lam, stats, comm)`."""
    body = _agd_body(
        calculate, gamma, eta,
        acceleration=acceleration, adaptive_restart=adaptive_restart,
    )
    final, (gs, gns, viols) = _run(body, _init_carry(lam0, comm0), iters)
    return final.lam, StageStats(g=gs, grad_norm=gns, max_violation=viols), final.comm


def _chunked_early_scan(
    body: Callable,
    carry0,
    iters: int,
    *,
    check_every: int,
    stop_predicate: Callable,
    stop_reduce: Optional[Callable] = None,
):
    """Run `body` in chunks of `check_every` steps until `stop_predicate`
    of the last chunk's traces holds or the budget is spent; one host wait
    per chunk.  `stop_reduce` makes the decision collective (the sharded
    solve's unanimous vote, `core.sharding`): it must return the same value
    in every process, or they leave the loop at different chunks and the
    collectives inside `body` hang.  Returns `(final_carry, traces,
    steps_used)`; traces are padded to the rounded-up budget with the last
    computed value, so `trace[-1]` stays meaningful after an early exit."""
    chunk = max(1, min(int(check_every), int(iters)))
    n_chunks = -(-int(iters) // chunk)
    carry, parts = carry0, []
    for _ in range(n_chunks):
        carry, traces = _run(body, carry, chunk)
        parts.append(traces)
        done = stop_predicate(traces)
        if stop_reduce is not None:
            done = stop_reduce(done)
        if bool(done):
            break
    steps_used = len(parts) * chunk
    pad = n_chunks * chunk - steps_used
    bufs = tuple(
        torch.cat([*ts, ts[-1][-1:].expand(pad)]) for ts in zip(*parts)
    )
    return carry, bufs, steps_used


def _stage_scan_early(
    calculate: Calculate,
    lam0: torch.Tensor,
    gamma: float,
    eta: torch.Tensor,
    iters: int,
    *,
    acceleration: bool,
    adaptive_restart: bool,
    tol_grad: Optional[float],
    tol_viol: Optional[float],
    check_every: int,
    comm0: object = None,
    stop_reduce: Optional[Callable] = None,
) -> tuple[torch.Tensor, StageStats, object, int]:
    """Early-stopping variant of `_stage_scan`: after each chunk of
    `check_every` iterations the stage exits once
    ``||grad|| <= tol_grad * max(1, |g|)  and  max(0, Ax-b) <= tol_viol``
    (reduced by `stop_reduce` when given).  Returns `(lam, stats, comm,
    iters_used)`."""
    body = _agd_body(
        calculate, gamma, eta,
        acceleration=acceleration, adaptive_restart=adaptive_restart,
    )

    def stop_predicate(traces):
        gs, gns, viols = traces
        done = torch.ones((), dtype=torch.bool, device=gs.device)
        if tol_grad is not None:
            scale = torch.clamp_min(gs[-1].abs(), 1.0)
            done = done & (gns[-1] <= tol_grad * scale)
        if tol_viol is not None:
            done = done & (viols[-1] <= tol_viol)
        return done

    final, (bg, bgn, bv), used = _chunked_early_scan(
        body, _init_carry(lam0, comm0), iters,
        check_every=check_every, stop_predicate=stop_predicate,
        stop_reduce=stop_reduce,
    )
    stats = StageStats(g=bg, grad_norm=bgn, max_violation=bv)
    return final.lam, stats, final.comm, used


def _continuation(
    calculate: Calculate,
    lam: torch.Tensor,
    sigma_sq: torch.Tensor,
    cfg: MaximizerConfig,
    *,
    comm0: Callable[[], object] = lambda: None,
    stop_reduce: Optional[Callable] = None,
) -> SolveResult:
    """The continuation solve from `lam`: one AGD stage per gamma of the
    schedule (early-stopping when configured), then the final `calculate`.
    `comm0()` gives each stage, and the final call, a fresh communication
    state; `stop_reduce` makes the stop vote collective (`core.sharding`)."""
    kw = dict(acceleration=cfg.acceleration, adaptive_restart=cfg.adaptive_restart)
    stats: list[StageStats] = []
    steps: list[float] = []
    iters_used: list[int] = []
    for k, gamma in enumerate(cfg.gammas):
        eta = step_size(cfg, sigma_sq, gamma).to(lam.dtype)
        with telemetry.span("stage", stage=k, gamma=float(gamma)):
            if cfg.early_stop:
                lam, st, _, used = _stage_scan_early(
                    calculate, lam, gamma, eta, cfg.iters_per_stage,
                    tol_grad=cfg.tol_grad, tol_viol=cfg.tol_viol,
                    check_every=cfg.check_every, comm0=comm0(),
                    stop_reduce=stop_reduce, **kw,
                )
                iters_used.append(used)
            else:
                lam, st, _ = _stage_scan(
                    calculate, lam, gamma, eta, cfg.iters_per_stage, comm0=comm0(), **kw
                )
        stats.append(st)
        steps.append(float(eta))
    final, _ = calculate(lam, cfg.gammas[-1], comm0())
    return SolveResult(
        lam=lam,
        x_slabs=final.x_slabs,
        g=final.g,
        stats=tuple(stats),
        sigma_sq=sigma_sq,
        steps=tuple(steps),
        iters_used=tuple(iters_used) if cfg.early_stop else None,
    )


class Maximizer:
    """Dual-ascent driver (paper Table 1 'Maximizer')."""

    def __init__(
        self,
        objective: MatchingObjective,
        config: MaximizerConfig = MaximizerConfig(),
    ):
        self.objective = objective
        self.config = config

    def step_size(self, sigma_sq: torch.Tensor, gamma: float) -> torch.Tensor:
        return step_size(self.config, sigma_sq, gamma)

    def solve(self, lam0: Optional[torch.Tensor] = None) -> SolveResult:
        cfg = self.config
        obj = self.objective
        lam = (
            torch.zeros(obj.dual_dim, dtype=torch.float32, device=obj.instance.device)
            if lam0 is None else lam0
        )
        with telemetry.span("power_iteration"):
            sigma_sq = obj.power_iteration(cfg.seed, iters=cfg.power_iters)
        return _continuation(local_calculate(obj), lam, sigma_sq, cfg)
