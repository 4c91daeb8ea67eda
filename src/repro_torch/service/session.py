"""Per-tenant solve session: delta ingestion + warm-started cadence solves
(port of `repro.service.session`).

A `SolveSession` owns everything one tenant needs across cadences:

  * its `DeltaIngestor` (the mutable packed instance + headroom bookkeeping);
  * the previous duals / primal slabs for warm starts and drift metering;
  * access to the shared shape-keyed compiled solvers (`service.engine`).

The cadence loop the paper targets ("solved repeatedly on recurring cadences
over slowly evolving inputs") becomes:

    session.ingest(delta)          # O(delta) slab surgery, shapes preserved
    result, report = session.solve()  # warm start + shortened continuation

Warm starts skip the large-gamma continuation stages (yesterday's duals are
already near the small-gamma optimum) and rely on convergence-based early
stopping to exit once the iterate re-converges, so a quiet day costs a small
fraction of the cold iteration budget.  Guards fall back to a cold start when
the dual dimension drifts (resized instance) or when explicitly forced, and
the report says so (`cold_reason`).

Drift-SLA: each solve reports the empirical primal drift vs the previous
cadence together with the analytic bound `(sigma ||dlam|| + ||dc||) / gamma`
(core.stability), and flags `sla_ok` against the configured relative-drift
SLA — the run-to-run stability control the paper's ridge term exists for.

Slabs are device-resident across cadences: `device_instance()` keeps a copy
of the host slabs on the session's device, synced by replaying the
ingestor's scatter plans (generation-fenced), so steady-state host→device
transfer is O(delta); and `state_dict()`/`from_state()` persist everything
needed for a restarted service to resume this tenant warm, in the
reference's checkpoint format (so either package restores the other's).
A session runs on `device` (default "cuda", which raises without a card).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core.maximizer import MaximizerConfig, SolveResult
from repro_torch.core.stability import drift_bound
from repro_torch.device import resolve_device
from repro_torch.telemetry import ConvergenceTrace, StallDetector
from repro_torch.instances.buckets import slab_dtype_name
from repro_torch.instances.deltas import (
    DeltaIngestor,
    DeltaReport,
    InstanceDelta,
    ScatterPlan,
)
from repro_torch.instances.generator import EdgeListInstance
from repro_torch.service.engine import (
    apply_scatter_plan,
    compiled_solver,
    compiled_solver_fixed_sigma,
    device_put_instance,
    instance_nbytes,
    to_solve_result,
)

__all__ = ["ServiceConfig", "SolveSession"]


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Knobs of the recurring-solve service (shared by all tenants)."""

    # Cold starts run the full continuation schedule; early stopping is on by
    # default so even cold solves exit stages once converged.
    cold: MaximizerConfig = dataclasses.field(
        default_factory=lambda: MaximizerConfig(
            tol_grad=1e-4, tol_viol=1e-4, check_every=25
        )
    )
    # Warm starts resume from yesterday's duals on a shortened continuation
    # tail (the large-gamma stages exist to *reach* the small-gamma basin,
    # which a warm iterate is already in).
    warm_gammas: tuple[float, ...] = (1e-1, 1e-2)
    warm_iters_per_stage: Optional[int] = None  # None: same as cold
    # Relative primal-drift SLA (||x_t - x_{t-1}|| / ||x_t||); None disables.
    drift_sla_rel: Optional[float] = None
    # Jacobi row normalization applied device-side inside every compiled
    # solve (normalize_rows_traced) — the paper's preconditioning without a
    # host-side O(nnz) repack per cadence.
    normalize: bool = True
    # One-pass fused dual oracle inside every compiled solve (see
    # core.objective.MatchingObjective.fused_oracle): each AGD iteration
    # reads every slab once instead of ~3x.  On the CPU this routes through
    # the oracle's plain version; results match the unfused path to fp32
    # noise.
    fused_oracle: bool = False
    # Warm cadences whose ingested cost drift ||dc|| is at or below this
    # threshold reuse the previous solve's sigma_max(A)^2 estimate instead of
    # re-running the ~power_iters-oracle-call power iteration.  sigma_max(A)
    # is a function of the coefficients alone, so reuse additionally requires
    # that no delta since the estimate touched A: any insert/delete,
    # coefficient update, or re-bucketize marks the cache dirty and forces a
    # recompute (cost-only updates — the common quiet cadence — keep it
    # valid; dc_norm then only gates how quiet the cadence was).  Cold starts
    # always recompute.  None disables reuse.  Honored by the synchronous
    # `SolveSession.solve`, the scheduler's solo dispatch path, and — when
    # every member of a warm shape-group is reuse-ready — the batched pool
    # via `compiled_batch_solver_fixed_sigma`; mixed groups recompute (the
    # reference's vmapped lane cannot skip its power iteration alone, and
    # the port keeps its grouping).
    sigma_reuse_dc_threshold: Optional[float] = None
    # Escalating warm-start schedule.  None keeps the fixed `warm_gammas`
    # tail.  A tuple of ascending relative-drift thresholds turns the warm
    # schedule adaptive: after each cadence the session compares the observed
    # relative primal drift (`drift_rel`, falling back to the analytic
    # thresholds (first cadences with no previous primal stay at level 0) —
    # each threshold exceeded adds one escalation level, and a
    # failed drift SLA (`sla_ok is False`) adds one more.  Escalation level e
    # prepends the e smallest cold-schedule gammas that are still above
    # `warm_gammas[0]` (re-entering that much of the continuation run-up), so
    # a quiet tenant keeps the short tail while a churning tenant climbs back
    # toward the cold schedule instead of thrashing inside the small-gamma
    # basin.  The chosen schedule is reported (`report["warm_schedule"]`) and
    # is part of the scheduler's batching key — tenants at different
    # escalation levels never share a batched solve.
    warm_escalation: Optional[tuple[float, ...]] = None
    # Slab storage dtype for every tenant's packed instance ("float32" or
    # "bfloat16"; int8 is batch-only — see DeltaIngestor).  Narrow storage
    # halves steady-state slab HBM traffic per oracle read; duals, rhs and
    # all in-kernel accumulation stay fp32.
    slab_dtype: str = "float32"
    # Solver engine every tenant dispatches on: "agd" (the paper's smoothed
    # continuation solve), "pdhg" (structured primal-dual, repro_torch.engines),
    # or "auto" — per-tenant adaptive routing from observed iterations-to-tol
    # (`repro_torch.engines.EngineSelector`; the scheduler owns the selector and
    # checkpoints it).  A session driven outside a scheduler treats "auto"
    # as "agd" until a selector is attached.
    engine: str = "agd"
    # Packing knobs forwarded to each tenant's DeltaIngestor.
    row_headroom: int = 8
    min_length: int = 1
    shard_multiple: int = 1

    def __post_init__(self):
        from repro_torch.engines.base import ENGINES
        from repro_torch.instances.buckets import SLAB_DTYPES

        if self.slab_dtype not in SLAB_DTYPES or self.slab_dtype == "int8":
            raise ValueError(
                f"ServiceConfig.slab_dtype={self.slab_dtype!r}: the service "
                "path supports 'float32' and 'bfloat16' (int8 requires "
                "frozen per-bucket scales, incompatible with O(delta) slab "
                "surgery)"
            )
        if self.engine not in ENGINES + ("auto",):
            raise ValueError(
                f"ServiceConfig.engine={self.engine!r}: choose from "
                f"{ENGINES + ('auto',)}"
            )

    @property
    def warm(self) -> MaximizerConfig:
        """The warm-start solver config: `cold` with the shortened gamma tail."""
        return self.warm_for(0)

    def escalated_warm_gammas(self, level: int) -> tuple[float, ...]:
        """The warm gamma schedule at escalation level ``level``.

        Level 0 is the configured `warm_gammas` tail; each level above it
        prepends the next-smallest cold-schedule gamma still above the tail's
        head, re-entering that much of the continuation run-up (ordered
        descending, as continuation schedules are).  Saturates once the full
        cold run-up is prepended.
        """
        if level <= 0:
            return self.warm_gammas
        runup = sorted(g for g in self.cold.gammas if g > self.warm_gammas[0])
        prepend = tuple(sorted(runup[: min(level, len(runup))], reverse=True))
        return prepend + self.warm_gammas

    def warm_for(self, level: int) -> MaximizerConfig:
        """The warm solver config at escalation level ``level``."""
        iters = (
            self.cold.iters_per_stage
            if self.warm_iters_per_stage is None
            else self.warm_iters_per_stage
        )
        return dataclasses.replace(
            self.cold,
            gammas=self.escalated_warm_gammas(level),
            iters_per_stage=iters,
        )


class SolveSession:
    """State and cadence driver of one tenant."""

    def __init__(
        self, tenant: str, inst: EdgeListInstance, config: ServiceConfig,
        *, device="cuda",
    ):
        self.tenant = tenant
        self.config = config
        self.device = resolve_device(device)
        self.ingestor = DeltaIngestor(
            inst,
            shard_multiple=config.shard_multiple,
            min_length=config.min_length,
            row_headroom=config.row_headroom,
            dtype=config.slab_dtype,
        )
        self.ingestor.telemetry_tenant = tenant
        # per-tenant stall detection over the ConvergenceTraces absorb builds
        self._stall = StallDetector()
        self.last_convergence: Optional[ConvergenceTrace] = None
        self.lam_prev: Optional[torch.Tensor] = None
        # previous primal in edge space: (sorted int64 edge keys, float64
        # values) — robust to row relocations and re-bucketizes, unlike slab
        # positions.  Numpy arrays on the CPU; on a card, tensors there, and
        # the drift is metered there (`_edge_drift_device`).
        self.prev_primal: Optional[tuple] = None
        self.cadence = 0
        self.last_ingest: Optional[DeltaReport] = None
        self.last_report: Optional[dict[str, Any]] = None
        # Device-resident copy of the packed slabs, kept in sync with the host
        # ingestor through scatter plans.  `_device_generation` is the
        # ingestor generation the device copy reflects; `_pending_plans` are
        # plans ingested but not yet replayed on device.
        self._device_inst = None
        self._device_generation = -1
        self._pending_plans: list[ScatterPlan] = []
        # What the last device sync transferred: {"mode": "full"|"scatter"|
        # "none", "bytes": int} — the benchmark's O(delta)-vs-O(nnz) evidence.
        self.last_transfer: Optional[dict[str, Any]] = None
        # Previous solve's sigma_max(A)^2 estimate for the warm-cadence
        # power-iteration skip (sigma_reuse_dc_threshold).  `_dirty_count`
        # increments on every ingested delta that touches A (inserts,
        # deletes, coefficient updates, re-bucketizes); `_sigma_clean_at` is
        # the count the stored estimate was computed under, snapshotted at
        # dispatch time so the overlapped scheduler's ingest-during-solve
        # cannot launder a stale estimate into validity.
        self._sigma_sq: Optional[float] = None
        self._dirty_count = 0
        self._sigma_clean_at = -1
        # Warm-escalation level chosen for the NEXT warm solve (see
        # `ServiceConfig.warm_escalation`); updated from the observed drift
        # at every absorb, 0 while no escalation thresholds are configured.
        self.warm_level = 0
        # Attached allocation-serving store (repro_torch.serving.DualStore).  When
        # set, every absorbed solve publishes its duals as an immutable
        # generation-stamped snapshot (see `_publish_duals`); queries are
        # then answered from device-resident duals without touching the
        # solver.  Attach via `Scheduler(dual_store=...)` or directly.
        self.dual_store = None
        # Engine routing policy for `config.engine == "auto"`; attached by
        # the owning Scheduler (which also checkpoints it).  None means
        # "auto" degrades to "agd".
        self.engine_selector = None

    # -- cadence inputs ------------------------------------------------------

    def instance(self):
        """The host-side packed instance (CPU tensors over the ingestor's
        slabs; the source of truth)."""
        return self.ingestor.instance()

    def device_instance(self):
        """The device-resident packed instance, synced to the host state.

        First call (and any loss of sync: re-bucketize fallback, or host
        mutations that bypassed this session) performs the full O(nnz)
        upload; steady-state calls replay only the pending scatter plans —
        O(delta) host→device bytes per cadence.  `last_transfer` records
        which path ran and how many bytes moved.
        """
        gen = self.ingestor.generation
        plans = self._pending_plans
        in_sync = (
            self._device_inst is not None
            and self._device_generation + len(plans) == gen
            and all(
                p.generation == self._device_generation + i + 1
                for i, p in enumerate(plans)
            )
        )
        if not in_sync:
            self._device_inst = device_put_instance(self.instance(), self.device)
            self._device_generation = gen
            self._pending_plans = []
            self.last_transfer = {
                "mode": "full",
                "bytes": instance_nbytes(self._device_inst),
            }
            # Slab bytes the narrow storage dtype saves vs fp32 — both the
            # resident-HBM footprint and (x1 per oracle read) the per-
            # iteration traffic reduction evidence (0 for fp32 slabs).
            telemetry.get_registry().set_gauge(
                "service_slab_bytes_saved",
                float(_slab_bytes_saved(self._device_inst)),
                tenant=self.tenant,
                slab_dtype=slab_dtype_name(self.ingestor.dtype),
            )
        elif plans:
            nbytes = 0
            with telemetry.span("replay", device=self.device, plans=len(plans)):
                for plan in plans:
                    self._device_inst = apply_scatter_plan(self._device_inst, plan)
                    self._device_generation = plan.generation
                    nbytes += plan.nbytes
            self._pending_plans = []
            self.last_transfer = {"mode": "scatter", "bytes": nbytes}
        else:
            self.last_transfer = {"mode": "none", "bytes": 0}
        return self._device_inst

    def ingest(self, delta: InstanceDelta) -> DeltaReport:
        """Apply one delta to the host slabs and queue its device replay.

        Host application is atomic (`DeltaIngestor.apply`): a rejected delta
        raises here without mutating the host slabs, queueing a plan, or
        bumping the generation — so the device copy stays exactly at the last
        good state and the next solve sees no partial edits.
        """
        rep = self.ingestor.apply(delta)
        self.last_ingest = rep
        if rep.plan is not None:
            self._pending_plans.append(rep.plan)
        else:
            # re-bucketize fallback: shapes/placement changed, the device
            # copy is unsalvageable — force a full re-upload on next access
            self._device_inst = None
            self._pending_plans = []
        # Anything that touches the coefficients of A invalidates the cached
        # sigma_max estimate: structural edits (insert/delete change the
        # sparsity), coefficient updates (which meter NO cost drift, so
        # dc_norm alone would be blind to them), and re-bucketizes.
        # Cost-only updates leave A — and therefore sigma — untouched.
        if (
            rep.rebucketized
            or rep.n_insert
            or rep.n_delete
            or delta.update_coeff is not None
        ):
            self._dirty_count += 1
        return rep

    def sigma_reuse_ready(self, dc_norm: float) -> bool:
        """True iff the next solve may skip the power iteration: a cached
        estimate exists, no A-touching delta landed since it was computed,
        and this cadence's cost drift is within the configured threshold."""
        thr = self.config.sigma_reuse_dc_threshold
        return (
            thr is not None
            and self._sigma_sq is not None
            and self._sigma_clean_at == self._dirty_count
            and dc_norm <= thr
        )

    def warm_config(self) -> MaximizerConfig:
        """The warm solver config this tenant's next warm solve should use —
        `ServiceConfig.warm` escalated to the drift-chosen level.  The
        scheduler keys its batching groups on this config's gamma schedule,
        so escalated tenants never share an executable with quiet ones."""
        return self.config.warm_for(self.warm_level)

    def engine_choice(self) -> str:
        """The engine this tenant's next solve dispatches on.

        Resolves `config.engine == "auto"` through the attached
        `EngineSelector` (deterministic given its observed state; "agd" when
        no selector is attached).  Called exactly once per dispatch decision
        — by `solve()` and by the scheduler's `_dispatch` — and emits the
        `engine_selected_total{tenant,engine}` counter there, so routing is
        observable on both the solo and the batched path.
        """
        engine = self.config.engine
        if engine == "auto":
            engine = (
                "agd"
                if self.engine_selector is None
                else self.engine_selector.choose(self.tenant)
            )
        telemetry.get_registry().inc(
            "engine_selected_total", 1, tenant=self.tenant, engine=engine
        )
        return engine

    def prepare_raw(
        self, cfg, lam0, dc_norm: float, *, cold: bool,
        engine: Optional[str] = None,
    ):
        """Sync the device copy and choose the solve, without running it.

        The single site choosing between the fixed-sigma entry point
        (power-iteration skip, `sigma_reuse_ready`) and the full solver —
        `solve()`, the scheduler's solo dispatch and its pipelined solver
        thread all go through here, so the reuse gating cannot drift between
        them.  The device sync (`device_instance`) happens HERE, on the
        calling thread, so a pipelined solve that runs later on another
        thread solves exactly this generation.  The sigma-reuse fast path is
        engine-agnostic: sigma_max(A) depends only on A.  Returns `(run,
        sigma_reused)`, `run()` giving the `RawSolve`.
        """
        if engine is None:
            engine = self.engine_choice()
        reuse = not cold and self.sigma_reuse_ready(dc_norm)
        inst = self.device_instance()
        if reuse:
            fn = compiled_solver_fixed_sigma(
                cfg, self.config.normalize, self.config.fused_oracle, engine
            )
            sigma = torch.tensor(self._sigma_sq, dtype=torch.float32, device=self.device)
            return (lambda: fn(inst, lam0, sigma)), True
        fn = compiled_solver(
            cfg, self.config.normalize, self.config.fused_oracle, engine
        )
        return (lambda: fn(inst, lam0)), False

    def dispatch_raw(
        self, cfg, lam0, dc_norm: float, *, cold: bool,
        engine: Optional[str] = None,
    ):
        """One solve of the device-resident instance (`prepare_raw`, then
        run).  Returns `(RawSolve of device tensors, sigma_reused)`."""
        run, reuse = self.prepare_raw(cfg, lam0, dc_norm, cold=cold, engine=engine)
        return run(), reuse

    def serving_capture(self) -> Optional[dict[str, Any]]:
        """Freeze what publishing duals after the fence needs, at dispatch time.

        Must run right after a dispatch's `device_instance()` sync (every
        dispatch path performs one): the device instance and the copied
        occupancy maps then reflect the same ingestor generation, so the
        snapshot eventually published is internally consistent even though
        the overlapped pipeline mutates the host slabs while the solve is
        still in flight.  Stamped with `_device_generation` — the generation
        the device copy actually reflects.  None when no store is attached.
        """
        if self.dual_store is None or self._device_inst is None:
            return None
        return {
            "instance": self._device_inst,
            "generation": self._device_generation,
            "bucket_of": self.ingestor.bucket_of.copy(),
            "row_of": self.ingestor.row_of.copy(),
            "deg": self.ingestor.deg.copy(),
        }

    # -- solve ---------------------------------------------------------------

    def _start_state(
        self, force_cold: bool
    ) -> tuple[bool, Optional[str], torch.Tensor]:
        """(cold?, reason, lam0) with the shape-drift guard applied."""
        dual_dim = self.instance().dual_dim
        if force_cold:
            reason = "forced"
        elif self.lam_prev is None:
            reason = "first_solve"
        elif tuple(self.lam_prev.shape) != (dual_dim,):
            # a resized instance makes yesterday's duals meaningless (and
            # passing them into the solver would be a shape error)
            reason = "dual_dim_drift"
        else:
            return False, None, self.lam_prev
        return True, reason, torch.zeros(dual_dim, dtype=torch.float32, device=self.device)

    def solve(self, *, force_cold: bool = False) -> tuple[SolveResult, dict]:
        """One warm-started (or guarded-cold) solve of the current instance.

        Solves against the device-resident slabs (`device_instance`), so the
        per-cadence transfer is the pending scatter plans, not the slabs.
        Warm cadences below `sigma_reuse_dc_threshold` additionally skip the
        power iteration by reusing the previous solve's sigma_max estimate
        (`compiled_solver_fixed_sigma`); the report says so (`sigma_reused`).
        """
        cold, reason, lam0 = self._start_state(force_cold)
        cfg = self.config.cold if cold else self.warm_config()
        dc_norm = self.ingestor.drain_cost_drift()
        dirty_count = self._dirty_count  # A-state the solve runs against
        engine = self.engine_choice()
        with telemetry.span(
            "tenant_solve", tenant=self.tenant, mode="cold" if cold else "warm"
        ):
            raw, reuse_sigma = self.dispatch_raw(
                cfg, lam0, dc_norm, cold=cold, engine=engine
            )
            serving = self.serving_capture()
            res = to_solve_result(raw)
            report = self.absorb(
                res, cold=cold, cold_reason=reason, batched=False,
                dc_norm=dc_norm, sigma_reused=reuse_sigma,
                dirty_count=dirty_count, serving=serving, engine=engine,
            )
        return res, report

    def absorb(
        self,
        res: SolveResult,
        *,
        cold: bool,
        cold_reason: Optional[str],
        batched: bool,
        dc_norm: Optional[float] = None,
        unpack=None,
        sigma_reused: bool = False,
        dirty_count: Optional[int] = None,
        serving: Optional[dict[str, Any]] = None,
        engine: str = "agd",
    ) -> dict[str, Any]:
        """Fold a finished solve (own or pool-produced) into session state.

        ``dc_norm`` is the cost drift ingested *for* this solve; when None it
        is drained here (correct for synchronous callers).  ``unpack`` is the
        primal unpacker frozen when the solve was dispatched; when None the
        ingestor's current maps are used.  Overlapped drivers must capture
        both at dispatch time, or the next cadence's in-flight ingest would
        corrupt this one's drift metering (see `Scheduler._dispatch`).
        ``serving`` is the `serving_capture()` taken at dispatch time; when
        present (a DualStore is attached) the finished duals are published
        against exactly that captured instance.
        """
        with telemetry.span(
            "tenant_absorb",
            tenant=self.tenant,
            mode="cold" if cold else "warm",
            batched=batched,
        ):
            return self._absorb(
                res,
                cold=cold,
                cold_reason=cold_reason,
                batched=batched,
                dc_norm=dc_norm,
                unpack=unpack,
                sigma_reused=sigma_reused,
                dirty_count=dirty_count,
                serving=serving,
                engine=engine,
            )

    def _absorb(
        self,
        res: SolveResult,
        *,
        cold: bool,
        cold_reason: Optional[str],
        batched: bool,
        dc_norm: Optional[float] = None,
        unpack=None,
        sigma_reused: bool = False,
        dirty_count: Optional[int] = None,
        serving: Optional[dict[str, Any]] = None,
        engine: str = "agd",
    ) -> dict[str, Any]:
        cfg = self.config.cold if cold else self.warm_config()
        gamma_floor = cfg.gammas[-1]
        if dc_norm is None:
            dc_norm = self.ingestor.drain_cost_drift()
        if unpack is None:
            unpack = self.ingestor.primal_unpacker()
        report: dict[str, Any] = {
            "tenant": self.tenant,
            "cadence": self.cadence,
            "mode": "cold" if cold else "warm",
            "cold_reason": cold_reason,
            "batched": batched,
            "engine": engine,
            "iters_used": res.total_iters_used or cfg.total_iters,
            "iter_budget": cfg.total_iter_budget,
            "g": float(res.g),
            "max_violation": float(res.stats[-1].max_violation[-1]),
            "gamma_floor": gamma_floor,
            "dc_norm": dc_norm,
            "sigma_reused": sigma_reused,
            # the gamma schedule this solve actually ran (escalation-aware
            # for warm solves; the full cold schedule otherwise) and the
            # escalation level it was chosen at
            "warm_schedule": [float(g) for g in cfg.gammas],
            "warm_level": 0 if cold else self.warm_level,
            "upload_mode": (
                self.last_transfer["mode"] if self.last_transfer else None
            ),
            "upload_bytes": (
                self.last_transfer["bytes"] if self.last_transfer else None
            ),
            "drift_l2": None,
            "drift_rel": None,
            "drift_bound": None,
            "dual_resized": False,
            "published_generation": None,
            "sla_rel": self.config.drift_sla_rel,
            "sla_ok": None,
        }
        on_card = self.device.type == "cuda"
        with telemetry.span("unpack"):
            keys, x = unpack(res.x_slabs)
            if on_card:
                keys, x = (torch.from_numpy(a).to(self.device) for a in (keys, x))
        if self.prev_primal is not None:
            with telemetry.span("drift"):
                if on_card:
                    drift, x_norm, counts = _edge_drift_device(self.prev_primal, (keys, x))
                else:
                    drift, counts = _edge_drift(self.prev_primal, (keys, x))
                    x_norm = float(np.linalg.norm(x))
                reg = telemetry.get_registry()
                for kind, n in zip(("matched", "new", "gone"), counts):
                    reg.inc("drift_edges_total", n, kind=kind)
                report["drift_l2"] = drift
                report["drift_rel"] = drift / max(x_norm, 1e-12)
                resized = (
                    self.lam_prev is not None
                    and tuple(self.lam_prev.shape) != tuple(res.lam.shape)
                )
                if resized:
                    # Dual-dim resize: ||dlam|| is undefined across dual spaces,
                    # so the analytic (sigma ||dlam|| + ||dc||)/gamma bound does
                    # not apply — report it as unbounded rather than letting a
                    # silent dlam=0 make the one cadence guaranteed to churn
                    # look like the quietest (`jsonable` serializes inf NaN-safe
                    # as "inf"; cold_reason carries "dual_dim_drift").
                    report["dual_resized"] = True
                    report["drift_bound"] = float("inf")
                else:
                    dlam = (
                        float(torch.linalg.vector_norm(res.lam - self.lam_prev))
                        if self.lam_prev is not None
                        else 0.0
                    )
                    sigma = float(torch.sqrt(torch.as_tensor(res.sigma_sq)))
                    report["drift_bound"] = drift_bound(
                        gamma_floor, dc_norm=dc_norm, dlam_norm=dlam,
                        sigma_max=sigma,
                    )
                if self.config.drift_sla_rel is not None:
                    report["sla_ok"] = bool(
                        report["drift_rel"] <= self.config.drift_sla_rel
                    )
        with telemetry.span("convergence"):
            self._record_telemetry(res, report, cfg)
        if self.engine_selector is not None and self.config.engine == "auto":
            # feed the routing policy what it routes on: iterations-to-tol,
            # with budget exhaustion flagged as non-convergence
            self.engine_selector.observe(
                self.tenant,
                engine,
                report["iters_used"],
                converged=report["iters_used"] < report["iter_budget"],
            )
        self.lam_prev = res.lam
        self.prev_primal = (keys, x)
        # The solve's sigma estimate (recomputed or echoed) corresponds to
        # the A captured at dispatch time — the caller's `dirty_count`
        # snapshot.  Under the overlapped pipeline a later cadence's
        # A-touching delta may have landed meanwhile; tagging with the
        # dispatch-time count (rather than the current one) keeps such an
        # estimate marked stale.  Callers that cannot snapshot pass None and
        # the estimate is stored but never considered clean.
        self._sigma_sq = float(res.sigma_sq)
        self._sigma_clean_at = -1 if dirty_count is None else dirty_count
        self.warm_level = self._next_warm_level(report)
        self.cadence += 1
        self.last_report = report
        if serving is not None and self.dual_store is not None:
            self._publish_duals(res, serving, gamma_floor, report)
        return report

    def _next_warm_level(self, report: dict[str, Any]) -> int:
        """Escalation level for the NEXT warm solve, from this cadence's drift.

        One level per `warm_escalation` threshold the observed relative drift
        exceeded, plus one when the drift SLA failed outright; 0 when
        escalation is disabled or no drift was measurable yet (first solve).
        The level is recomputed fresh each cadence — a tenant that goes quiet
        de-escalates immediately rather than ratcheting.
        """
        thresholds = self.config.warm_escalation
        if not thresholds:
            return 0
        level = 0
        drift_rel = report.get("drift_rel")
        if drift_rel is not None:
            level = sum(1 for t in sorted(thresholds) if drift_rel > t)
        if report.get("sla_ok") is False:
            level += 1
        return level

    def _publish_duals(
        self,
        res: SolveResult,
        serving: dict[str, Any],
        gamma_floor: float,
        report: dict[str, Any],
    ) -> None:
        """Publish this solve's duals for request serving (atomic slot swap).

        Duals of a normalized solve live in the Jacobi-scaled space
        (lam_original = D lam'); `compute_lam_eff` descales them against the
        dispatch-time device instance, so the serving kernel gathers the raw
        slabs directly.  The snapshot is immutable — queries in flight keep
        serving the previous generation until their next slot read.  On the
        card it carries an event recorded on this thread's stream after
        lam_eff, which every query's stream waits on before reading it.
        """
        from repro_torch.serving.duals import DualSnapshot, compute_lam_eff

        snap = DualSnapshot(
            tenant=self.tenant,
            generation=int(serving["generation"]),
            cadence=report["cadence"],
            gamma=float(gamma_floor),
            lam_eff=compute_lam_eff(
                serving["instance"], res.lam, normalize=self.config.normalize
            ),
            instance=serving["instance"],
            bucket_of=serving["bucket_of"],
            row_of=serving["row_of"],
            deg=serving["deg"],
            ready=_record_event(self.device),
        )
        self.dual_store.publish(snap)
        report["published_generation"] = snap.generation

    def _record_telemetry(
        self, res: SolveResult, report: dict[str, Any], cfg
    ) -> None:
        """Route the finished solve into the metrics registry + stall detector.

        Builds the per-solve `ConvergenceTrace` from the already-returned
        `SolveResult.stats` (one host copy of trace arrays after the fence —
        never a per-iteration sync) and attaches its summary + stall flags to
        the report, so every exporter sees one self-contained record.  PDHG
        stats are one trace entry per residual check, not per iteration;
        `trace_stride` carries that granularity into the trace's budget
        accounting.
        """
        engine = report.get("engine", "agd")
        stride = (
            max(1, min(cfg.check_every, cfg.total_iter_budget))
            if engine == "pdhg"
            else 1
        )
        trace = ConvergenceTrace.from_result(
            res,
            tenant=self.tenant,
            cadence=self.cadence,
            engine=engine,
            mode=report["mode"],
            trace_stride=stride,
        )
        self.last_convergence = trace
        report["convergence"] = trace.summary()
        report["stalled"] = trace.stalled
        trace.record()
        report["stall_flagged"] = self._stall.observe(trace)

        reg = telemetry.get_registry()
        labels = dict(tenant=self.tenant, mode=report["mode"])
        reg.inc("service_solves_total", 1, **labels)
        reg.inc("service_iters_total", report["iters_used"], **labels)
        reg.inc(
            "service_upload_bytes_total",
            report["upload_bytes"] or 0,
            tenant=self.tenant,
        )
        if report["sigma_reused"]:
            reg.inc("service_sigma_reuse_total", 1, tenant=self.tenant)
        if res.restarts:
            reg.inc(
                "engine_restarts_total",
                int(res.restarts),
                tenant=self.tenant,
                engine=engine,
            )
        reg.observe("service_solve_iters", report["iters_used"], mode=report["mode"])
        reg.set_gauge("service_last_g", report["g"], tenant=self.tenant)
        reg.set_gauge(
            "service_last_max_violation",
            report["max_violation"],
            tenant=self.tenant,
        )
        reg.set_gauge("service_cadence", self.cadence, tenant=self.tenant)
        if report["drift_rel"] is not None:
            reg.set_gauge(
                "service_drift_rel", report["drift_rel"], tenant=self.tenant
            )
        if report["sla_ok"] is False:
            reg.inc("service_sla_violations_total", 1, tenant=self.tenant)

    # -- checkpointing -------------------------------------------------------

    def state_dict(self) -> tuple[dict[str, np.ndarray], dict]:
        """(arrays, meta) of everything a restarted service needs to resume warm.

        Covers the duals (`lam_prev`), the edge-space previous primal (drift
        metering), the full ingestor state (slabs + occupancy + generation +
        drift accounting) and the continuation position (`cadence`).  The
        device-resident copy is deliberately NOT saved — it is a cache the
        restored session rebuilds with one upload on first solve.
        """
        arrays, ing_meta = self.ingestor.state_dict()
        arrays = {f"ingestor.{k}": v for k, v in arrays.items()}
        meta = {
            "tenant": self.tenant,
            "cadence": self.cadence,
            "ingestor": ing_meta,
            "has_lam": self.lam_prev is not None,
            "has_primal": self.prev_primal is not None,
            "sigma_clean": bool(self._sigma_clean_at == self._dirty_count),
            # The ingestor generation the sigma-clean claim was made under.
            # `from_state` only honors `sigma_clean` when the restored
            # ingestor proves it is at this exact generation — a checkpoint
            # whose instance arrays were mutated out-of-band (offline delta)
            # must re-run the power iteration.
            "sigma_generation": int(self.ingestor.generation),
            "warm_level": int(self.warm_level),
        }
        if self._sigma_sq is not None:
            arrays["sigma_sq"] = np.asarray(self._sigma_sq, np.float64)
        if self.lam_prev is not None:
            arrays["lam_prev"] = self.lam_prev.detach().cpu().numpy()
        if self.prev_primal is not None:
            for name, a in zip(("primal_keys", "primal_vals"), self.prev_primal):
                arrays[name] = a.cpu().numpy() if isinstance(a, torch.Tensor) else a.copy()
        return arrays, meta

    @classmethod
    def from_state(
        cls,
        config: ServiceConfig,
        arrays: dict[str, np.ndarray],
        meta: dict,
        *,
        device="cuda",
    ) -> "SolveSession":
        """Rebuild a session from `state_dict` output; next solve starts warm."""
        self = cls.__new__(cls)
        self.tenant = meta["tenant"]
        self.config = config
        self.device = resolve_device(device)
        self.ingestor = DeltaIngestor.from_state(
            {
                k[len("ingestor."):]: v
                for k, v in arrays.items()
                if k.startswith("ingestor.")
            },
            meta["ingestor"],
        )
        self.ingestor.telemetry_tenant = self.tenant
        self._stall = StallDetector()
        self.last_convergence = None
        self.lam_prev = (
            torch.from_numpy(np.asarray(arrays["lam_prev"], np.float32).copy()).to(self.device)
            if meta["has_lam"] else None
        )
        self.prev_primal = None
        if meta["has_primal"]:
            keys, vals = arrays["primal_keys"].copy(), arrays["primal_vals"].copy()
            if self.device.type == "cuda":
                keys, vals = (torch.from_numpy(a).to(self.device) for a in (keys, vals))
            self.prev_primal = (keys, vals)
        self.cadence = int(meta["cadence"])
        self.last_ingest = None
        self.last_report = None
        self._device_inst = None
        self._device_generation = -1
        self._pending_plans = []
        self.last_transfer = None
        # older checkpoints carry no sigma cache: resume with a recompute
        self._sigma_sq = (
            float(arrays["sigma_sq"]) if "sigma_sq" in arrays else None
        )
        self._dirty_count = 0
        # Trust the checkpointed sigma cache only when the checkpoint can
        # PROVE the restored instance is the one the estimate was computed
        # over: the clean flag must hold AND the generation recorded at
        # save time must match the restored ingestor's.  An instance mutated
        # offline (a delta applied out-of-band bumps the persisted ingestor
        # generation without touching the session meta) — or an older
        # checkpoint that never recorded the generation — restores dirty,
        # forcing a sigma_max re-estimation on the next solve.
        clean = bool(meta.get("sigma_clean", False)) and (
            meta.get("sigma_generation") == self.ingestor.generation
        )
        self._sigma_clean_at = 0 if clean else -1
        # older checkpoints restore at base level; one noisy cadence re-raises
        self.warm_level = int(meta.get("warm_level", 0))
        self.dual_store = None
        self.engine_selector = None
        return self


def _record_event(device: torch.device):
    """A CUDA event recorded on the current stream of `device` (None on the
    CPU): the point after which a published snapshot's tensors are ready."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _slab_bytes_saved(inst) -> int:
    """Bytes the storage dtype saves vs fp32 slabs (idx/rhs are unaffected).

    Computed from shapes+dtypes only — never forces a device transfer.
    Negative never happens (no slab dtype is wider than fp32).
    """
    saved = 0
    for b in inst.buckets:
        for leaf in (b.coeff, b.cost, b.mask):
            saved += leaf.numel() * (4 - leaf.element_size())
    return saved


def _edge_drift(
    prev: tuple[np.ndarray, np.ndarray], cur: tuple[np.ndarray, np.ndarray]
) -> tuple[float, tuple[int, int, int]]:
    """||x_t - x_{t-1}||_2 over the union of edges (missing edges count 0),
    and the edges (matched, new, gone) it summed over.

    Both inputs are (sorted keys, values) from `DeltaIngestor.unpack_primal`;
    inserted/deleted edges contribute their full allocation to the drift —
    exactly the downstream churn a drift SLA is about.  A CPU session's form,
    bitwise the reference's.
    """
    pk, px = prev
    ck, cx = cur
    sq = 0.0
    if pk.size:
        pos = np.clip(np.searchsorted(pk, ck), 0, pk.size - 1)
        hit = pk[pos] == ck
        sq += float(np.sum((cx[hit] - px[pos[hit]]) ** 2))
        sq += float(np.sum(cx[~hit] ** 2))  # edges new this cadence
        if ck.size:
            pos2 = np.clip(np.searchsorted(ck, pk), 0, ck.size - 1)
            gone = ck[pos2] != pk
        else:
            gone = np.ones(pk.size, bool)
        sq += float(np.sum(px[gone] ** 2))  # edges removed this cadence
        matched = int(np.count_nonzero(hit))
        counts = (matched, ck.size - matched, int(np.count_nonzero(gone)))
    else:
        sq = float(np.sum(cx**2))
        counts = (0, ck.size, 0)
    return float(np.sqrt(sq)), counts


def _edge_drift_device(
    prev: tuple[torch.Tensor, torch.Tensor], cur: tuple[torch.Tensor, torch.Tensor]
) -> tuple[float, float, tuple[int, int, int]]:
    """`_edge_drift` on the tensors' device, with ||x_t||: (drift, ||x_t||,
    (matched, new, gone)).

    One search of the current keys in the previous ones; the previous edges
    that still exist are marked by a scatter of the hits, so no second search
    is needed (the keys are unique).  The float64 parts are the same numbers
    as `_edge_drift`'s, summed in another order; no boolean indexing, so the
    one host read at the end is the only wait for the device.
    """
    pk, px = prev
    ck, cx = cur
    zero, cx2 = cx.new_zeros(()), cx * cx
    if pk.numel():
        pos = torch.searchsorted(pk, ck).clamp_(max=pk.numel() - 1)
        hit = pk[pos] == ck
        found = torch.zeros(pk.numel(), dtype=torch.int32, device=pk.device)
        matched = found.index_add_(0, pos, hit.to(torch.int32)) > 0
        changed = torch.where(hit, (cx - px[pos]) ** 2, zero).sum()
        new = torch.where(hit, zero, cx2).sum()  # edges new this cadence
        gone = torch.where(matched, zero, px * px).sum()  # edges removed this cadence
        n_hit, n_gone = hit.sum(), pk.numel() - matched.sum()
    else:
        changed, new, gone = zero, cx2.sum(), zero
        n_hit = n_gone = torch.zeros((), dtype=torch.int64, device=cx.device)
    parts = torch.stack([changed, new, gone, cx2.sum(), n_hit.to(cx.dtype), n_gone.to(cx.dtype)])
    changed, new, gone, xx, n_hit, n_gone = parts.tolist()  # the one host read
    matched = int(n_hit)
    drift = float(np.sqrt(0.0 + changed + new + gone))
    return drift, float(np.sqrt(xx)), (matched, ck.numel() - matched, int(n_gone))
