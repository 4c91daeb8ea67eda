"""Multi-tenant cadence scheduler: ingest, group, batch, solve, report
(port of `repro.service.scheduler`).

One `Scheduler` owns all tenant `SolveSession`s and drives a cadence:

  1. apply each tenant's `InstanceDelta` on the host slabs (O(delta) in-place
     when headroom allows — see `repro_torch.instances.deltas`), queueing the
     emitted scatter plans for the device-resident copies;
  2. partition tenants by `(shape_signature, warm/cold, warm gamma schedule,
     sigma-reuse readiness)` — shape-identical tenants in the same start
     mode, at the same warm-escalation level, with uniform power-iteration
     skip eligibility (and the same routed engine) can share one batched
     solve;
  3. groups of >= `batch_min` tenants are solved by ONE batched call through
     the shared engine; the rest solve individually (still sharing the
     shape-keyed solver caches).  Solves run against device-resident slabs,
     so the per-cadence host→device transfer is the scatter plans, O(delta);
  4. every tenant's session absorbs its result and emits its drift-SLA report.

`run_cadence` is the synchronous single-step driver.  `run_pipeline` is the
double-buffered multi-cadence driver.  The port's solve is a host loop that
waits for the device once per early-stopping chunk, so the overlap is made
explicit: `_dispatch` groups the tenants and syncs every device copy on the
calling thread (replaying the pending scatter plans, capturing what serving
will publish), then the solves of cadence t run on a solver thread, on its
own CUDA stream (which first waits on an event recorded after the replays),
while the calling thread validates and ingests cadence t+1 on the host.
The fence is the thread's join plus a synchronisation of the solver stream;
only then are results absorbed.  The kernels launch on the current stream
of the thread that calls them, and the C calls release the GIL, but the
ingest is a Python loop that holds it, so the overlap is partial; the share
of the solve window spent ingesting is the `scheduler_overlap_efficiency`
gauge.

Fencing invariants of the overlap:

  * Host ingestion for cadence t+1 mutates only the host slabs and queues
    plans; the device copies the solves read were synced at dispatch time,
    and a replay builds new tensors for the buckets it touches (never in
    place), so the in-flight solve of cadence t can never observe cadence
    t+1 edits.
  * A delta rejected during the overlap raises inside `DeltaIngestor.apply`
    *before* any mutation: the host slabs, the scatter-plan queue and the
    per-tenant generation counter are untouched, so nothing half-applies and
    cadence t+1 simply solves the last good state (the rejection is reported
    in `CadenceReport.ingest_errors`).
  * Results are absorbed only after the fence, so drift metering always
    compares completed cadence t against completed cadence t-1.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.device import resolve_device
from repro_torch.engines.selector import EngineSelector
from repro_torch.instances.deltas import DeltaReport, InstanceDelta
from repro_torch.instances.generator import EdgeListInstance
from repro_torch.service.engine import (
    compile_cache_report,
    to_solve_result,
)
from repro_torch.service.pool import BatchedSolvePool, shape_signature
from repro_torch.service.session import ServiceConfig, SolveSession

__all__ = ["CadenceReport", "Scheduler"]


@dataclasses.dataclass
class CadenceReport:
    """Outcome of one scheduler cadence (`run_cadence` / `run_pipeline` step)."""

    reports: dict[str, dict[str, Any]]  # per-tenant solve reports
    ingest: dict[str, DeltaReport]  # per-tenant delta reports
    batched_groups: list[list[str]]  # tenant groups solved in one batched call
    solo_tenants: list[str]
    compile_cache: dict[str, int]
    # deltas rejected during ingestion (pipeline mode): tenant -> error; the
    # tenant's state is untouched and it solved the last good generation
    ingest_errors: dict[str, str] = dataclasses.field(default_factory=dict)
    # True when this cadence's ingest ran overlapped with the previous solve
    overlapped: bool = False

    @property
    def batched_fraction(self) -> float:
        """Fraction of tenants solved inside a batched pool group."""
        n = len(self.reports)
        return sum(len(g) for g in self.batched_groups) / max(n, 1)

    @property
    def upload_bytes(self) -> int:
        """Total host→device bytes this cadence's solves transferred."""
        return sum(r.get("upload_bytes") or 0 for r in self.reports.values())


@dataclasses.dataclass
class _Dispatched:
    """One cadence's solves: chosen and synced on the calling thread, run by
    `Scheduler._start` (inline, or on the solver thread), fenced by
    `Scheduler._fence`.  `batched` entries are [names, cold, solve, reuse]
    and `solo` entries [name, cold, solve, reuse]; `_start` replaces each
    `solve` thunk with its `RawSolve`."""

    batched: list
    solo: list
    starts: dict
    serving: dict
    thread: Optional[threading.Thread] = None
    stream: Optional[object] = None
    error: Optional[Exception] = None


class Scheduler:
    """Owns all tenant sessions and drives synchronous or pipelined cadences.
    Every session solves on `device` (default "cuda", which raises without
    a card)."""

    def __init__(
        self,
        config: Optional[ServiceConfig] = None,
        *,
        batch_min: int = 2,
        dual_store=None,
        device="cuda",
    ):
        self.config = config or ServiceConfig()
        self.device = resolve_device(device)
        # the pipelined solves' stream (on the card), made at first use
        self._solver_stream = None
        self.batch_min = max(2, int(batch_min))
        self.sessions: dict[str, SolveSession] = {}
        # Per-tenant engine routing policy (`config.engine == "auto"`):
        # the scheduler owns it so observations from every tenant land in
        # one place and the state checkpoints with the service
        # (meta["engine_selector"]).  Constructed even when the engine is
        # pinned — attaching costs nothing and a config flip mid-life
        # starts routing from whatever history accumulated.
        self.engine_selector = EngineSelector()
        # Attached allocation-serving store (repro_torch.serving.DualStore): when
        # set, every tenant session publishes its duals after absorb, so
        # requests are answered from the last COMPLETED cadence while the
        # next one is still in flight (the store's snapshot swap is the
        # generation fence; see docs/serving.md).
        self.dual_store = dual_store

    def add_tenant(self, name: str, inst: EdgeListInstance) -> SolveSession:
        """Register a tenant with its bootstrap instance (cold first solve)."""
        if name in self.sessions:
            raise ValueError(f"tenant {name!r} already registered")
        s = SolveSession(name, inst, self.config, device=self.device)
        s.dual_store = self.dual_store
        s.engine_selector = self.engine_selector
        self.sessions[name] = s
        return s

    # -- cadence phases ------------------------------------------------------

    def _ingest_all(
        self, deltas: Optional[dict[str, InstanceDelta]], *, strict: bool
    ) -> tuple[dict[str, DeltaReport], dict[str, str]]:
        """Apply per-tenant deltas on the host; collect rejections if not strict."""
        ingest: dict[str, DeltaReport] = {}
        errors: dict[str, str] = {}
        for name, delta in (deltas or {}).items():
            try:
                ingest[name] = self.sessions[name].ingest(delta)
            except (KeyError, ValueError) as e:
                if strict:
                    raise
                errors[name] = f"{type(e).__name__}: {e}"
        return ingest, errors

    def _dispatch(self, force_cold: bool) -> _Dispatched:
        """Group tenants, sync their device copies and choose every solve;
        the solves themselves run in `_start`.

        Everything that reads the sessions' host state (start states, cost
        drift, unpackers, device replays, serving captures) happens here, on
        the calling thread, so `run_pipeline` can ingest the next cadence
        while `_start`'s solves run.
        """
        groups: dict[tuple, list[str]] = {}
        starts: dict[str, tuple] = {}
        for name, s in self.sessions.items():
            cold, reason, lam0 = s._start_state(force_cold)
            # Snapshot NOW everything absorb will need after the fence: the
            # cost drift drained for THIS cadence, a primal unpacker frozen
            # over this generation's occupancy maps, and the sigma dirty
            # count the solve's A corresponds to.  Deltas ingested during
            # the overlap then cannot be attributed to — or corrupt the
            # drift metering / sigma-cache validity of — the in-flight solve.
            dc_norm = s.ingestor.drain_cost_drift()
            # The engine is part of the dispatch decision: resolved HERE
            # (possibly through the selector) so the choice is frozen with
            # the rest of the start snapshot and reported after the fence.
            engine = s.engine_choice()
            with telemetry.span("unpacker", tenant=name):
                unpacker = s.ingestor.primal_unpacker()
            starts[name] = (
                cold,
                reason,
                lam0,
                dc_norm,
                unpacker,
                s._dirty_count,
                engine,
            )
            # Batching key beyond shape+mode: the escalation-chosen warm
            # gamma schedule (tenants at different escalation levels run
            # different continuation tails), sigma-reuse readiness (the
            # fixed-sigma batched solver skips the power iteration for ALL
            # lanes, so a group must be uniformly ready or uniformly not),
            # and the routed engine (a batched solve runs ONE engine).
            reuse = (not cold) and s.sigma_reuse_ready(dc_norm)
            warm_key = None if cold else s.warm_config().gammas
            key = (
                shape_signature(s.instance()), cold, warm_key, reuse, engine,
            )
            groups.setdefault(key, []).append(name)

        batched: list[list] = []
        solo: list[list] = []
        for (_, cold, _, reuse, engine), names in groups.items():
            cfg = (
                self.config.cold
                if cold
                else self.sessions[names[0]].warm_config()
            )
            if len(names) >= self.batch_min:
                pool = BatchedSolvePool(
                    cfg,
                    normalize=self.config.normalize,
                    fused_oracle=self.config.fused_oracle,
                    engine=engine,
                )
                solve = functools.partial(
                    pool.solve_async,
                    [self.sessions[n].device_instance() for n in names],
                    [starts[n][2] for n in names],
                    sigma_sqs=(
                        [self.sessions[n]._sigma_sq for n in names]
                        if reuse
                        else None
                    ),
                )
                self._record_group_padding(names)
                batched.append([list(names), cold, solve, reuse])
            else:
                for name in names:
                    # prepare_raw owns the per-tenant power-iteration skip
                    # on quiet warm cadences (recomputing `reuse` there is
                    # equivalent — same inputs)
                    solve, solo_reuse = self.sessions[name].prepare_raw(
                        cfg, starts[name][2], starts[name][3], cold=cold,
                        engine=engine,
                    )
                    solo.append([name, cold, solve, solo_reuse])
        # Serving capture runs after every dispatch path has synced its
        # device copy, so the captured instance + occupancy maps reflect
        # exactly the generation this cadence is solving; absorb publishes
        # the finished duals against that capture (None without a store).
        serving = {
            name: s.serving_capture() for name, s in self.sessions.items()
        }
        return _Dispatched(batched, solo, starts, serving)

    def _record_group_padding(self, names: Sequence[str]) -> None:
        """Padding waste of one batched group, from host-side occupancy.

        The pool itself records batch sizes and padded-cell counts; active
        cells per tenant are only known host-side (`DeltaIngestor.deg`), so
        the nnz-based waste fraction is recorded here without touching the
        device-resident slabs.
        """
        reg = telemetry.get_registry()
        cells = active = 0
        for n in names:
            ing = self.sessions[n].ingestor
            cells += sum(
                int(np.prod(b.idx.shape)) for b in ing.instance().buckets
            )
            active += ing.nnz
        if cells:
            reg.set_gauge(
                "pool_padding_waste",
                1.0 - active / cells,
                group=",".join(sorted(names)[:4]),
            )

    def _run(self, d: _Dispatched, parent: Optional[int] = None) -> None:
        """Run each dispatched solve inside a `solve` span; `parent` is the
        dispatching cadence's span id where the solves run on another
        thread than the cadence's."""
        for entry in d.batched + d.solo:
            batched = isinstance(entry[0], list)  # solo entries name one tenant
            with telemetry.span("solve", device=self.device, parent=parent,
                                tenants=entry[0] if batched else [entry[0]],
                                mode="cold" if entry[1] else "warm", batched=batched):
                entry[2] = entry[2]()

    def _start(self, d: _Dispatched, *, overlap: bool,
               parent: Optional[int] = None) -> None:
        """Run the dispatched solves: inline, or (``overlap``) on a solver
        thread, on the card on the scheduler's own stream, which first waits
        for everything the calling thread enqueued (the replays); the solver
        thread's `solve` spans name `parent` (the cadence's span id)."""
        if not overlap:
            self._run(d)
            return
        if self.device.type == "cuda":
            if self._solver_stream is None:
                self._solver_stream = torch.cuda.Stream(self.device)
            d.stream = self._solver_stream
            synced = torch.cuda.Event()
            synced.record(torch.cuda.current_stream(self.device))

        def work():
            try:
                if d.stream is None:
                    self._run(d, parent)
                    return
                with torch.cuda.device(self.device), torch.cuda.stream(d.stream):
                    d.stream.wait_event(synced)
                    self._run(d, parent)
            except Exception as e:  # re-raised by _fence on the caller
                d.error = e

        d.thread = threading.Thread(target=work, name="solver", daemon=True)
        d.thread.start()

    @staticmethod
    def _fence(d: _Dispatched) -> None:
        """Block until every dispatched solve's device work is complete: the
        solver thread's join, then its stream's synchronisation."""
        if d.thread is not None:
            d.thread.join()
        if d.error is not None:
            raise d.error
        if d.stream is not None:
            d.stream.synchronize()

    def _absorb(self, d: _Dispatched):
        """Fold finished solves into their sessions; build per-tenant reports."""
        batched, solo, starts, serving = d.batched, d.solo, d.starts, d.serving
        reports: dict[str, dict[str, Any]] = {}
        batched_groups: list[list[str]] = []
        solo_names: list[str] = []
        for names, cold, raw, reuse in batched:
            batched_groups.append(list(names))
            with telemetry.span("solve_wait", tenants=list(names)):
                results = BatchedSolvePool.finish(raw)
            for name, res in zip(names, results):
                reports[name] = self.sessions[name].absorb(
                    res,
                    cold=cold,
                    cold_reason=starts[name][1],
                    batched=True,
                    dc_norm=starts[name][3],
                    unpack=starts[name][4],
                    sigma_reused=reuse,
                    dirty_count=starts[name][5],
                    serving=serving[name],
                    engine=starts[name][6],
                )
        for name, cold, raw, sigma_reused in solo:
            solo_names.append(name)
            with telemetry.span("solve_wait", tenants=[name]):
                res = to_solve_result(raw)
            reports[name] = self.sessions[name].absorb(
                res,
                cold=cold,
                cold_reason=starts[name][1],
                batched=False,
                dc_norm=starts[name][3],
                unpack=starts[name][4],
                sigma_reused=sigma_reused,
                dirty_count=starts[name][5],
                serving=serving[name],
                engine=starts[name][6],
            )
        return reports, batched_groups, solo_names

    # -- drivers -------------------------------------------------------------

    def run_cadence(
        self,
        deltas: Optional[dict[str, InstanceDelta]] = None,
        *,
        force_cold: bool = False,
    ) -> CadenceReport:
        """Ingest deltas and solve every tenant once (synchronous driver).
        The `cadence` span's `index` is the cadence's place among this
        call's cadences, as in `run_pipeline`: here always 0."""
        t0 = time.perf_counter()
        with telemetry.span("cadence", driver="sync", index=0,
                            tenants=len(self.sessions)):
            with telemetry.span("ingest"):
                ingest, _ = self._ingest_all(deltas, strict=True)
            with telemetry.span("dispatch"):
                dispatched = self._dispatch(force_cold)
            with telemetry.span("solve_fence"):  # the solves run here, inline
                self._start(dispatched, overlap=False)
                self._fence(dispatched)
            with telemetry.span("absorb"):
                reports, batched_groups, solo = self._absorb(dispatched)
        self._record_cadence(time.perf_counter() - t0, overlapped=False)
        return CadenceReport(
            reports=reports,
            ingest=ingest,
            batched_groups=batched_groups,
            solo_tenants=solo,
            compile_cache=compile_cache_report(),
        )

    def run_pipeline(
        self,
        cadence_deltas: Sequence[Optional[dict[str, InstanceDelta]]],
        *,
        force_cold: bool = False,
    ) -> list[CadenceReport]:
        """Run several cadences with host ingest overlapped against device solves.

        ``cadence_deltas[t]`` are the deltas ingested *for* cadence t; while
        cadence t's solves run on device, cadence t+1's deltas are validated
        and applied on the host (scatter plans queued, device copies
        untouched).  Rejected deltas never half-apply — they surface in the
        next cadence's `ingest_errors` and that tenant solves its last good
        state.  Equivalent to a `run_cadence` loop, minus the host-ingest
        wall time.
        """
        deltas = list(cadence_deltas)
        reg = telemetry.get_registry()
        out: list[CadenceReport] = []
        with telemetry.span("pipeline_ingest", cadence_index=0):
            ingest, errors = self._ingest_all(
                deltas[0] if deltas else None, strict=False
            )
        if errors:
            reg.inc("scheduler_ingest_errors_total", len(errors))
        for t in range(len(deltas)):
            # cadences not yet dispatched, including this one — the host-side
            # backlog a stuck device solve would grow
            reg.set_gauge("scheduler_queue_depth", len(deltas) - t)
            t0 = time.perf_counter()
            with telemetry.span("cadence", driver="pipeline", index=t) as cad:
                with telemetry.span("dispatch"):
                    dispatched = self._dispatch(force_cold)
                    self._start(dispatched, overlap=True, parent=cad.id)
                t_dispatched = time.perf_counter()
                if t + 1 < len(deltas):
                    # the overlap: host-side validation + slab surgery + plan
                    # construction for cadence t+1 while cadence t solves
                    with telemetry.span("overlap_ingest", cadence_index=t + 1):
                        next_ingest, next_errors = self._ingest_all(
                            deltas[t + 1], strict=False
                        )
                else:
                    next_ingest, next_errors = {}, {}
                t_ingested = time.perf_counter()
                with telemetry.span("solve_fence"):
                    self._fence(dispatched)
                t_fenced = time.perf_counter()
                with telemetry.span("absorb"):
                    reports, batched_groups, solo = self._absorb(dispatched)
            # Overlap efficiency: what fraction of the device-solve window
            # (dispatch -> fence completion) the host spent doing next-cadence
            # ingest work.  1.0 means ingest was entirely hidden; ~0 means the
            # host sat idle (or there was nothing to ingest).
            solve_window = max(t_fenced - t_dispatched, 1e-9)
            overlap = min((t_ingested - t_dispatched) / solve_window, 1.0)
            reg.set_gauge("scheduler_overlap_efficiency", overlap)
            reg.inc(
                "scheduler_overlap_ingest_seconds_total",
                t_ingested - t_dispatched,
            )
            reg.inc("scheduler_solve_window_seconds_total", solve_window)
            if next_errors:
                reg.inc("scheduler_ingest_errors_total", len(next_errors))
            self._record_cadence(time.perf_counter() - t0, overlapped=t > 0)
            out.append(
                CadenceReport(
                    reports=reports,
                    ingest=ingest,
                    batched_groups=batched_groups,
                    solo_tenants=solo,
                    compile_cache=compile_cache_report(),
                    ingest_errors=errors,
                    overlapped=t > 0,
                )
            )
            ingest, errors = next_ingest, next_errors
        reg.set_gauge("scheduler_queue_depth", 0)
        return out

    def _record_cadence(self, wall_seconds: float, *, overlapped: bool) -> None:
        reg = telemetry.get_registry()
        reg.inc("scheduler_cadences_total", 1)
        reg.set_gauge("scheduler_tenants", len(self.sessions))
        reg.observe(
            "scheduler_cadence_seconds",
            wall_seconds,
            overlapped=str(overlapped).lower(),
        )

    # -- checkpointing -------------------------------------------------------

    def state_dict(self) -> tuple[dict[str, Any], dict]:
        """(arrays, meta) of every tenant session, namespaced by tenant name.

        ``meta["telemetry"]`` carries the registry's cumulative counters
        (cadence totals, upload-bytes totals, rejection counts, ...), so a
        restarted service resumes its monotone series instead of silently
        resetting them to zero — restart-invariant rate queries downstream.
        """
        arrays: dict[str, Any] = {}
        meta: dict = {"tenants": {}}
        for name, s in self.sessions.items():
            s_arrays, s_meta = s.state_dict()
            for k, v in s_arrays.items():
                arrays[f"{name}/{k}"] = v
            meta["tenants"][name] = s_meta
        meta["telemetry"] = telemetry.get_registry().state_dict()
        meta["engine_selector"] = self.engine_selector.state_dict()
        return arrays, meta

    def load_state(self, arrays: dict[str, Any], meta: dict) -> None:
        """Rebuild all tenant sessions from `state_dict` output (warm resume)."""
        self.sessions = {}
        for name, s_meta in meta["tenants"].items():
            prefix = f"{name}/"
            s_arrays = {
                k[len(prefix):]: v
                for k, v in arrays.items()
                if k.startswith(prefix)
            }
            self.sessions[name] = SolveSession.from_state(
                self.config, s_arrays, s_meta, device=self.device
            )
            self.sessions[name].dual_store = self.dual_store
            self.sessions[name].engine_selector = self.engine_selector
        # older checkpoints (pre-telemetry) carry no counter state: keep zeros
        if "telemetry" in meta:
            telemetry.get_registry().load_state(meta["telemetry"])
        # pre-engine checkpoints carry no routing history: start exploring
        self.engine_selector.load_state(meta.get("engine_selector"))

    def save_checkpoint(self, manager, step: int, *, block: bool = False) -> None:
        """Persist every session through a `checkpoint.CheckpointManager`.

        Async by default (`block=False`): the state is snapshotted
        synchronously, the file write happens on the manager's background
        thread while the next cadence proceeds.
        """
        arrays, meta = self.state_dict()
        manager.save(step, arrays, block=block, meta=meta)

    def restore_checkpoint(self, manager, step: int) -> None:
        """Rebuild all sessions from a checkpoint; next cadence resumes warm."""
        arrays, meta = manager.restore_flat(step)
        self.load_state(arrays, meta)
