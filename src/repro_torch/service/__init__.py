"""Recurring-solve service (port of `repro.service`): the serving loop of
production cadences.

    Scheduler.run_cadence({tenant: delta})
        |
        |-- SolveSession.ingest(delta)          session.py
        |       DeltaIngestor applies edge inserts/deletes and cost/rhs
        |       updates IN PLACE on the bucketed-ELL host slabs (O(delta),
        |       shapes preserved; re-bucketize only on headroom overflow)
        |-- group tenants by (shape signature, warm/cold, warm schedule,
        |       sigma reuse, engine)             scheduler.py
        |-- solve
        |       groups  -> ONE batched continuation solve over a leading
        |                  tenant dimension (pool.py / engine.py; with the
        |                  fused oracle one kernel call per iteration for
        |                  the whole group)
        |       singles -> per-tenant solve
        |       warm starts resume from yesterday's duals on a shortened
        |       continuation tail, with per-stage early stopping
        '-- per-tenant drift-SLA report, and (with a DualStore attached) the
                duals published for serving (repro_torch.serving)

Slabs are device-resident across cadences: each applied delta emits an
O(delta) `ScatterPlan` that `engine.apply_scatter_plan` replays on the
device copy, bit-for-bit equal to re-uploading.  `Scheduler.run_pipeline`
overlaps the host ingest of cadence t+1 with the solves of cadence t (a
solver thread on its own CUDA stream), and sessions checkpoint through
`repro_torch.checkpoint.CheckpointManager` in the reference's format.
"""
from repro_torch.service.engine import (
    RawSolve,
    apply_scatter_plan,
    compile_cache_report,
    compiled_batch_solver,
    compiled_batch_solver_fixed_sigma,
    compiled_solver,
    compiled_solver_fixed_sigma,
    device_put_instance,
    instance_nbytes,
    to_solve_result,
    to_solve_results,
)
from repro_torch.service.pool import BatchedSolvePool, shape_signature, stack_instances
from repro_torch.service.scheduler import CadenceReport, Scheduler
from repro_torch.service.session import ServiceConfig, SolveSession

__all__ = [
    "RawSolve",
    "compiled_solver",
    "compiled_solver_fixed_sigma",
    "compiled_batch_solver",
    "compiled_batch_solver_fixed_sigma",
    "to_solve_result",
    "to_solve_results",
    "compile_cache_report",
    "device_put_instance",
    "apply_scatter_plan",
    "instance_nbytes",
    "BatchedSolvePool",
    "shape_signature",
    "stack_instances",
    "CadenceReport",
    "Scheduler",
    "ServiceConfig",
    "SolveSession",
]
