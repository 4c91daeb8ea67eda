"""Recurring-solve service (port of `repro.service`), the single-tenant
engine so far: the solver caches over the engines, the device upload and
the O(delta) scatter-plan replay (`engine`).  The sessions, the scheduler
and the batched tenant pool are not ported yet."""
from repro_torch.service.engine import (
    RawSolve,
    apply_scatter_plan,
    compile_cache_report,
    compiled_solver,
    compiled_solver_fixed_sigma,
    device_put_instance,
    instance_nbytes,
    to_solve_result,
)

__all__ = [
    "RawSolve",
    "compiled_solver",
    "compiled_solver_fixed_sigma",
    "to_solve_result",
    "compile_cache_report",
    "device_put_instance",
    "apply_scatter_plan",
    "instance_nbytes",
]
