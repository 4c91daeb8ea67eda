"""Kernel 1's share of its HBM roofline: the least time of one dual-oracle
call (its bytes from the instance's shapes, `portbench.roofline`) over the
profiler's device time of the oracle's kernels per call (`oracle_narrow`,
`oracle_wide` and `oracle_finalize`; one finalize per call)."""
from portbench import roofline


def read(trace: dict):
    p, shapes = trace.get("profiled"), trace.get("shapes")
    if p is None or shapes is None:
        return None
    calls, _ = p.kernel_time(r"oracle_finalize")
    _, secs = p.kernel_time(r"oracle_(narrow|wide|finalize)")
    if calls == 0 or secs <= 0:
        return None
    bound = roofline.bound_s(roofline.oracle_call_bytes(shapes),
                             roofline.oracle_call_flops(shapes))
    return 100.0 * bound / (secs / calls)
