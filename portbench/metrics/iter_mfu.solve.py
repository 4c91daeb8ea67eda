"""The whole solve's share of the chip's peak: the least time of the work a
solve needs (its oracle calls and power-iteration steps at the roofline,
whichever kernels do them) over the seconds per solve of the traced run's
window, which runs without the profiler (the profiler's own host work
roughly doubles a solve's time in the profiled stretch)."""
from portbench import roofline


def read(trace: dict):
    shapes = trace.get("shapes")
    if shapes is None or not trace.get("solve_s"):
        return None
    bound = roofline.solve_bound_s(shapes, trace["oracle_calls"], trace["power_steps"])
    return 100.0 * bound / trace["solve_s"]
