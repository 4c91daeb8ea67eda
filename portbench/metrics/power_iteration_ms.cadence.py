"""Milliseconds per cadence in the warm solve's power iteration, by CUDA
events recorded around each `MatchingObjective.power_iteration` call of the
traced run's window (the device clock, so the device's own time)."""


def read(trace: dict):
    if not trace.get("units") or "power_iteration_ms" not in trace:
        return None
    return trace["power_iteration_ms"] / trace["units"]
