"""Milliseconds per cadence in the scheduler's `absorb` span (host clock; a
span never waits for the device), over the window of the traced run."""


def read(trace: dict):
    spans = trace.get("span_ms") or {}
    if "absorb" not in spans or not trace.get("span_units"):
        return None
    return spans["absorb"] / trace["span_units"]
