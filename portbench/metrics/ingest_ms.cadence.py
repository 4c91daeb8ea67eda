"""Milliseconds per cadence in the scheduler's `ingest` span (host clock; a
span never waits for the device), over the window of the traced run."""


def read(trace: dict):
    spans = trace.get("span_ms") or {}
    if "ingest" not in spans or not trace.get("span_units"):
        return None
    return spans["ingest"] / trace["span_units"]
