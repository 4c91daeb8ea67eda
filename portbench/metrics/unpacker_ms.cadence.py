"""Milliseconds per cadence in the scheduler's `unpacker` spans (host clock):
building the primal unpacker at dispatch (`DeltaIngestor.primal_unpacker`,
which repeats and argsorts every edge key), over the window of the traced
run.  A part of `dispatch_ms.cadence`."""


def read(trace: dict):
    spans = trace.get("span_ms") or {}
    if "unpacker" not in spans or not trace.get("span_units"):
        return None
    return spans["unpacker"] / trace["span_units"]
