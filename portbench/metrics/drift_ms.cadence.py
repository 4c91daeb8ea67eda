"""Milliseconds per cadence in absorb's `unpack` and `drift` spans (host
clock): the primal copied to the host and keyed by edge, then its drift
against the previous cadence's (`_edge_drift`) and the analytic bound, over
the window of the traced run.  A part of `absorb_ms.cadence`."""


def read(trace: dict):
    spans = trace.get("span_ms") or {}
    if "unpack" not in spans or "drift" not in spans or not trace.get("span_units"):
        return None
    return (spans["unpack"] + spans["drift"]) / trace["span_units"]
