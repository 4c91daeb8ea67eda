"""Microseconds of host ingest per delta edit: the scheduler's `ingest` span
a cadence over the traced run's window (host clock), over the edits a
delta carries, which is the program's `delta_edits_total` (every op) over
its `deltas_applied_total` in this process's metrics registry.  Every
cadence of the cell ingests one delta, and every delta of the pool has as
many edits, so this is the window's ingest time over the window's edits.
The cell's driver (`drivers/cadence.py`) hands over no count of the
window's edits; once it does, divide by that instead, since a mix of
deltas of different sizes would be read wrong here without any error."""


def read(trace: dict):
    from repro_torch import telemetry

    spans = trace.get("span_ms") or {}
    if "ingest" not in spans or not trace.get("span_units"):
        return None
    reg = telemetry.get_registry()
    edits, deltas = reg.counter_total("delta_edits_total"), reg.counter_total("deltas_applied_total")
    if not edits or not deltas:
        return None
    return 1e3 * spans["ingest"] / trace["span_units"] / (edits / deltas)
