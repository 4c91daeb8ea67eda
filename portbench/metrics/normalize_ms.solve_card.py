"""Milliseconds of the card's time in the program's `normalize` span of
set-up (`core/objective.py` `normalize_rows`: Jacobi scaling of the packed
slabs on the card), read from the span's CUDA events; none on the CPU."""


def read(trace: dict):
    span = (trace.get("setup_spans") or {}).get("normalize") or {}
    v = span.get("device_ms")
    return None if v is None else float(v)
