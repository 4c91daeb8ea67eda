"""Milliseconds of the card's time in the program's `pack` span of set-up
(`instances/buckets.py` `bucketize`: the edge list on the card to the slabs
on the card), read from the span's CUDA events; none on the CPU."""


def read(trace: dict):
    span = (trace.get("setup_spans") or {}).get("pack") or {}
    v = span.get("device_ms")
    return None if v is None else float(v)
