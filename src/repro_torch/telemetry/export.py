"""Exporters: JSONL sink, Prometheus text exposition, record schema (port of
`repro.telemetry.export`).

The JSONL schema is the stable contract between the service and everything
downstream (perf-trajectory tooling, the bench-history artifact, CI's
`tools/check_metrics.py`).  Every record is one JSON object per line:

    {"ts": <unix seconds>, "kind": "<kind>", "payload": {...}}

with per-kind required payload keys listed in `SCHEMA`.  Adding payload keys
is backward compatible; removing or renaming a required key is a schema break
and must update `SCHEMA` (and the golden-key test) in the same change.

`write_prometheus` renders a registry snapshot in Prometheus text exposition
format (the file a node_exporter-style textfile collector or any scraper
sidecar can serve); counters get `_total`-style TYPE lines, histograms emit
cumulative `_bucket{le=...}` series plus `_sum`/`_count`.
"""
from __future__ import annotations

import json
import math
import re
import threading
import time
from typing import Any, Optional

from repro_torch.telemetry.registry import MetricsRegistry, get_registry

__all__ = [
    "SCHEMA",
    "JsonlSink",
    "jsonable",
    "validate_record",
    "validate_jsonl",
    "prometheus_text",
    "write_prometheus",
]

# kind -> required payload keys.  Keys may hold null; they must be present.
SCHEMA: dict[str, tuple[str, ...]] = {
    # one per tenant solve: the session's drift-SLA report
    "solve_report": (
        "tenant",
        "cadence",
        "mode",
        "engine",
        "iters_used",
        "iter_budget",
        "g",
        "max_violation",
        "dc_norm",
        "upload_mode",
        "upload_bytes",
        "drift_rel",
        "drift_bound",
        "sla_ok",
    ),
    # one per tenant solve: ConvergenceTrace.summary()
    "convergence": (
        "tenant",
        "cadence",
        "engine",
        "iters_used",
        "stage_budgets",
        "total_iters_used",
        "total_budget",
        "stalled",
        "g_final",
        "max_violation_final",
    ),
    # one per scheduler cadence
    "cadence": (
        "cadence",
        "tenants",
        "batched_fraction",
        "upload_bytes",
        "overlapped",
        "wall_seconds",
    ),
    # one per delta ingestion
    "ingest": ("tenant", "in_place", "n_insert", "n_delete", "n_update"),
    # registry snapshot (typically the final record of a run)
    "counters": ("counters", "gauges", "histograms"),
    # one per benchmark harness run (benchmarks/run.py --bench-history)
    "bench": ("suite", "quick", "results"),
    # one per served allocation batch (repro.serving; benchmarks/serving_latency)
    "serving_query": ("tenant", "generation", "users", "latency_seconds"),
}


def jsonable(obj: Any) -> Any:
    """Deep-convert numpy scalars and arrays and tensors to JSON-able values."""
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, (str, int, bool)) or obj is None:
        return obj
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else repr(obj)
    if hasattr(obj, "tolist"):  # numpy arrays and scalars, tensors
        return jsonable(obj.tolist())
    if hasattr(obj, "item"):
        return jsonable(obj.item())
    try:
        return float(obj)
    except (TypeError, ValueError):
        return repr(obj)


class JsonlSink:
    """Append-only JSONL writer for telemetry records (thread-safe).

    Opens lazily, appends by default (the perf-trajectory use case: each run
    adds timestamped records, nothing is overwritten), and flushes per record
    so a crashed run still leaves a valid prefix.
    """

    def __init__(self, path: str, *, append: bool = True):
        self.path = path
        self._mode = "a" if append else "w"
        self._lock = threading.Lock()
        self._fh = None

    def emit(self, kind: str, payload: dict[str, Any], *, ts: Optional[float] = None) -> None:
        if kind not in SCHEMA:
            raise ValueError(f"unknown telemetry record kind: {kind!r}")
        record = {
            "ts": float(time.time() if ts is None else ts),
            "kind": kind,
            "payload": jsonable(payload),
        }
        line = json.dumps(record, sort_keys=True)
        with self._lock:
            if self._fh is None:
                self._fh = open(self.path, self._mode)
                self._mode = "a"
            self._fh.write(line + "\n")
            self._fh.flush()

    def emit_counters(self, registry: Optional[MetricsRegistry] = None) -> None:
        """Append one `counters` record holding a full registry snapshot."""
        reg = registry or get_registry()
        self.emit("counters", reg.snapshot())

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- validation (tools/check_metrics.py) -------------------------------------


def validate_record(obj: Any) -> list[str]:
    """Schema errors of one decoded JSONL record ([] when valid)."""
    errors = []
    if not isinstance(obj, dict):
        return [f"record is not an object: {type(obj).__name__}"]
    ts = obj.get("ts")
    if not isinstance(ts, (int, float)):
        errors.append("missing/non-numeric 'ts'")
    kind = obj.get("kind")
    if kind not in SCHEMA:
        return errors + [f"unknown kind {kind!r}"]
    payload = obj.get("payload")
    if not isinstance(payload, dict):
        return errors + ["missing/non-object 'payload'"]
    for key in SCHEMA[kind]:
        if key not in payload:
            errors.append(f"kind {kind!r}: payload missing required key {key!r}")
    return errors


def validate_jsonl(path: str) -> tuple[int, list[str]]:
    """(num_records, errors) of a JSONL export file."""
    errors: list[str] = []
    n = 0
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            n += 1
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"line {lineno}: invalid JSON ({e})")
                continue
            errors.extend(f"line {lineno}: {e}" for e in validate_record(obj))
    return n, errors


# -- Prometheus text exposition ----------------------------------------------

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_OK = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(name: str) -> str:
    name = _NAME_OK.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _labels_text(labels: dict[str, str], extra: Optional[dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        f'{_LABEL_OK.sub("_", str(k))}="{_escape(str(v))}"'
        for k, v in sorted(merged.items())
    )
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 2**53 else repr(f)


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """Registry snapshot in Prometheus text exposition format."""
    reg = registry or get_registry()
    series = reg.series()
    lines: list[str] = []
    typed: set[str] = set()

    def type_line(name: str, kind: str) -> None:
        if name not in typed:
            lines.append(f"# TYPE {name} {kind}")
            typed.add(name)

    for name, labels, value in series["counters"]:
        pname = _metric_name(name)
        type_line(pname, "counter")
        lines.append(f"{pname}{_labels_text(labels)} {_fmt(value)}")
    for name, labels, value in series["gauges"]:
        pname = _metric_name(name)
        type_line(pname, "gauge")
        lines.append(f"{pname}{_labels_text(labels)} {_fmt(value)}")
    for name, labels, hist in series["histograms"]:
        pname = _metric_name(name)
        type_line(pname, "histogram")
        cum = 0
        for i, le in enumerate(hist.buckets):
            cum += hist.counts[i]
            lines.append(
                f"{pname}_bucket{_labels_text(labels, {'le': _fmt(le)})} {cum}"
            )
        cum += hist.counts[-1]
        lines.append(
            f"{pname}_bucket{_labels_text(labels, {'le': '+Inf'})} {cum}"
        )
        lines.append(f"{pname}_sum{_labels_text(labels)} {_fmt(hist.sum)}")
        lines.append(f"{pname}_count{_labels_text(labels)} {hist.count}")
    return "\n".join(lines) + "\n"


def write_prometheus(
    path: str, registry: Optional[MetricsRegistry] = None
) -> None:
    """Write the snapshot atomically (scrapers never see a partial file)."""
    import os

    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(prometheus_text(registry))
    os.replace(tmp, path)
