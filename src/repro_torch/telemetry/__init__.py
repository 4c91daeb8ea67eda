"""Telemetry (port of `repro.telemetry`): metrics registry, span tracing,
convergence telemetry, export.

The observability layer of the recurring-solve path and of one-shot solves.
Four pieces, one import:

  * `MetricsRegistry` (`registry.py`) — thread-safe labelled counters /
    gauges / histograms; `get_registry()` is the process default every
    subsystem records into.
  * `span` (`tracing.py`) — nested wall-clock spans with Chrome-trace
    (Perfetto) export and optional `torch.profiler.record_function`
    pass-through (`Tracer(profiler_annotations=True)`), so span names land
    in `torch.profiler` traces.
  * `ConvergenceTrace` / `StallDetector` (`convergence.py`) — per-solve
    iteration traces lifted from the already-returned solve's `stats`
    (one device-to-host copy per stage), with budget-exhaustion stall
    flagging.
  * `JsonlSink` / `write_prometheus` (`export.py`) — the JSONL record schema
    and Prometheus text exposition.

Instrumentation sites: `instances.deltas` (delta counts, scatter bytes,
rejections), `service.engine` (solver cache hits and first calls),
`core.maximizer` and `core.sharding` (solve and stage spans),
`formulation.formulation` (compile span and counters).  Pure Python: the
registry, tracer and exporters never touch the device.
"""
from repro_torch.telemetry.convergence import (
    ConvergenceTrace,
    StageTrace,
    StallDetector,
)
from repro_torch.telemetry.export import (
    SCHEMA,
    JsonlSink,
    jsonable,
    prometheus_text,
    validate_jsonl,
    validate_record,
    write_prometheus,
)
from repro_torch.telemetry.registry import (
    DEFAULT_BUCKETS,
    HistogramData,
    MetricsRegistry,
    get_registry,
    set_registry,
)
from repro_torch.telemetry.tracing import Tracer, get_tracer, set_tracer, span

__all__ = [
    "ConvergenceTrace",
    "StageTrace",
    "StallDetector",
    "SCHEMA",
    "JsonlSink",
    "jsonable",
    "prometheus_text",
    "validate_jsonl",
    "validate_record",
    "write_prometheus",
    "DEFAULT_BUCKETS",
    "HistogramData",
    "MetricsRegistry",
    "get_registry",
    "set_registry",
    "Tracer",
    "get_tracer",
    "set_tracer",
    "span",
]
