"""Telemetry (port of `repro.telemetry`): metrics registry, span tracing,
convergence telemetry, export.

The observability layer of the recurring-solve path and of one-shot solves.
Four pieces, one import:

  * `MetricsRegistry` (`registry.py`) — thread-safe labelled counters /
    gauges / histograms; `get_registry()` is the process default every
    subsystem records into.
  * `span` (`tracing.py`) — nested spans with Chrome-trace (Perfetto)
    export, off until a `Tracer` is installed (`set_tracer`); host
    wall-clock durations, the device's clock where a span asks for it
    (`device=` a card), and optional `torch.profiler.record_function`
    pass-through (`Tracer(profiler_annotations=True)`), so span names land
    in `torch.profiler` traces.
  * `ConvergenceTrace` / `StallDetector` (`convergence.py`) — per-solve
    iteration traces lifted from the already-returned solve's `stats`
    (one device-to-host copy per stage), with budget-exhaustion stall
    flagging.
  * `JsonlSink` / `write_prometheus` (`export.py`) — the JSONL record schema
    and Prometheus text exposition.

Instrumentation sites: `instances.deltas` (delta counts, scatter bytes,
rejections; the ingest's phase spans), `instances.buckets` (the `pack`
span, slots packed), `core.objective` (the `normalize` span),
`service.engine` (solver cache hits and first calls), `service.scheduler`
and `service.session` (cadence,
solve, replay and absorb spans), `engines.agd`, `core.maximizer` and
`core.sharding` (power-iteration and stage spans),
`formulation.formulation` (compile span and counters).  The registry and
exporters are pure Python; the tracer touches the device only to record
the CUDA events of a `device=` span.
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
