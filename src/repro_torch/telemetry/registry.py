"""Thread-safe in-process metrics registry: counters, gauges, histograms
(port of `repro.telemetry.registry`, line for line).

Every subsystem (delta ingestion, the solver caches, the maximizers, the
formulation compile) records into one process-wide `MetricsRegistry`, and
exporters (`telemetry.export`) serialize lock-consistent snapshots as JSONL
records or Prometheus text exposition.

Design constraints:

  * **Thread safety** — all mutation and the `snapshot()` read path take one
    registry lock, so a snapshot is a consistent point-in-time view even
    while another thread is incrementing (the reference's scheduler ingests
    on one thread while a solve runs on another).
  * **Hot-path cost** — recording is a dict upsert under a lock (no I/O, no
    device sync).  Nothing here runs per AGD iteration: convergence traces
    are read from the already-materialized `SolveResult.stats` after the
    solve (see `telemetry.convergence`).
  * **Labels** — every series is keyed by `(name, sorted(label items))`, the
    Prometheus data model; tenant / cadence / shard / entry-point labels keep
    fleet-wide aggregation and per-tenant drill-down in the same store.
  * **Restart continuity** — `state_dict()` / `load_state()` round-trip the
    cumulative counters (not the gauges or histograms), so totals survive a
    restart instead of silently resetting to zero.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Iterable, Optional

__all__ = [
    "DEFAULT_BUCKETS",
    "HistogramData",
    "MetricsRegistry",
    "get_registry",
    "set_registry",
]

# Geometric 1-2.5-5 decades: spans microseconds-scale durations through
# multi-GB byte counters without per-metric bucket configuration.
DEFAULT_BUCKETS: tuple[float, ...] = tuple(
    m * 10.0**e for e in range(-4, 10) for m in (1.0, 2.5, 5.0)
)

LabelKey = tuple[tuple[str, str], ...]


def _label_key(labels: dict[str, Any]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


@dataclasses.dataclass
class HistogramData:
    """Cumulative-bucket histogram (Prometheus semantics) plus min/max."""

    buckets: tuple[float, ...] = DEFAULT_BUCKETS
    counts: list[int] = dataclasses.field(default_factory=list)  # len(buckets)+1
    count: int = 0
    sum: float = 0.0
    min: float = math.inf
    max: float = -math.inf

    def __post_init__(self):
        if not self.counts:
            self.counts = [0] * (len(self.buckets) + 1)

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        for i, le in enumerate(self.buckets):
            if value <= le:
                self.counts[i] += 1
                return
        self.counts[-1] += 1  # +Inf bucket

    def to_dict(self) -> dict[str, Any]:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": None if self.count == 0 else self.min,
            "max": None if self.count == 0 else self.max,
            # sparse non-zero buckets: {upper_bound: count}
            "buckets": {
                ("+Inf" if i == len(self.buckets) else repr(self.buckets[i])): c
                for i, c in enumerate(self.counts)
                if c
            },
        }


class MetricsRegistry:
    """One process-wide store of labelled counters, gauges and histograms."""

    def __init__(self, histogram_buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        self._lock = threading.Lock()
        self._buckets = tuple(histogram_buckets)
        self._counters: dict[tuple[str, LabelKey], float] = {}
        self._gauges: dict[tuple[str, LabelKey], float] = {}
        self._hists: dict[tuple[str, LabelKey], HistogramData] = {}

    # -- recording (hot path: one lock, one dict upsert) ---------------------

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        """Add `value` to a monotonically increasing counter series."""
        key = (name, _label_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + float(value)

    def set_gauge(self, name: str, value: float, **labels) -> None:
        """Set a point-in-time gauge series (last write wins)."""
        with self._lock:
            self._gauges[(name, _label_key(labels))] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        """Record one observation into a histogram series."""
        key = (name, _label_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = HistogramData(buckets=self._buckets)
            h.observe(float(value))

    # -- reads ---------------------------------------------------------------

    def counter_value(self, name: str, **labels) -> float:
        with self._lock:
            return self._counters.get((name, _label_key(labels)), 0.0)

    def counter_total(self, name: str) -> float:
        """Sum of a counter across all label sets."""
        with self._lock:
            return sum(
                v for (n, _), v in self._counters.items() if n == name
            )

    def gauge_value(self, name: str, **labels) -> Optional[float]:
        with self._lock:
            return self._gauges.get((name, _label_key(labels)))

    def snapshot(self) -> dict[str, Any]:
        """Lock-consistent JSON-able copy of every series.

        Series are rendered as ``name{k=v,...}`` strings, which keeps the
        snapshot flat (one key per series) and stable to iterate in tests and
        exporters.
        """
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: h.to_dict() for k, h in self._hists.items()}

        def render(store: dict) -> dict[str, Any]:
            return {
                _series_name(name, lk): v
                for (name, lk), v in sorted(store.items())
            }

        return {
            "counters": render(counters),
            "gauges": render(gauges),
            "histograms": render(hists),
        }

    def series(self) -> dict[str, list]:
        """Raw (name, labels, value) triples per kind — the exporter view."""
        with self._lock:
            return {
                "counters": [
                    (n, dict(lk), v) for (n, lk), v in sorted(self._counters.items())
                ],
                "gauges": [
                    (n, dict(lk), v) for (n, lk), v in sorted(self._gauges.items())
                ],
                "histograms": [
                    (n, dict(lk), dataclasses.replace(h, counts=list(h.counts)))
                    for (n, lk), h in sorted(self._hists.items())
                ],
            }

    # -- restart continuity ---------------------------------------------------

    def state_dict(self) -> dict[str, Any]:
        """JSON-able cumulative state: the counters (gauges and histograms
        are point-in-time / distributional views that a restarted service
        legitimately rebuilds; counters are the totals that must not reset)."""
        with self._lock:
            return {
                "counters": [
                    [name, [list(kv) for kv in lk], value]
                    for (name, lk), value in sorted(self._counters.items())
                ]
            }

    def load_state(self, state: dict[str, Any]) -> None:
        """Restore checkpointed counter totals (replacing current values)."""
        with self._lock:
            for name, lk, value in state.get("counters", []):
                key = (name, tuple((str(k), str(v)) for k, v in lk))
                self._counters[key] = float(value)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


def _series_name(name: str, lk: LabelKey) -> str:
    if not lk:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in lk) + "}"


# One default registry per process; the service stack records here unless a
# caller installs its own (tests isolate with set_registry(MetricsRegistry())).
_default = MetricsRegistry()
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    return _default


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Install `registry` as the process default; returns the previous one."""
    global _default
    with _default_lock:
        prev = _default
        _default = registry
    return prev
