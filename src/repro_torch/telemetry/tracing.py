"""Span tracing: nested wall-clock spans with Chrome-trace (Perfetto) export
(port of `repro.telemetry.tracing`).

    with span("cadence", tenant="t0"):
        with span("solve", mode="warm"):
            ...

Spans nest per thread (a thread-local stack), record wall-clock durations,
and serialize as Chrome trace events (``{"traceEvents": [...]}``) loadable in
Perfetto / chrome://tracing.  When a tracer is constructed with
``profiler_annotations=True`` (the reference's ``jax_annotations``) each span
additionally enters a `torch.profiler.record_function` range, so the same
span names land inside `torch.profiler` traces — one instrumentation site,
both timelines.

Tracing is cheap but not free (two clock reads + a list append per span), so
spans wrap cadence/solve/stage granularity, never the per-iteration AGD body.
A span reads only the host clock: it never synchronizes with the device, so
a span around device work measures its enqueue, not its execution.

The event buffer is bounded (`max_events`); overflow drops new events and
counts them (`dropped`), so a long-running service cannot leak memory through
its own observability layer.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Iterator, Optional

__all__ = ["Span", "Tracer", "get_tracer", "set_tracer", "span"]


class Span:
    """One open span; exposed so callers can attach late attributes."""

    __slots__ = ("name", "args", "t0", "wall0", "depth", "parent")

    def __init__(self, name: str, args: dict, depth: int, parent: Optional["Span"]):
        self.name = name
        self.args = args
        self.t0 = time.perf_counter()
        self.wall0 = time.time()
        self.depth = depth
        self.parent = parent

    def set(self, **attrs) -> None:
        """Attach attributes to the span while it is open."""
        self.args.update(attrs)


class Tracer:
    """Collects nested spans into a Chrome-trace-event buffer."""

    def __init__(
        self,
        *,
        profiler_annotations: bool = False,
        max_events: int = 100_000,
    ):
        self._lock = threading.Lock()
        self._events: list[dict[str, Any]] = []
        self._stacks = threading.local()
        self.profiler_annotations = profiler_annotations
        self.max_events = int(max_events)
        self.dropped = 0
        # perf_counter origin so event timestamps start near zero
        self._origin = time.perf_counter()

    # -- span lifecycle ------------------------------------------------------

    def _stack(self) -> list[Span]:
        st = getattr(self._stacks, "stack", None)
        if st is None:
            st = self._stacks.stack = []
        return st

    def current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    @contextlib.contextmanager
    def span(self, name: str, **args) -> Iterator[Span]:
        stack = self._stack()
        sp = Span(name, dict(args), depth=len(stack), parent=self.current())
        stack.append(sp)
        ann = None
        if self.profiler_annotations:
            import torch.profiler

            ann = torch.profiler.record_function(name)
            ann.__enter__()
        try:
            yield sp
        finally:
            if ann is not None:
                ann.__exit__(None, None, None)
            stack.pop()
            self._emit(sp, time.perf_counter())

    def _emit(self, sp: Span, t1: float) -> None:
        event = {
            "name": sp.name,
            "ph": "X",  # complete event: ts + dur
            "ts": (sp.t0 - self._origin) * 1e6,  # microseconds
            "dur": (t1 - sp.t0) * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident() % 2**31,
            "args": _jsonable(sp.args),
        }
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(event)

    # -- export --------------------------------------------------------------

    def events(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def to_chrome_trace(self) -> dict[str, Any]:
        """Chrome trace-event JSON object (Perfetto / chrome://tracing)."""
        return {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def export_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
            f.write("\n")

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0


def _jsonable(obj):
    """Best-effort conversion of span args to JSON-able values."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    try:  # numpy scalars and 0-d tensors (a CUDA one waits for its value)
        return float(obj)
    except (TypeError, ValueError):
        return repr(obj)


_default = Tracer()
_default_lock = threading.Lock()


def get_tracer() -> Tracer:
    return _default


def set_tracer(tracer: Tracer) -> Tracer:
    """Install `tracer` as the process default; returns the previous one."""
    global _default
    with _default_lock:
        prev = _default
        _default = tracer
    return prev


def span(name: str, **args):
    """`with span("cadence", tenant=...):` against the process-default tracer."""
    return _default.span(name, **args)
