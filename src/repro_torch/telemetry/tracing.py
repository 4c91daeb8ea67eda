"""Span tracing: nested spans with Chrome-trace (Perfetto) export (port of
`repro.telemetry.tracing`).

    set_tracer(Tracer())                  # the process default records nothing
    with span("cadence", tenant="t0"):
        with span("solve", device=lam.device, mode="warm"):
            ...

Tracing is off by default: the process default is a `NullTracer`, whose
`span()` returns one shared no-op context manager (no clock read, no `Span`,
no lock), so instrumented code costs a call and nothing more until a
`Tracer` is installed with `set_tracer`.  The metrics registry is separate
and always on.

A recording `Tracer` keeps spans per thread (a thread-local stack), records
host wall-clock durations and serializes them as Chrome trace events
(``{"traceEvents": [...]}``) loadable in Perfetto / chrome://tracing.  Each
event carries an ``id`` and a ``parent``: the id of the span that was open
on the same thread when it began, or the one passed as ``parent=`` (work
handed to another thread names the span that dispatched it).  When a tracer
is constructed with ``profiler_annotations=True`` (the reference's
``jax_annotations``) each span additionally enters a
`torch.profiler.record_function` range, so the same span names land inside
`torch.profiler` traces — one instrumentation site, both timelines.

The host clock never waits for the device, so a span around device work
measures its enqueue.  ``span(name, device=d)`` adds the device's clock:
where `d` (a `torch.device`) is a card, the span records a timing CUDA
event on that card's current stream when it opens and another when it
closes, and the pair is resolved into ``args["device_ms"]`` only when
`events()` or an export is called, never on the hot path.  That reading is
the stream's time between the span's two ends: the device work enqueued
inside the span, plus any time the stream sat waiting for the host to
enqueue more.  On the CPU, or with ``device=None`` (the default), a span
reads the host clock alone.

Spans wrap cadence / solve / stage granularity, never the per-iteration AGD
body or a per-edit loop.  The event buffer is bounded (`max_events`);
overflow drops new events and counts them (`dropped`), so a long-running
service cannot leak memory through its own observability layer.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Iterator, Optional

__all__ = ["NullTracer", "Span", "Tracer", "get_tracer", "set_tracer", "span"]


class Span:
    """One open span; exposed so callers can attach late attributes and read
    its ``id`` (to pass as another span's ``parent``)."""

    __slots__ = ("name", "args", "t0", "id", "parent")

    def __init__(self, name: str, args: dict, span_id: int, parent: Optional[int]):
        self.name = name
        self.args = args
        self.t0 = time.perf_counter()
        self.id = span_id
        self.parent = parent

    def set(self, **attrs) -> None:
        """Attach attributes to the span while it is open."""
        self.args.update(attrs)


class _NullSpan:
    """The no-op span (and its own context manager) of the `NullTracer`."""

    __slots__ = ()
    id = None
    parent = None

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Export:
    """Chrome-trace export over a tracer's `events()` and `dropped`."""

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


class NullTracer(_Export):
    """The process default: records nothing, and its exports are empty."""

    profiler_annotations = False
    recording = False
    dropped = 0

    def span(self, name: str, **args) -> _NullSpan:
        return _NULL_SPAN

    def current(self) -> None:
        return None

    def events(self) -> list[dict[str, Any]]:
        return []

    def reset(self) -> None:
        pass


def _device_stream(device):
    """The current CUDA stream of the span's `device`, or None where the work
    does not run on a card."""
    if device is None or device.type != "cuda":
        return None
    import torch

    return torch.cuda.current_stream(device)


def _mark(stream):
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class Tracer(_Export):
    """Collects nested spans into a Chrome-trace-event buffer."""

    recording = True

    def __init__(
        self,
        *,
        profiler_annotations: bool = False,
        max_events: int = 100_000,
    ):
        self._lock = threading.Lock()
        self._resolve_lock = threading.Lock()
        self._events: list[dict[str, Any]] = []
        # (event, start, end) CUDA event pairs not yet read into device_ms
        self._pending: list[tuple] = []
        self._stacks = threading.local()
        self._ids = itertools.count(1)
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
    def span(self, name: str, *, device=None, parent: Optional[int] = None,
             **args) -> Iterator[Span]:
        """Open a span; ``parent`` overrides the span open on this thread,
        ``device`` adds the device clock (module docstring)."""
        stack = self._stack()
        if parent is None and stack:
            parent = stack[-1].id
        sp = Span(name, dict(args), next(self._ids), parent)
        stack.append(sp)
        ann = None
        if self.profiler_annotations:
            import torch.profiler

            ann = torch.profiler.record_function(name)
            ann.__enter__()
        stream = _device_stream(device)
        start = _mark(stream) if stream is not None else None
        try:
            yield sp
        finally:
            marks = (start, _mark(stream)) if start is not None else None
            if ann is not None:
                ann.__exit__(None, None, None)
            stack.pop()
            self._emit(sp, time.perf_counter(), marks)

    def _emit(self, sp: Span, t1: float, marks) -> None:
        event = {
            "name": sp.name,
            "ph": "X",  # complete event: ts + dur
            "ts": (sp.t0 - self._origin) * 1e6,  # microseconds
            "dur": (t1 - sp.t0) * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident() % 2**31,
            "id": sp.id,
            "parent": sp.parent,
            "args": _jsonable(sp.args),
        }
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(event)
            if marks is not None:
                self._pending.append((event, *marks))

    def _resolve(self) -> None:
        """Read every pending CUDA event pair into its event's device_ms
        (waits for the device work the spans enqueued)."""
        with self._resolve_lock:
            with self._lock:
                pending, self._pending = self._pending, []
            for event, start, end in pending:
                end.synchronize()
                event["args"]["device_ms"] = start.elapsed_time(end)

    # -- export --------------------------------------------------------------

    def events(self) -> list[dict[str, Any]]:
        self._resolve()
        with self._lock:
            return list(self._events)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._pending.clear()
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


_default = NullTracer()
_default_lock = threading.Lock()


def get_tracer():
    """The process default tracer (a `NullTracer` until one is installed)."""
    return _default


def set_tracer(tracer):
    """Install `tracer` as the process default; returns the previous one."""
    global _default
    with _default_lock:
        prev = _default
        _default = tracer
    return prev


def span(name: str, **args):
    """`with span("cadence", tenant=...):` against the process-default tracer."""
    return _default.span(name, **args)
