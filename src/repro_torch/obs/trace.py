"""Nested-span tracer with Chrome/Perfetto trace-event export.

`Tracer` records complete spans ("ph": "X") and instant events ("ph": "i")
on a monotonic microsecond clock. Nesting is CONTEXT-LOCAL: the open-span
stack lives in a `contextvars.ContextVar`, so threads (which start from the
default context) each get their own stack and cannot corrupt each other's
nesting, while the recorded event list is a single lock-protected buffer —
spans from a background thread (e.g. the `AsyncCheckpointer` writer) land
in the SAME trace on their own `tid` lane, sharing one timeline with the
caller's spans. That is exactly what the Perfetto UI renders: one process
row, one track per thread.

Every span also enters `torch.profiler.record_function(name)` and, when
the process has CUDA, an NVTX range of the same name, so a torch.profiler
(or NVTX-reading) capture of the same region lines up name-for-name with
the host spans exported here. Span times are host-clock microseconds.
Port of `repro/obs/trace.py`.

Export misuse is a typed `ValueError` that survives ``python -O``:
exporting while spans are still open would emit a trace whose durations
lie, so `export`/`to_chrome` refuse until every span has exited.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
from typing import Any

import torch

# Open-span depth stack, context-local: a fresh thread/context starts at
# depth 0 with no parent, matching Perfetto's per-track nesting model.
_SPAN_STACK: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_torch_obs_span_stack", default=())


def _now_us() -> float:
    return time.monotonic_ns() / 1e3


def _jsonable(v: Any):
    """Coerce an attribute value to something json.dumps accepts."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    return str(v)


class SpanHandle:
    """The object a `Tracer.span(...)` scope yields.

    `set(**attrs)` adds/overrides attributes after the span opened — used
    by call sites that only learn a tag mid-region (e.g. the resolved
    dispatch route). Attributes land in the Chrome event's `args`.
    """

    __slots__ = ("name", "attrs", "t0", "depth")

    def __init__(self, name: str, attrs: dict, t0: float, depth: int):
        self.name = name
        self.attrs = attrs
        self.t0 = t0
        self.depth = depth

    def set(self, **attrs) -> "SpanHandle":
        self.attrs.update(attrs)
        return self


class Tracer:
    """Thread-safe span/instant recorder with Chrome trace-event export."""

    def __init__(self, *, pid: int | None = None):
        self.pid = os.getpid() if pid is None else pid
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._open = 0          # spans entered but not yet exited (global)

    # -- recording -------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Record one complete span around the with-body.

        Nesting depth comes from the context-local stack; the body also
        runs under `torch.profiler.record_function(name)` (and an NVTX
        range on CUDA) so device-side profiles align with this span.
        """
        stack = _SPAN_STACK.get()
        handle = SpanHandle(name, dict(attrs), _now_us(), len(stack))
        token = _SPAN_STACK.set(stack + (name,))
        with self._lock:
            self._open += 1
        tid = threading.get_ident()
        try:
            with _device_scope(name):
                yield handle
        finally:
            t1 = _now_us()
            _SPAN_STACK.reset(token)
            ev = {"name": handle.name, "ph": "X", "ts": handle.t0,
                  "dur": max(0.0, t1 - handle.t0), "pid": self.pid,
                  "tid": tid,
                  "args": {k: _jsonable(v) for k, v in handle.attrs.items()}}
            if handle.depth:
                ev["args"]["depth"] = handle.depth
            with self._lock:
                self._events.append(ev)
                self._open -= 1

    def instant(self, name: str, **attrs) -> None:
        """Record a zero-duration marker (straggler, alert, fallback...)."""
        ev = {"name": name, "ph": "i", "ts": _now_us(), "s": "t",
              "pid": self.pid, "tid": threading.get_ident(),
              "args": {k: _jsonable(v) for k, v in attrs.items()}}
        with self._lock:
            self._events.append(ev)

    # -- introspection ---------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self) -> list[dict]:
        """A snapshot copy of the recorded events (chronological append
        order; spans append at EXIT, instants at their timestamp)."""
        with self._lock:
            return [dict(e) for e in self._events]

    def open_spans(self) -> int:
        with self._lock:
            return self._open

    # -- export ----------------------------------------------------------
    def to_chrome(self) -> dict:
        """The trace as a Chrome/Perfetto trace-event JSON object.

        Raises a typed `ValueError` (never a bare assert — must fire under
        ``python -O``) when spans are still open: their durations do not
        exist yet and exporting would silently drop or misreport them.
        """
        with self._lock:
            if self._open:
                raise ValueError(
                    f"cannot export a trace with {self._open} unclosed "
                    "span(s): exit every tracer.span(...) scope first")
            events = [dict(e) for e in self._events]
        events.sort(key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path) -> int:
        """Write the Chrome trace JSON to `path`; returns #events."""
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return len(doc["traceEvents"])

    def clear(self) -> None:
        with self._lock:
            if self._open:
                raise ValueError(
                    f"cannot clear a trace with {self._open} unclosed "
                    "span(s)")
            self._events.clear()


_HAS_CUDA: bool | None = None


def _has_cuda() -> bool:
    global _HAS_CUDA
    if _HAS_CUDA is None:
        _HAS_CUDA = bool(torch.cuda.is_available())
    return _HAS_CUDA


@contextlib.contextmanager
def _device_scope(name: str):
    """torch.profiler.record_function + an NVTX range around a span body.

    record_function only shows when torch.profiler is capturing, the NVTX
    range only to a tool reading NVTX; both are entered only while
    telemetry is enabled (the disabled path never reaches a tracer).
    """
    nvtx = _has_cuda()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
