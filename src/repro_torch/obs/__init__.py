"""repro_torch.obs — the telemetry layer (spans + metrics + distortion).

Port of `repro/obs`. OFF by default, and safe to leave wired into every
hot path: when disabled, `obs.span(...)` returns a shared no-op context
and `obs.counter/gauge/histogram` return inert singletons — the cost is
one module-global read per call.

    from repro_torch import obs

    ctx = obs.enable()                       # Tracer + MetricsRegistry
    ...run a serve replay / train steps...
    ctx.tracer.export("trace.json")          # open in ui.perfetto.dev
    ctx.metrics.write_jsonl("metrics.jsonl")
    obs.disable()

or the one-shot form (used by launch/serve_rp.py --trace-out):

    with obs.capture(trace_path="trace.json",
                     metrics_path="metrics.jsonl") as ctx:
        ...

State is a MODULE GLOBAL, not a contextvar: background threads must land
their spans in the SAME trace as the main thread — Perfetto renders them
as separate tracks of one timeline. Span NESTING stays context-local
inside `Tracer`, so threads cannot corrupt each other's span stacks.

Every span also enters `torch.profiler.record_function` (and an NVTX
range on CUDA), so a torch.profiler capture lines up with the host spans.
Span times are host-clock.

Wired call sites (all behind the disabled fast path):
  rp.dispatch        — per-dispatch spans tagged (family, structure,
                       order, backend, pipeline, plan)
  serve.engine       — per-tick spans, queue-delay histograms, distortion
                       feed for dense payloads
  runtime.train_loop — per-step spans (`train.step`), the
                       `train.straggler`, `ckpt.resume` and
                       `ckpt.fallback` events
  runtime.spans      — the train step's parts (`train.loss_grad`,
                       `train.sketch`, `train.fused_update`) as nested spans
  ckpt.checkpointer  — `ckpt.save` (on the async writer's own thread),
                       `ckpt.verify`, `ckpt.restore` spans
  optim.compress     — the cross-pod formulations' gauge
                       `rp/wire_bytes_per_step` and counter
                       `rp/collective_traces`

The port runs eagerly, so dispatch spans fire on every call, including
every step of a train loop (the reference's jitted step dispatches once,
at trace time); for the same reason `rp/collective_traces` counts every
call of `compress_per_pod` / `compress_collective`, where the
reference's counts jit traces.
"""
from __future__ import annotations

import contextlib
import dataclasses

from .distortion import DistortionAlert, DistortionMonitor, required_k
from .metrics import (LATENCY_BOUNDS_US, Counter, Gauge, Histogram,
                      MetricsRegistry, read_jsonl)
from .trace import SpanHandle, Tracer

__all__ = [
    "Counter", "DistortionAlert", "DistortionMonitor", "Gauge", "Histogram",
    "LATENCY_BOUNDS_US", "MetricsRegistry", "ObsContext", "SpanHandle",
    "Tracer", "capture", "counter", "disable", "enable", "enabled", "event",
    "gauge", "get_context", "get_distortion", "get_metrics", "get_tracer",
    "histogram", "instant", "read_jsonl", "required_k", "span",
]


@dataclasses.dataclass
class ObsContext:
    """One enabled telemetry session: tracer + metrics (+ distortion)."""

    tracer: Tracer
    metrics: MetricsRegistry
    distortion: DistortionMonitor | None = None


# The enabled session, or None. Read on every obs.* call — keep it a plain
# module global so the disabled fast path is one LOAD_GLOBAL + is-check.
_STATE: ObsContext | None = None


class _NoopSpan:
    """Shared inert span: context manager + SpanHandle surface, no state."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


class _NoopInstrument:
    """Shared inert counter/gauge/histogram."""

    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NOOP_SPAN = _NoopSpan()
_NOOP_INSTRUMENT = _NoopInstrument()


def enable(*, tracer: Tracer | None = None,
           metrics: MetricsRegistry | None = None,
           distortion: DistortionMonitor | None = None) -> ObsContext:
    """Install (and return) the process-wide telemetry session.

    A `DistortionMonitor` passed here gets its alerts mirrored into the
    metrics event log and the trace (as instants) automatically. Calling
    `enable` while already enabled replaces the session — the old context
    object stays valid for export.
    """
    global _STATE
    ctx = ObsContext(tracer=tracer or Tracer(),
                     metrics=metrics or MetricsRegistry(),
                     distortion=distortion)
    if distortion is not None and distortion.on_alert is None:
        def _on_alert(alert, ctx=ctx):
            ev = alert.as_event()
            name = ev.pop("name")
            ctx.metrics.event(name, **ev)
            ctx.tracer.instant(name, **ev)
        distortion.on_alert = _on_alert
    _STATE = ctx
    return ctx


def disable() -> ObsContext | None:
    """Tear down the session; returns it so callers can still export."""
    global _STATE
    ctx, _STATE = _STATE, None
    return ctx


def enabled() -> bool:
    return _STATE is not None


def get_context() -> ObsContext | None:
    return _STATE


def get_tracer() -> Tracer | None:
    s = _STATE
    return s.tracer if s is not None else None


def get_metrics() -> MetricsRegistry | None:
    s = _STATE
    return s.metrics if s is not None else None


def get_distortion() -> DistortionMonitor | None:
    s = _STATE
    return s.distortion if s is not None else None


# -- the hot-path entry points (no-ops when disabled) ---------------------

def span(name: str, **attrs):
    """A tracer span scope, or the shared no-op when telemetry is off."""
    s = _STATE
    if s is None:
        return _NOOP_SPAN
    return s.tracer.span(name, **attrs)


def instant(name: str, **attrs) -> None:
    s = _STATE
    if s is not None:
        s.tracer.instant(name, **attrs)


def event(name: str, **attrs) -> None:
    """A structured event: metrics event log + trace instant, both."""
    s = _STATE
    if s is not None:
        s.metrics.event(name, **attrs)
        s.tracer.instant(name, **attrs)


def counter(name: str):
    s = _STATE
    return _NOOP_INSTRUMENT if s is None else s.metrics.counter(name)


def gauge(name: str):
    s = _STATE
    return _NOOP_INSTRUMENT if s is None else s.metrics.gauge(name)


def histogram(name: str, bounds=LATENCY_BOUNDS_US):
    s = _STATE
    return (_NOOP_INSTRUMENT if s is None
            else s.metrics.histogram(name, bounds))


@contextlib.contextmanager
def capture(*, trace_path=None, metrics_path=None,
            distortion: DistortionMonitor | None = None):
    """enable() for a scope; export to the given paths on clean exit."""
    ctx = enable(distortion=distortion)
    try:
        yield ctx
    finally:
        disable()
        if trace_path is not None and ctx.tracer.open_spans() == 0:
            ctx.tracer.export(trace_path)
        if metrics_path is not None:
            ctx.metrics.write_jsonl(metrics_path)
