"""Named spans inside the train step, recorded only when a caller asks.

The step brackets its parts with `span(name)`: the loss and gradient
(`train.loss_grad`, `launch/steps.py`), the sketch and the fused update
(`train.sketch`, `train.fused_update`, `optim/adamw.py::update_sketched`).
Each span is also a `repro_torch.obs` span of the same name, so one name
shows in the device-time split below and in an exported trace (nested
under `train.step`). With telemetry off and outside `record`, a span does
nothing. Inside `record`, each span takes two markers from the caller's
factory, calls `.record()` on the first before its block and on the
second after it, and appends `(name, start, end)` to the list `record`
yields. On the card the factory is

    lambda: torch.cuda.Event(enable_timing=True)

and `start.elapsed_time(end)` after a synchronize is the span's device
milliseconds. Recording adds two event records a span and no sync.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator

from repro_torch import obs

_marks: list | None = None
_marker: Callable | None = None


@contextlib.contextmanager
def record(marker: Callable) -> Iterator[list]:
    """Turn spans on for the enclosed block; yields the list of
    `(name, start, end)` they append to."""
    global _marks, _marker
    outer = (_marks, _marker)
    _marks, _marker = [], marker
    try:
        yield _marks
    finally:
        _marks, _marker = outer


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    with obs.span(name):
        if _marks is None:
            yield
            return
        marks, start, end = _marks, _marker(), _marker()
        start.record()
        yield
        end.record()
        marks.append((name, start, end))


__all__ = ["record", "span"]
