"""Named spans inside the train step, recorded only when a caller asks.

The step brackets its parts with `span(name)`: the loss and gradient
(`launch/steps.py`), the sketch and the fused update
(`optim/adamw.py::update_sketched`). Outside `record`, a span does
nothing. Inside it, each span takes two markers from the caller's
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
    if _marks is None:
        yield
        return
    marks, start, end = _marks, _marker(), _marker()
    start.record()
    yield
    end.record()
    marks.append((name, start, end))


__all__ = ["record", "span"]
