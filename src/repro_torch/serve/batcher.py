"""Request queue + dynamic batch assembler (port of `repro/serve/batcher.py`).

Requests arrive one at a time (dense tensors / flat vectors, possibly
length-ragged) and are queued into LANES keyed by `(spec, seed,
structure)`. Everything inside one lane coalesces into ONE
`rp.project_many` dispatch — ragged flat lengths zero-pad — so a batcher
TICK flushes exactly one lane and costs exactly one kernel dispatch, which
`rp.dispatch_stats()` can assert end-to-end.

Flush policy (the `ServeConfig` knobs):
  * max-batch  — a lane that reaches `max_batch` requests is ready;
  * max-latency — a lane whose OLDEST request has waited `flush_us`
    (trace-clock) microseconds is ready even when short.
`next_batch` serves the ready lane with the oldest head (FIFO across
lanes), preferring fullness only as a tiebreak — tail latency wins over
occupancy when both policies fire at once.

The clock is EXPLICIT (`now` in microseconds, floats): the batcher never
reads wall time, so traces replay deterministically and tests/benchmarks
control latency outcomes exactly.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

from repro_torch.rp import ProjectorSpec
from repro_torch.rp.plan import structure_tag  # noqa: F401  (lane key)

from .config import ServeConfig


@dataclasses.dataclass
class SketchRequest:
    """One in-flight sketching request.

    Filled in by the engine on completion: `sketch` (the (k,) result),
    `t_done`, and `store_id` when the sketch was ingested into the store.
    """

    rid: int
    payload: Any
    spec: ProjectorSpec
    seed: int = 0
    t_submit: float = 0.0
    t_done: float | None = None
    sketch: Any = None
    store_id: int | None = None

    @property
    def done(self) -> bool:
        return self.t_done is not None

    @property
    def latency_us(self) -> float:
        if self.t_done is None:
            raise ValueError(f"request {self.rid} is not done yet")
        return self.t_done - self.t_submit


@dataclasses.dataclass(frozen=True)
class LaneKey:
    spec: ProjectorSpec
    seed: int
    structure: str


class DynamicBatcher:
    """Lane-keyed FIFO queues with a max-batch / max-latency flush policy."""

    def __init__(self, cfg: ServeConfig):
        self.cfg = cfg
        self._lanes: dict[LaneKey, deque[SketchRequest]] = {}

    # -- queueing --------------------------------------------------------
    def submit(self, req: SketchRequest) -> LaneKey:
        key = LaneKey(req.spec, int(req.seed), structure_tag(req.payload))
        self._lanes.setdefault(key, deque()).append(req)
        return key

    def pending(self) -> int:
        return sum(len(q) for q in self._lanes.values())

    def lanes(self) -> int:
        return len(self._lanes)

    # -- flush policy ----------------------------------------------------
    def _lane_ready(self, q: deque, now: float) -> bool:
        # NB: `now >= t_submit + flush_us`, the SAME float expression
        # `next_deadline` returns — writing it as `now - t_submit >=
        # flush_us` can round the other way, leaving a lane not-ready at
        # its own deadline (an infinite replay loop).
        return (len(q) >= self.cfg.max_batch
                or now >= q[0].t_submit + self.cfg.flush_us)

    def ready(self, now: float) -> bool:
        return any(self._lane_ready(q, now) for q in self._lanes.values())

    def next_deadline(self) -> float | None:
        """Earliest instant at which some lane becomes latency-ready.

        The trace replayer advances its clock to this between arrivals, so
        idle queues still flush at `t_submit + flush_us` — None when empty.
        """
        heads = [q[0].t_submit for q in self._lanes.values() if q]
        if not heads:
            return None
        return min(heads) + self.cfg.flush_us

    def next_batch(self, now: float, *, force: bool = False
                   ) -> tuple[LaneKey, list[SketchRequest]] | None:
        """Pop one tick's batch: up to `max_batch` requests from ONE lane.

        Serves the ready lane with the oldest head request (FIFO fairness
        across lanes; lane fullness breaks ties). `force=True` flushes the
        oldest lane even before its deadline — the end-of-trace drain.
        Returns None when nothing is (or, under force, nothing at all is)
        queued.
        """
        candidates = [(key, q) for key, q in self._lanes.items()
                      if q and (force or self._lane_ready(q, now))]
        if not candidates:
            return None
        key, q = min(candidates,
                     key=lambda kq: (kq[1][0].t_submit, -len(kq[1])))
        batch = [q.popleft() for _ in range(min(len(q), self.cfg.max_batch))]
        if not q:
            del self._lanes[key]
        return key, batch
