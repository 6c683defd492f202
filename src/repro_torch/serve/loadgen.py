"""Offline load generator: synthetic traces + deterministic replay.

Port of `repro/serve/loadgen.py`. `synth_trace` draws a Poisson-arrival
request stream over a structure mix (dense / TT / CP payloads, rank- and
length-ragged) and a pool of (spec, seed) pairs — repeated specs are what
exercise the operator cache. `replay` drives a `SketchServer` through the
trace on the trace's own clock, so the reported p50/p99 are the
deterministic queueing latencies of the flush policy, while `wall_s`
separately records the real time of the replay.

Everything is drawn from one seeded numpy generator. Arrivals, structure
kinds and spec choices use the same draws, in the same order, as the
reference's generator, so the same seed gives the same arrival times,
kinds and specs. Payload values cannot follow the reference's `jax.random`
draws; TT/CP payloads hold float32 CPU tensors.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.formats import CPTensor, TTTensor
from repro_torch.rp import ProjectorSpec

from .engine import SketchServer


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One arrival: at trace-clock time `t_us`, sketch `payload` under
    (spec, seed)."""

    t_us: float
    payload: Any
    spec: ProjectorSpec
    seed: int = 0


def _random_tt(rng, dims, rank: int) -> TTTensor:
    ranks = [1] + [rank] * (len(dims) - 1) + [1]
    return TTTensor(tuple(
        torch.from_numpy(rng.standard_normal(
            (ranks[n], d, ranks[n + 1]), dtype=np.float32))
        for n, d in enumerate(dims)))


def _random_cp(rng, dims, rank: int) -> CPTensor:
    return CPTensor(tuple(
        torch.from_numpy(rng.standard_normal((d, rank), dtype=np.float32))
        for d in dims))


def synth_trace(n_requests: int, specs: Sequence[tuple[ProjectorSpec, int]],
                *, mix: tuple[float, float, float] = (1.0, 1.0, 1.0),
                mean_gap_us: float = 200.0, ranks: tuple[int, ...] = (2, 3, 4),
                seed: int = 0) -> list[TraceEvent]:
    """A seeded synthetic request trace.

    specs       : pool of (ProjectorSpec, seed) pairs, drawn uniformly.
    mix         : relative weights of (dense, tt, cp) payload structures.
    mean_gap_us : mean exponential inter-arrival gap (Poisson arrivals).
    ranks       : TT/CP input ranks, cycled by request index — rank-RAGGED
                  on purpose; the lane coalescing pads them exactly.
    Dense payloads alternate full `dims`-shaped float32 tensors with
    ragged SHORT flat vectors (zero-padded downstream); TT/CP payloads
    have standard-normal cores/factors.
    """
    if n_requests < 0:
        raise ValueError(f"n_requests must be >= 0, got {n_requests}")
    if not specs:
        raise ValueError("specs pool is empty")
    w = np.asarray(mix, np.float64)
    if w.shape != (3,) or (w < 0).any() or w.sum() == 0:
        raise ValueError(f"mix must be 3 non-negative weights, got {mix}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(mean_gap_us, size=n_requests)
    t = np.cumsum(gaps)
    kinds = rng.choice(3, size=n_requests, p=w / w.sum())
    which = rng.integers(0, len(specs), size=n_requests)
    events: list[TraceEvent] = []
    for i in range(n_requests):
        spec, op_seed = specs[which[i]]
        rank = int(ranks[i % len(ranks)])
        if kinds[i] == 1:
            payload: Any = _random_tt(rng, spec.dims, rank)
        elif kinds[i] == 2:
            payload = _random_cp(rng, spec.dims, rank)
        elif i % 2 == 0:
            payload = rng.standard_normal(spec.dims, dtype=np.float32)
        else:
            size = max(1, spec.input_size - int(rng.integers(
                0, max(1, spec.input_size // 4))))
            payload = rng.standard_normal(size, dtype=np.float32)
        events.append(TraceEvent(t_us=float(t[i]), payload=payload,
                                 spec=spec, seed=op_seed))
    return events


def replay(server: SketchServer, trace: Sequence[TraceEvent]) -> dict:
    """Drive `server` through `trace` on the trace clock; return the report.

    Between consecutive arrivals every flush DEADLINE that falls in the gap
    fires at its exact time (max-latency policy); full lanes flush at the
    arrival instant (max-batch policy); the tail drains at its deadlines.
    The report is `server.stats()` plus the wall-clock time.
    """
    t_wall = time.perf_counter()
    for ev in sorted(trace, key=lambda e: e.t_us):
        while True:
            deadline = server.batcher.next_deadline()
            if deadline is None or deadline > ev.t_us:
                break
            if server.tick(deadline) == 0:      # defensive: never spin
                break
        server.submit(ev.payload, ev.spec, seed=ev.seed, now=ev.t_us)
        while server.batcher.ready(ev.t_us):
            server.tick(ev.t_us)
    last = max((e.t_us for e in trace), default=0.0)
    server.drain(last)
    report = server.stats()
    report["wall_s"] = time.perf_counter() - t_wall
    report["n_trace"] = len(trace)
    return report
