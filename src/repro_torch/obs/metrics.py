"""Counters, gauges, fixed-bucket histograms, and an event log — the
process-local metrics half of `repro_torch.obs` (port of
`repro/obs/metrics.py`; pure Python, so the JSONL rows match the
reference's field for field).

Design constraints, in order:

  * zero dependencies beyond numpy (and numpy only in tests' reference
    math — the registry itself is pure Python);
  * MERGEABLE across processes: a histogram is (bounds, per-bucket counts,
    sum, count) — two histograms with identical bounds add bucket-wise, so
    per-host JSONL snapshots can be folded into one fleet view without the
    raw samples;
  * misuse raises typed ValueErrors that survive ``python -O`` (negative
    or non-ascending bucket bounds, merging mismatched bounds, re-creating
    a name as a different instrument type) — never bare asserts.

Percentiles come from the buckets: `Histogram.percentile(p)` linearly
interpolates inside the bucket holding the p-th sample, which is exact to
within one bucket width — the standard fixed-bucket tradeoff (Prometheus
histograms make the same one).
"""
from __future__ import annotations

import json
import threading
import time


class Counter:
    """Monotonic counter. `inc(n)` with n >= 0; `.value` reads it."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(
                f"counter {self.name!r} is monotonic: inc({n}) is negative "
                "(use a gauge for values that go down)")
        self.value += n

    def merge(self, other: "Counter") -> None:
        self.value += other.value

    def snapshot(self) -> dict:
        return {"type": "counter", "name": self.name, "value": self.value}


class Gauge:
    """Last-write-wins value (e.g. wire bytes per step of the active
    config). `set(v)`; `.value` reads it."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def merge(self, other: "Gauge") -> None:
        self.value = other.value    # last write wins across a merge too

    def snapshot(self) -> dict:
        return {"type": "gauge", "name": self.name, "value": self.value}


class Histogram:
    """Fixed-bound bucket histogram with interpolated percentiles.

    `bounds` are the strictly-ascending POSITIVE upper edges of the finite
    buckets; one overflow bucket catches everything past the last edge.
    Bucket i (i < len(bounds)) holds samples in (lower_i, bounds[i]] with
    lower_0 = 0. Negative samples are clamped into the first bucket (the
    instruments here measure durations and byte counts, which cannot be
    negative — a clamp beats crashing a hot path on clock skew).
    """

    __slots__ = ("name", "bounds", "counts", "sum", "count")

    def __init__(self, name: str, bounds):
        bounds = tuple(float(b) for b in bounds)
        if not bounds:
            raise ValueError(
                f"histogram {name!r} needs at least one bucket bound")
        if any(b <= 0 for b in bounds):
            raise ValueError(
                f"histogram {name!r} bounds must be positive, got {bounds} "
                "(durations/bytes are non-negative; a 0 or negative edge "
                "would create an unreachable bucket)")
        if any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(
                f"histogram {name!r} bounds must be strictly ascending, "
                f"got {bounds}")
        self.name = name
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # +1: overflow bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def percentile(self, p: float) -> float:
        """The p-th percentile (0 <= p <= 100), bucket-interpolated.

        Exact to within one bucket width; the overflow bucket reports its
        lower edge (the last finite bound) — a deliberate UNDER-estimate,
        the same convention Prometheus uses for +Inf.
        """
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile p must be in [0, 100], got {p}")
        if self.count == 0:
            return 0.0
        target = p / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if cum + c >= target and c > 0:
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                if i >= len(self.bounds):       # overflow: report the edge
                    return self.bounds[-1]
                hi = self.bounds[i]
                frac = (target - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        return self.bounds[-1]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram in (cross-process aggregation)."""
        if tuple(other.bounds) != self.bounds:
            raise ValueError(
                f"cannot merge histogram {self.name!r}: bucket bounds "
                f"differ ({other.bounds} != {self.bounds}); mergeability "
                "requires identical fixed bounds on every process")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count

    def snapshot(self) -> dict:
        return {"type": "histogram", "name": self.name,
                "bounds": list(self.bounds), "counts": list(self.counts),
                "sum": self.sum, "count": self.count,
                "p50": self.percentile(50), "p99": self.percentile(99)}


# Default latency buckets (us): ~log-spaced 10us .. 10s.
LATENCY_BOUNDS_US = (10.0, 30.0, 100.0, 300.0, 1_000.0, 3_000.0, 10_000.0,
                     30_000.0, 100_000.0, 300_000.0, 1_000_000.0,
                     3_000_000.0, 10_000_000.0)


class MetricsRegistry:
    """Get-or-create registry of named instruments plus an event log.

    Thread-safe; instrument lookups take the lock, the returned instrument
    objects are then mutated without it (additions of Python floats/ints —
    atomic enough for telemetry; the registry is not a database).
    `event(name, **attrs)` appends a timestamped record to the event log —
    the structured form of what used to be bare log strings (stragglers,
    resume/fallback, distortion alerts).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, object] = {}
        self.events: list[dict] = []

    def _get(self, name: str, cls, *args):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, *args)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  bounds=LATENCY_BOUNDS_US) -> Histogram:
        h = self._get(name, Histogram, bounds)
        if tuple(float(b) for b in bounds) != h.bounds:
            raise ValueError(
                f"histogram {name!r} already registered with bounds "
                f"{h.bounds}; re-registering with different bounds would "
                "silently split one metric into incompatible series")
        return h

    def event(self, name: str, **attrs) -> dict:
        ev = {"type": "event", "name": name, "time": time.time(), **attrs}
        with self._lock:
            self.events.append(ev)
        return ev

    def instruments(self) -> list[object]:
        with self._lock:
            return list(self._instruments.values())

    def snapshot(self) -> list[dict]:
        """All instruments + events as JSON-able records (JSONL rows)."""
        rows = [inst.snapshot() for inst in self.instruments()]
        with self._lock:
            rows.extend(dict(e) for e in self.events)
        return rows

    def write_jsonl(self, path) -> int:
        """One JSON object per line; returns the number of rows written."""
        rows = self.snapshot()
        with open(path, "w") as f:
            for row in rows:
                f.write(json.dumps(row, sort_keys=True) + "\n")
        return len(rows)

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold another registry in: counters/histograms add, gauges take
        the other's value, events concatenate. Cross-process aggregation
        of per-host snapshots."""
        for inst in other.instruments():
            mine = self._get(inst.name, type(inst),
                             *((inst.bounds,) if isinstance(inst, Histogram)
                               else ()))
            mine.merge(inst)
        with other._lock:
            evs = [dict(e) for e in other.events]
        with self._lock:
            self.events.extend(evs)


def read_jsonl(path) -> list[dict]:
    """Parse a `write_jsonl` file back into records (the report CLI and
    the CI schema check both go through this)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows
