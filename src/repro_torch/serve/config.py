"""Serving-engine configuration (port of `repro/serve/config.py`).

One frozen dataclass carries every knob of the sketch-serving pipeline
(queue -> batcher -> dispatch -> store): the dynamic batcher's flush policy
(`max_batch` / `flush_us`), the LRU operator-cache capacity, the backend
policy handed to `rp.project_many`, and the similarity endpoint's tile
size and confidence level. Misuse raises `ValueError` naming the knob —
never a bare assert — so a bad production flag fails loudly even under
`python -O`.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of the sketch-serving engine.

    max_batch      : flush a lane as soon as it holds this many requests
                     (the batch the one-per-tick dispatch carries).
    flush_us       : max-latency flush — a lane whose OLDEST request has
                     waited this many (trace-clock) microseconds flushes
                     even when short of `max_batch`. The knob trades tail
                     latency against batch occupancy.
    cache_capacity : LRU operator-cache entries ((ProjectorSpec, seed)
                     keys; a hit skips operator regeneration entirely).
    backend        : `repro_torch.rp` backend policy for the per-tick
                     dispatch ('auto' | 'kernel' | 'torch').
    ingest         : add completed sketches (of the store's own spec) to
                     the sketch store so they become retrievable.
    query_tile     : stored-sketch rows per matmul tile of the similarity
                     sweep (bounds the (B, tile) distance intermediate).
    delta          : default failure probability of the Thm-1/Chebyshev
                     distortion bound reported next to query results.
    stats_window   : completed requests the latency percentiles in
                     `SketchServer.stats()` are computed over (last-N).
                     All-time percentiles let a long healthy prefix mask a
                     tail regression — after 10^6 fast requests, a slow
                     phase needs >1% of the TOTAL trace to move the
                     all-time p99 at all; a windowed p99 reflects it
                     within `stats_window` requests.
    """

    max_batch: int = 16
    flush_us: float = 2_000.0
    cache_capacity: int = 8
    backend: str = "auto"
    ingest: bool = True
    query_tile: int = 4096
    delta: float = 0.01
    stats_window: int = 256

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if not self.flush_us > 0:
            raise ValueError(
                f"flush window flush_us must be > 0 (got {self.flush_us}); "
                "a non-positive window would flush every request alone and "
                "defeat batching")
        if self.cache_capacity < 1:
            raise ValueError(f"cache_capacity must be >= 1, got "
                             f"{self.cache_capacity}")
        # the one backend check lives in the plan layer
        from repro_torch.rp.plan import validate_backend
        validate_backend(self.backend)
        if self.query_tile < 1:
            raise ValueError(f"query_tile must be >= 1, got "
                             f"{self.query_tile}")
        if not 0.0 < self.delta < 1.0:
            raise ValueError(f"delta must be in (0, 1), got {self.delta}")
        if self.stats_window < 1:
            raise ValueError(
                f"stats_window must be >= 1, got {self.stats_window}; the "
                "latency percentiles need at least one completed request "
                "in their window")
