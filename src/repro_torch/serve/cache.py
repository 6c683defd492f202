"""LRU operator cache: (ProjectorSpec, seed) -> sampled RPOperator.

Port of `repro/serve/cache.py`. An operator is a few small random cores
fully determined by (spec, seed, device) — `rp.make_projector` draws them
from a `torch.Generator` seeded with `seed` on the cache's device — so a
hit means zero regeneration and an evicted entry re-materializes
bitwise-identical later. That makes the cache's `manifest()` (specs and
seeds, never operator bytes) a complete registry: `prewarm` regenerates
it after a restart, so the first request of each lane hits.

`plan_for(op, payloads)` resolves the `ExecutionPlan` a coalesced tick will
dispatch (via `rp.group_signature`) and pins it next to the operators.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

from repro_torch import rp
from repro_torch.core.device import resolve_device


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    prewarmed: int = 0       # entries sampled by prewarm(), not by a get()
    regen_s: float = 0.0     # cumulative operator-sampling wall time

    @property
    def gets(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.gets if self.gets else 0.0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "prewarmed": self.prewarmed,
                "regen_s": self.regen_s, "hit_rate": self.hit_rate}


class OperatorCache:
    """LRU of sampled operators keyed on (ProjectorSpec, seed), on one
    device (`device=None` means CUDA). A `get` refreshes recency."""

    def __init__(self, capacity: int = 8, *, device=None):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.device = resolve_device(device)
        self.stats = CacheStats()
        self._entries: "OrderedDict[tuple, rp.RPOperator]" = OrderedDict()
        self._plans: dict = {}   # plan_id -> ExecutionPlan, pinned warm

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        spec, seed = key
        return (spec, int(seed)) in self._entries

    def get(self, spec: rp.ProjectorSpec, seed: int = 0) -> rp.RPOperator:
        """The operator for (spec, seed): cached, or sampled-and-cached."""
        key = (spec, int(seed))
        op = self._entries.get(key)
        if op is not None:
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return op
        self.stats.misses += 1
        return self._sample(key)

    def _sample(self, key: tuple) -> rp.RPOperator:
        """Sample the operator of (spec, seed) into the cache (timed into
        `stats.regen_s`), evicting least-recently-used entries."""
        t0 = time.perf_counter()
        op = rp.make_projector(key[0], key[1], device=self.device)
        self.stats.regen_s += time.perf_counter() - t0
        self._entries[key] = op
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.stats.evictions += 1
        return op

    def keys(self) -> list[tuple]:
        """Cached (spec, seed) keys, least-recently-used first."""
        return list(self._entries)

    def plan_for(self, op: rp.RPOperator, payloads, *,
                 backend: str = "auto") -> rp.ExecutionPlan:
        """The `ExecutionPlan` a coalesced dispatch of `payloads` resolves
        (never calls `get`, so the hit/miss stats stay untouched)."""
        eplan = rp.plan_execution(op, rp.group_signature(op, payloads),
                                  backend=backend)
        self._plans[eplan.plan_id] = eplan
        return eplan

    @property
    def plans(self) -> dict:
        """plan_id -> pinned `ExecutionPlan` (see `plan_for`)."""
        return dict(self._plans)

    # -- restart warm-up: the cache's contents as a manifest of specs -----
    def manifest(self) -> list[dict]:
        """JSON-able registry of the cached operators, LRU-first: each
        entry {"spec": ProjectorSpec.to_dict(), "seed": int}."""
        return [{"spec": spec.to_dict(), "seed": seed}
                for spec, seed in self._entries]

    def prewarm(self, manifest: list[dict]) -> int:
        """Re-materialize a `manifest()`'s operators bitwise-identical on
        this cache's device.

        Sampling counts into `stats.prewarmed` and `stats.regen_s`, NOT
        into misses — a prewarmed entry's first `get` is a hit. Entries go
        in in manifest order (LRU-first), so recency survives the restart;
        an entry already cached is only refreshed. Returns the number of
        operators sampled.
        """
        sampled = 0
        for entry in manifest:
            spec = rp.ProjectorSpec.from_dict(entry["spec"])
            key = (spec, int(entry["seed"]))
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            self._sample(key)
            self.stats.prewarmed += 1
            sampled += 1
        return sampled
