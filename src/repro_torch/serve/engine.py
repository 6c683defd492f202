"""The sketch-serving engine: queue -> batcher -> one dispatch -> store.

Port of `repro/serve/engine.py`. Requests enter through `submit`, the
`DynamicBatcher` coalesces them into lanes, and every `tick` flushes ONE
lane through `rp.project_many` — exactly one kernel dispatch per tick,
with the operator fetched from the LRU `OperatorCache`. Completed sketches
whose spec matches the attached `SketchStore`'s are ingested and become
queryable through `query` / `pairwise`.

The engine is synchronous and clock-explicit (`now` in trace-clock
microseconds), so latency percentiles are a deterministic function of the
trace and the flush policy. Operators, dispatch and store live on one
device (`device=None` means CUDA). Payloads are dense arrays or TT/CP
tensors; each lane holds one structure, so a tick is one dense (K1) or
one carry-sweep (K3) launch on the card. Each tick opens a `serve.tick`
span, records the `serve/queue_delay_us` histogram and the
`serve/requests_done` counter, and feeds an enabled `DistortionMonitor`
with its dense payloads (`repro_torch.obs`; all no-ops when telemetry is
off). `save_manifest` / `prewarm` carry the operator cache's registry
across a restart (specs and seeds only).
"""
from __future__ import annotations

import collections
import json
import pathlib

import numpy as np
import torch

from repro_torch import obs, rp
from repro_torch.core.formats import CPTensor, TTTensor
from repro_torch.rp.many import stack_dense

from .batcher import DynamicBatcher, SketchRequest
from .cache import OperatorCache
from .config import ServeConfig
from .store import PairwiseResult, QueryResult, SketchStore


class SketchServer:
    """RP-as-a-service: continuously batched sketching + JL retrieval."""

    def __init__(self, cfg: ServeConfig | None = None,
                 store: SketchStore | None = None, *, device=None):
        self.cfg = cfg if cfg is not None else ServeConfig()
        self.batcher = DynamicBatcher(self.cfg)
        self.cache = OperatorCache(self.cfg.cache_capacity, device=device)
        if store is not None and store.device != self.cache.device:
            raise ValueError(f"store on {store.device}, server on "
                             f"{self.cache.device}")
        self.store = store
        self.done: list[SketchRequest] = []
        self.ticks = 0
        self.occupancy: list[float] = []
        self._next_rid = 0
        # last-N completed-request latencies (ServeConfig.stats_window)
        self._lat_window: collections.deque[float] = collections.deque(
            maxlen=self.cfg.stats_window)

    @property
    def device(self):
        return self.cache.device

    def submit(self, payload, spec: rp.ProjectorSpec, *, seed: int = 0,
               now: float = 0.0) -> SketchRequest:
        """Queue one payload for sketching under (spec, seed).

        Structured payloads are validated against the spec's dims HERE:
        failing at submit time with a typed error beats poisoning a whole
        batch at dispatch time.
        """
        if isinstance(payload, (TTTensor, CPTensor)):
            if tuple(payload.dims) != tuple(spec.dims):
                raise rp.FormatMismatchError(
                    f"{type(payload).__name__} payload dims "
                    f"{tuple(payload.dims)} != spec dims {tuple(spec.dims)}")
        req = SketchRequest(rid=self._next_rid, payload=payload, spec=spec,
                            seed=seed, t_submit=float(now))
        self._next_rid += 1
        self.batcher.submit(req)
        return req

    def tick(self, now: float, *, force: bool = False) -> int:
        """Flush one lane: ONE `rp.project_many` dispatch. Returns #served."""
        got = self.batcher.next_batch(now, force=force)
        if got is None:
            return 0
        key, batch = got
        with obs.span("serve.tick", batch=len(batch),
                      family=key.spec.family, k=key.spec.k,
                      structure=key.structure, seed=key.seed,
                      tick=self.ticks) as sp:
            op = self.cache.get(key.spec, key.seed)
            payloads = [r.payload for r in batch]
            # pre-plan the coalesced dispatch: the same group signature
            # project_many buckets on, so the tick executes a cached plan
            eplan = self.cache.plan_for(op, payloads,
                                        backend=self.cfg.backend)
            sp.set(plan=eplan.plan_id, route=eplan.route)
            mon = obs.get_distortion()
            x_norm2 = None
            if mon is not None and key.structure == "dense":
                # the lane's one batch as project_many would stack it: its
                # squared norms and its sketches come off the same copy
                xd = stack_dense(op, payloads)
                x_norm2 = xd[:len(batch)].double().square().sum(-1)
                ys = rp.project(op, xd, backend=self.cfg.backend
                                )[:len(batch)]
            else:
                ys = rp.project_many(op, payloads, backend=self.cfg.backend)
            norms = None
            if x_norm2 is not None:
                # one device->host copy a tick
                norms = torch.stack([x_norm2, ys.double().square().sum(-1)]
                                    ).cpu().tolist()
            self.ticks += 1
            self.occupancy.append(len(batch) / self.cfg.max_batch)
            ingest = (self.store is not None and self.cfg.ingest
                      and key.spec == self.store.spec)
            ids = self.store.add(ys) if ingest else None
            delay_hist = obs.histogram("serve/queue_delay_us")
            for i, req in enumerate(batch):
                req.sketch = ys[i]
                req.t_done = float(now)
                if ids is not None:
                    req.store_id = int(ids[i])
                req.payload = None  # the engine's point: drop the original
                self._lat_window.append(req.latency_us)
                delay_hist.observe(req.latency_us)
                if norms is not None:
                    mon.observe_norms(key.spec.family, len(key.spec.dims),
                                      key.spec.k, norms[0][i], norms[1][i],
                                      rank=key.spec.rank)
            self.done.extend(batch)
            obs.counter("serve/requests_done").inc(len(batch))
            return len(batch)

    def drain(self, now: float) -> int:
        """Flush everything still queued (end of trace), lane by lane at
        each flush DEADLINE, never earlier than `now`. Returns #served."""
        served = 0
        while self.batcher.pending():
            deadline = self.batcher.next_deadline()
            t = max(float(now), deadline if deadline is not None else now)
            n = self.tick(t, force=True)
            if n == 0:      # defensive: force=True always pops when pending
                break
            served += n
        return served

    def query(self, q, top_m: int, *, delta: float | None = None
              ) -> QueryResult:
        if self.store is None:
            raise ValueError("this server has no sketch store attached")
        return self.store.query(q, top_m, delta=delta)

    def pairwise(self, ids_a, ids_b, *, delta: float | None = None
                 ) -> PairwiseResult:
        if self.store is None:
            raise ValueError("this server has no sketch store attached")
        return self.store.pairwise(ids_a, ids_b, delta=delta)

    # -- restart warm-up -------------------------------------------------
    def save_manifest(self, path) -> int:
        """Write the operator cache's registry (spec dicts + seeds) to
        `path` as JSON — no operator bytes. Returns #entries written."""
        entries = self.cache.manifest()
        pathlib.Path(path).write_text(
            json.dumps({"version": 1, "entries": entries}, indent=1))
        return len(entries)

    def prewarm(self, source) -> int:
        """Warm the operator cache from a `save_manifest` file (or an
        already-loaded manifest list): every operator is regenerated
        bitwise-identical from its (spec, seed) on this server's device.
        Returns the number of operators sampled."""
        if isinstance(source, (list, tuple)):
            return self.cache.prewarm(list(source))
        doc = json.loads(pathlib.Path(source).read_text())
        entries = doc.get("entries") if isinstance(doc, dict) else doc
        if not isinstance(entries, list):
            raise ValueError(
                f"prewarm manifest {source} has no 'entries' list")
        return self.cache.prewarm(entries)

    def stats(self) -> dict:
        """Serving report: windowed latency percentiles (last
        `cfg.stats_window` requests), occupancy, cache stats."""
        lat = np.asarray(self._lat_window, np.float64)
        out = {
            "requests_done": len(self.done),
            "pending": self.batcher.pending(),
            "ticks": self.ticks,
            "occupancy_mean": float(np.mean(self.occupancy))
            if self.occupancy else 0.0,
            "p50_us": float(np.percentile(lat, 50)) if lat.size else 0.0,
            "p99_us": float(np.percentile(lat, 99)) if lat.size else 0.0,
            "stats_window": self.cfg.stats_window,
            "stats_window_n": int(lat.size),
            "cache": self.cache.stats.as_dict(),
        }
        if self.store is not None:
            out["store_size"] = len(self.store)
            out["store_bytes"] = self.store.nbytes()
        return out
