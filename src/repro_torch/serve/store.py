"""Sketch store + JL similarity retrieval in the compressed domain.

Port of `repro/serve/store.py`. Thm 1 makes a stored `(k,)` sketch a
distance oracle: `Var(||f(z)||^2) <= c/k * ||z||^4` with `c` the family's
variance factor, so by Chebyshev the squared distance between STORED
sketches estimates the true squared distance to relative error
`eps = sqrt(c / (k * delta))` with failure probability delta — the bound
this store reports beside every result.

The rows live on the store's device (`device=None` means CUDA) in a
doubling buffer. Retrieval is brute-force-but-batched: one `(B, k) @
(k, tile)` `torch.matmul` per tile of stored rows (a plain large product,
which the reference leaves to XLA), with a running top-m merge on the
device between tiles.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import theory
from repro_torch.core.device import resolve_device
from repro_torch.rp import ProjectorSpec


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """Top-m retrieval answer with its JL error bar.

    ids   : (B, m) store ids, ascending sketch-space distance.
    dist2 : (B, m) SQUARED sketch-space distances.
    eps   : relative error of `dist2` as an estimate of the true squared
            distance, per pair with failure probability <= delta.
    delta : the failure probability `eps` was computed at.
    """

    ids: np.ndarray
    dist2: np.ndarray
    eps: float
    delta: float

    @property
    def dist2_lo(self) -> np.ndarray:
        """Lower end of the per-pair true-squared-distance interval."""
        return self.dist2 / (1.0 + self.eps)

    @property
    def dist2_hi(self) -> np.ndarray:
        """Upper end; +inf when eps >= 1 (k too small for a two-sided bar)."""
        if self.eps >= 1.0:
            return np.full_like(self.dist2, np.inf)
        return self.dist2 / (1.0 - self.eps)


@dataclasses.dataclass(frozen=True)
class PairwiseResult:
    """Pairwise-distance answer (same fields/semantics as QueryResult)."""

    dist2: np.ndarray
    eps: float
    delta: float

    @property
    def dist2_lo(self) -> np.ndarray:
        return self.dist2 / (1.0 + self.eps)

    @property
    def dist2_hi(self) -> np.ndarray:
        if self.eps >= 1.0:
            return np.full_like(self.dist2, np.inf)
        return self.dist2 / (1.0 - self.eps)


class SketchStore:
    """Append-only store of `(k,)` sketches from ONE projector spec."""

    def __init__(self, spec: ProjectorSpec, *, query_tile: int = 4096,
                 delta: float = 0.01, device=None):
        if query_tile < 1:
            raise ValueError(f"query_tile must be >= 1, got {query_tile}")
        if not 0.0 < delta < 1.0:
            raise ValueError(f"delta must be in (0, 1), got {delta}")
        self.spec = spec
        self.k = spec.k
        self.query_tile = int(query_tile)
        self.delta = float(delta)
        self.device = resolve_device(device)
        self.var_factor = theory.variance_factor(
            spec.family, N=len(spec.dims), R=spec.rank, D=spec.input_size)
        self._data = torch.empty((0, self.k), device=self.device)
        self._norms2 = torch.empty((0,), device=self.device)
        self._n = 0
        self._dtype: torch.dtype | None = None

    def __len__(self) -> int:
        return self._n

    def nbytes(self) -> int:
        """Resident sketch bytes."""
        return self._n * self.k * self._data.element_size()

    def eps_bound(self, delta: float | None = None) -> float:
        """Thm-1/Chebyshev relative error of squared distances at `delta`."""
        delta = self.delta if delta is None else delta
        if not 0.0 < delta < 1.0:
            raise ValueError(f"delta must be in (0, 1), got {delta}")
        return math.sqrt(self.var_factor / (self.k * delta))

    def _rows(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def add(self, sketches) -> np.ndarray:
        """Append `(B, k)` (or a single `(k,)`) sketches; returns their ids.

        The element dtype is fixed by the FIRST ingest; mixing dtypes
        afterwards is a typed error.
        """
        arr = self._rows(sketches)
        if arr.ndim == 1:
            arr = arr[None]
        if arr.ndim != 2 or arr.shape[1] != self.k:
            raise ValueError(
                f"sketches of shape {tuple(arr.shape)} do not end in the "
                f"store's k = {self.k}")
        if self._dtype is None:
            self._dtype = arr.dtype
            self._data = self._data.to(arr.dtype)
        elif arr.dtype != self._dtype:
            raise ValueError(
                f"mixed-dtype ingest: store holds {self._dtype} sketches, "
                f"got {arr.dtype}; re-sketch with a consistent dtype")
        b = arr.shape[0]
        if self._n + b > self._data.shape[0]:
            cap = max(2 * self._data.shape[0], self._n + b, 1024)
            grown = torch.empty((cap, self.k), dtype=self._dtype,
                                device=self.device)
            grown[:self._n] = self._data[:self._n]
            self._data = grown
            grown_n = torch.empty((cap,), device=self.device)
            grown_n[:self._n] = self._norms2[:self._n]
            self._norms2 = grown_n
        self._data[self._n:self._n + b] = arr
        self._norms2[self._n:self._n + b] = (arr.float() ** 2).sum(-1)
        ids = np.arange(self._n, self._n + b)
        self._n += b
        return ids

    def get(self, ids) -> torch.Tensor:
        """Stored sketches by id (on the store's device)."""
        idx = torch.as_tensor(np.asarray(ids), device=self.device)
        return self._data[:self._n][idx]

    def query(self, q, top_m: int, *, delta: float | None = None
              ) -> QueryResult:
        """Top-m nearest stored sketches for each query row.

        q     : one `(k,)` sketch or a `(B, k)` stack of them.
        top_m : results per query, 1 <= top_m <= len(store).
        """
        if self._n == 0:
            raise ValueError("query on an empty store; ingest sketches "
                             "first")
        if not 1 <= top_m <= self._n:
            raise ValueError(
                f"top_m={top_m} out of range: store holds {self._n} "
                f"sketches (need 1 <= top_m <= {self._n})")
        q = self._rows(q)
        squeeze = q.ndim == 1
        if squeeze:
            q = q[None]
        if q.ndim != 2 or q.shape[1] != self.k:
            raise ValueError(f"query of shape {tuple(q.shape)} does not end "
                             f"in the store's k = {self.k}")
        q = q.to(self._dtype)
        qn = (q.float() ** 2).sum(-1)
        nb = q.shape[0]
        best_d = torch.full((nb, top_m), math.inf, device=self.device)
        best_i = torch.full((nb, top_m), -1, dtype=torch.int64,
                            device=self.device)
        for start in range(0, self._n, self.query_tile):
            stop = min(start + self.query_tile, self._n)
            # ONE matmul per tile: (B, k) @ (k, tile)
            dots = torch.matmul(q, self._data[start:stop].T).float()
            d2 = qn[:, None] - 2.0 * dots + self._norms2[start:stop][None]
            cand_d = torch.cat([best_d, d2], dim=1)
            cand_i = torch.cat([best_i, torch.arange(
                start, stop, device=self.device).expand(nb, -1)], dim=1)
            best_d, keep = torch.topk(cand_d, top_m, dim=1, largest=False)
            best_i = torch.gather(cand_i, 1, keep)
        best_d, order = torch.sort(best_d, dim=1, stable=True)
        best_i = torch.gather(best_i, 1, order)
        best_d = best_d.clamp_min(0.0).cpu().numpy()
        best_i = best_i.cpu().numpy()
        if squeeze:
            best_d, best_i = best_d[0], best_i[0]
        delta = self.delta if delta is None else delta
        return QueryResult(ids=best_i, dist2=best_d,
                           eps=self.eps_bound(delta), delta=delta)

    def pairwise(self, ids_a, ids_b, *, delta: float | None = None
                 ) -> PairwiseResult:
        """Squared distances between stored sketch pairs, with error bars;
        ids_a / ids_b broadcast elementwise."""
        ids_a = np.asarray(ids_a)
        ids_b = np.asarray(ids_b)
        for ids in (ids_a, ids_b):
            if ids.size and (ids.min() < 0 or ids.max() >= self._n):
                raise ValueError(f"sketch id out of range [0, {self._n})")
        diff = self.get(ids_a).float() - self.get(ids_b).float()
        d2 = (diff * diff).sum(-1).cpu().numpy()
        delta = self.delta if delta is None else delta
        return PairwiseResult(dist2=d2, eps=self.eps_bound(delta),
                              delta=delta)
