"""f_CP(R): CP random projection (paper Definition 2).

(f_CP(R)(X))_i = 1/sqrt(k) * < [[A_i^1, ..., A_i^N]], X >,   i in [k]

with factor entries i.i.d. N(0, (1/R)^(1/N)). Factor layout (k, d_n, R), as
in `repro.core.cp_rp.CPRP`. The TRP equivalence helpers wait for a later
slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from .formats import _prod


@dataclasses.dataclass(frozen=True)
class CPRP:
    """A sampled CP random projection operator."""

    factors: tuple[torch.Tensor, ...]  # factors[n]: (k, d_n, R)

    @property
    def k(self) -> int:
        return int(self.factors[0].shape[0])

    @property
    def order(self) -> int:
        return len(self.factors)

    @property
    def dims(self) -> tuple[int, ...]:
        return tuple(int(f.shape[1]) for f in self.factors)

    @property
    def in_dims(self) -> tuple[int, ...]:
        """RPOperator protocol: input mode sizes (alias of `dims`)."""
        return self.dims

    @property
    def rank(self) -> int:
        return int(self.factors[0].shape[2])

    @property
    def device(self) -> torch.device:
        return self.factors[0].device

    def num_params(self) -> int:
        return sum(_prod(f.shape) for f in self.factors)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """Dense input(s): (*batch, d1..dN) -> (*batch, k). O(k R d^N)."""
        N = self.order
        if tuple(x.shape[x.ndim - N:]) != self.dims:
            raise ValueError(f"input shape {tuple(x.shape)} does not end in "
                             f"dims {self.dims}")
        c = torch.einsum("...d,kdr->...kr", x, self.factors[-1])
        for n in range(N - 2, -1, -1):
            c = torch.einsum("...dkr,kdr->...kr", c, self.factors[n])
        return c.sum(-1) / math.sqrt(self.k)

    def reconstruct(self, y: torch.Tensor, *,
                    chunk: int | None = None) -> torch.Tensor:
        """Unbiased adjoint x_hat = (1/sqrt k) sum_i y_i [[A_i^*]]."""
        k = self.k
        if tuple(y.shape) != (k,):
            raise ValueError(f"sketch shape {tuple(y.shape)} != ({k},)")
        scale = 1.0 / math.sqrt(k)
        if self.order == 1:
            return torch.einsum("k,kdr->d", y, self.factors[0]) * scale

        def partial(facs, yc):
            w = torch.einsum("k,kdr->kdr", yc, facs[0])
            for f in facs[1:-1]:
                w = torch.einsum("k...r,kdr->k...dr", w, f)
            return torch.einsum("k...r,kdr->...d", w, facs[-1])

        if chunk is None or chunk >= k:
            return partial(self.factors, y) * scale
        out = y.new_zeros(self.dims)
        for s in range(0, k, chunk):
            out = out + partial([f[s:s + chunk] for f in self.factors],
                                y[s:s + chunk])
        return out * scale

    def as_dense_matrix(self) -> torch.Tensor:
        """Materialize the k x prod(dims) matrix (tests only)."""
        rows = self.factors[0]                           # (k, d1, R)
        for f in self.factors[1:]:
            rows = torch.einsum("kpr,kdr->kpdr", rows, f)
            rows = rows.reshape(self.k, -1, self.rank)
        return rows.sum(-1) / math.sqrt(self.k)


def sample_cp_rp(generator: torch.Generator, dims: Sequence[int], k: int,
                 rank: int, dtype=torch.float32) -> CPRP:
    """Draw f_CP(R) factors per Definition 2 (var = (1/R)^(1/N)) on the
    generator's device."""
    N = len(dims)
    std = (1.0 / rank) ** (1.0 / (2.0 * N))
    return CPRP(tuple(
        std * torch.randn((k, int(dims[n]), rank), generator=generator,
                          device=generator.device, dtype=dtype)
        for n in range(N)))
