"""f_TT(R): tensor-train random projection (paper Definition 1).

(f_TT(R)(X))_i = 1/sqrt(k) * < <<G_i^1, ..., G_i^N>>, X >,   i in [k]

with core entries drawn i.i.d. N(0, sigma_n^2) where sigma_n^2 = 1/sqrt(R)
for the boundary cores (n = 1, N) and 1/R for interior cores.

Batched-core layout: cores[n] has shape (k, r_{n-1}, d_n, r_n), r_0 = r_N = 1
— the layout of `repro.core.tt_rp.TTRP`, so operators carry across as they
are (`repro_torch.core.from_numpy_operator`). These einsum paths are the
plain route (`backend='torch'`); the mode-sweep kernels live in
`repro_torch.kernels`.

  project(X)       dense input    O(k R d^N)
  project_tt(X)    TT(R~) input   O(k N d R R~ (R + R~))
  project_cp(X)    CP(R~) input   (carry k x R x R~)
  reconstruct(y)   adjoint        unbiased x_hat = sum_i y_i S_i / sqrt(k)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from .formats import CPTensor, TTTensor, _prod


@dataclasses.dataclass(frozen=True)
class TTRP:
    """A sampled TT random projection operator."""

    cores: tuple[torch.Tensor, ...]  # cores[n]: (k, r_{n-1}, d_n, r_n)

    @property
    def k(self) -> int:
        return int(self.cores[0].shape[0])

    @property
    def order(self) -> int:
        return len(self.cores)

    @property
    def dims(self) -> tuple[int, ...]:
        return tuple(int(c.shape[2]) for c in self.cores)

    @property
    def in_dims(self) -> tuple[int, ...]:
        """RPOperator protocol: input mode sizes (alias of `dims`)."""
        return self.dims

    @property
    def rank(self) -> int:
        return int(self.cores[0].shape[3]) if self.order > 1 else 1

    @property
    def device(self) -> torch.device:
        return self.cores[0].device

    def num_params(self) -> int:
        return sum(_prod(c.shape) for c in self.cores)

    def row(self, i: int) -> TTTensor:
        """The i-th row of the implicit projection matrix, as a TT tensor."""
        return TTTensor(tuple(c[i] for c in self.cores))

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """Project dense input(s). x: (*batch, d1, ..., dN) -> (*batch, k)."""
        N = self.order
        if tuple(x.shape[x.ndim - N:]) != self.dims:
            raise ValueError(f"input shape {tuple(x.shape)} does not end in "
                             f"dims {self.dims}")
        scale = 1.0 / math.sqrt(self.k)
        if N == 1:
            g = self.cores[0][:, 0, :, 0]
            return torch.einsum("...d,kd->...k", x, g) * scale
        # right-to-left contraction; carry axes (*batch, d1..d_n, k, r_n)
        c = torch.einsum("...d,krd->...kr", x, self.cores[-1][:, :, :, 0])
        for n in range(N - 2, 0, -1):
            c = torch.einsum("...dkr,ksdr->...ks", c, self.cores[n])
        y = torch.einsum("...dkr,kdr->...k", c, self.cores[0][:, 0, :, :])
        return y * scale

    def _check_dims(self, x) -> None:
        if tuple(x.dims) != self.dims:
            raise ValueError(f"input dims {tuple(x.dims)} != operator dims "
                             f"{self.dims}")

    def project_tt(self, x: TTTensor) -> torch.Tensor:
        """Project an input given in TT format: O(k N d R R~ (R + R~))."""
        self._check_dims(x)
        carry = x.cores[0].new_ones((self.k, 1, 1))  # (k, r_rp, r_x)
        for g, xc in zip(self.cores, x.cores):
            tmp = torch.einsum("kab,kads->kbds", carry, g)
            carry = torch.einsum("kbds,bde->kse", tmp, xc)
        return carry[:, 0, 0] / math.sqrt(self.k)

    def project_cp(self, x: CPTensor) -> torch.Tensor:
        """Project an input given in CP format."""
        self._check_dims(x)
        carry = x.factors[0].new_ones((self.k, 1, x.rank))  # (k, r_rp, R~)
        for g, f in zip(self.cores, x.factors):
            tmp = torch.einsum("kap,kads->kpds", carry, g)
            carry = torch.einsum("kpds,dp->ksp", tmp, f)
        w = (x.weights if x.weights is not None
             else x.factors[0].new_ones((x.rank,)))
        # the boundary carry is (k, r_N = 1, R~): contract it directly
        y = torch.einsum("kp,p->k", carry[:, 0, :], w)
        return y / math.sqrt(self.k)

    def reconstruct(self, y: torch.Tensor, *,
                    chunk: int | None = None) -> torch.Tensor:
        """Unbiased adjoint x_hat = (1/sqrt k) sum_i y_i S_i for a (k,) sketch.

        `chunk` bounds the k-sized intermediate (memory
        O(chunk * d^{N-1} * R)); chunks are summed in order.
        """
        k = self.k
        if tuple(y.shape) != (k,):
            raise ValueError(f"sketch shape {tuple(y.shape)} != ({k},)")
        scale = 1.0 / math.sqrt(k)
        if self.order == 1:
            return torch.einsum("k,kd->d", y, self.cores[0][:, 0, :, 0]) * scale

        def partial(cores, yc):
            w = torch.einsum("k,kdr->kdr", yc, cores[0][:, 0, :, :])
            for g in cores[1:-1]:
                w = torch.einsum("k...r,krds->k...ds", w, g)
            return torch.einsum("k...r,krd->...d", w, cores[-1][:, :, :, 0])

        if chunk is None or chunk >= k:
            return partial(self.cores, y) * scale
        out = y.new_zeros(self.dims)
        for s in range(0, k, chunk):
            out = out + partial([c[s:s + chunk] for c in self.cores],
                                y[s:s + chunk])
        return out * scale

    def as_dense_matrix(self) -> torch.Tensor:
        """Materialize the k x prod(dims) matrix (tests only)."""
        rows = self.cores[0][:, 0]                       # (k, d1, r1)
        for c in self.cores[1:]:
            rows = torch.einsum("kpr,krds->kpds", rows, c)
            rows = rows.reshape(self.k, -1, c.shape[3])
        return rows.reshape(self.k, -1) / math.sqrt(self.k)


def sample_tt_rp(generator: torch.Generator, dims: Sequence[int], k: int,
                 rank: int, dtype=torch.float32, device=None) -> TTRP:
    """Draw f_TT(R) cores per Definition 1's variance schedule, on the
    generator's device (or `device`: 'meta', the dry run's, where torch
    draws nothing)."""
    device = generator.device if device is None else device
    N = len(dims)
    ranks = [1] + [rank] * (N - 1) + [1]
    cores = []
    for n in range(N):
        if N == 1:
            var = 1.0  # classical Gaussian RP; R plays no role
        elif n == 0 or n == N - 1:
            var = 1.0 / math.sqrt(rank)
        else:
            var = 1.0 / rank
        g = torch.randn((k, ranks[n], int(dims[n]), ranks[n + 1]),
                        generator=generator, device=device, dtype=dtype)
        cores.append(g * math.sqrt(var))
    return TTRP(tuple(cores))
