"""f_CP(R): CP random projection (paper Definition 2).

(f_CP(R)(X))_i = 1/sqrt(k) * < [[A_i^1, ..., A_i^N]], X >,   i in [k]

with factor entries i.i.d. N(0, (1/R)^(1/N)). Factor layout (k, d_n, R), as
in `repro.core.cp_rp.CPRP`. `trp_project` / `trp_average` give the TRP of
Sun et al. 2018 for the equivalences f_TRP == f_CP(1) and
f_TRP(T) == f_CP(R=T).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from .formats import CPTensor, TTTensor, _prod


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

    def row(self, i: int) -> CPTensor:
        """The i-th row of the implicit projection matrix, as a CP tensor."""
        return CPTensor(tuple(f[i] for f in self.factors))

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

    def _check_dims(self, x) -> None:
        if tuple(x.dims) != self.dims:
            raise ValueError(f"input dims {tuple(x.dims)} != operator dims "
                             f"{self.dims}")

    def project_cp(self, x: CPTensor) -> torch.Tensor:
        """CP-format input: O(k N d R R~)."""
        self._check_dims(x)
        carry = x.factors[0].new_ones((self.k, self.rank, x.rank))
        for f, g in zip(self.factors, x.factors):
            carry = carry * torch.einsum("kdr,dp->krp", f, g)
        w = (x.weights if x.weights is not None
             else x.factors[0].new_ones((x.rank,)))
        return torch.einsum("krp,p->k", carry, w) / math.sqrt(self.k)

    def project_tt(self, x: TTTensor) -> torch.Tensor:
        """TT-format input: carry (k, R, bond)."""
        self._check_dims(x)
        carry = x.cores[0].new_ones((self.k, self.rank, 1))
        for f, xc in zip(self.factors, x.cores):
            tmp = torch.einsum("krb,bde->krde", carry, xc)
            carry = torch.einsum("krde,kdr->kre", tmp, f)
        return carry[:, :, 0].sum(-1) / math.sqrt(self.k)

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


# ---------------------------------------------------------------------------
# TRP (Sun et al. 2018), row-wise Khatri-Rao form, for the equivalences
# f_TRP == f_CP(1) and f_TRP(T) == f_CP(R=T)
# ---------------------------------------------------------------------------

def trp_project(factor_mats: Sequence[torch.Tensor],
                x_vec: torch.Tensor) -> torch.Tensor:
    """f_TRP(X) = 1/sqrt(k) (A^1 ⊙ ... ⊙ A^N)^T vec(X).

    factor_mats[n]: (d_n, k); x_vec: flat input of size prod(d_n) in
    C-order (matches CPTensor.full().reshape(-1)).
    """
    k = factor_mats[0].shape[1]
    kr = factor_mats[0]
    for f in factor_mats[1:]:
        kr = torch.einsum("pk,dk->pdk", kr, f).reshape(-1, k)
    return (kr.T @ x_vec) / math.sqrt(k)


def trp_average(projections: Sequence[torch.Tensor]) -> torch.Tensor:
    """Variance-reduced TRP(T): scaled average (1/sqrt T) sum_t f^(t)(X)."""
    return sum(projections) / math.sqrt(len(projections))
