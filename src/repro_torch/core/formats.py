"""Tensor-train (TT) and CP tensor containers and flat-vector tensorization.

Port of `repro/core/formats.py`: the TT/CP containers and their batched
forms (the carry sweep's input format), exact rank padding for coalescing
rank-ragged payloads, and the seeded random constructions. `tt_svd` and
the public inner products are not ported yet.

Conventions (the paper's, Sec. 2.2):
  * TT core n has shape (r_{n-1}, d_n, r_n), with r_0 = r_N = 1.
  * CP factor n has shape (d_n, R); the tensor is sum_r a_r^1 o ... o a_r^N.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


@dataclasses.dataclass(frozen=True)
class TTTensor:
    """Tensor-train tensor <<G^1, ..., G^N>> with cores (r_{n-1}, d_n, r_n)."""

    cores: tuple[torch.Tensor, ...]

    @property
    def order(self) -> int:
        return len(self.cores)

    @property
    def dims(self) -> tuple[int, ...]:
        return tuple(int(c.shape[1]) for c in self.cores)

    @property
    def ranks(self) -> tuple[int, ...]:
        """Bond ranks (r_0, ..., r_N) including boundary 1s."""
        return (tuple(int(c.shape[0]) for c in self.cores)
                + (int(self.cores[-1].shape[2]),))

    @property
    def dtype(self):
        return self.cores[0].dtype

    @property
    def device(self) -> torch.device:
        return self.cores[0].device

    def num_params(self) -> int:
        return sum(_prod(c.shape) for c in self.cores)

    def full(self) -> torch.Tensor:
        """Materialize the dense tensor (exponential memory; tests only)."""
        out = self.cores[0].reshape(self.cores[0].shape[1], -1)  # (d1, r1)
        for core in self.cores[1:]:
            out = torch.tensordot(out, core, dims=([-1], [0]))
        return out.reshape(self.dims)

    def norm_squared(self) -> torch.Tensor:
        """||T||_F^2 by a bond carry, without materializing."""
        carry = self.cores[0].new_ones((1, 1))
        for c in self.cores:
            tmp = torch.einsum("ab,adc->bdc", carry, c)
            carry = torch.einsum("bdc,bde->ce", tmp, c)
        return carry.reshape(())

    def scale(self, alpha) -> "TTTensor":
        """Multiply the tensor by a scalar (applied to the first core)."""
        return TTTensor((self.cores[0] * alpha,) + tuple(self.cores[1:]))


@dataclasses.dataclass(frozen=True)
class CPTensor:
    """CP tensor [[A^1, ..., A^N]] with factors (d_n, R)."""

    factors: tuple[torch.Tensor, ...]
    # Optional per-component weights (R,); None means all-ones.
    weights: torch.Tensor | None = None

    @property
    def order(self) -> int:
        return len(self.factors)

    @property
    def dims(self) -> tuple[int, ...]:
        return tuple(int(f.shape[0]) for f in self.factors)

    @property
    def rank(self) -> int:
        return int(self.factors[0].shape[1])

    @property
    def dtype(self):
        return self.factors[0].dtype

    @property
    def device(self) -> torch.device:
        return self.factors[0].device

    def num_params(self) -> int:
        n = sum(_prod(f.shape) for f in self.factors)
        if self.weights is not None:
            n += _prod(self.weights.shape)
        return n

    def full(self) -> torch.Tensor:
        out = self.factors[0]  # (d1, R)
        if self.weights is not None:
            out = out * self.weights[None, :]
        for f in self.factors[1:]:
            out = torch.einsum("pr,dr->pdr", out, f).reshape(-1, out.shape[-1])
        return out.sum(-1).reshape(self.dims)

    def norm_squared(self) -> torch.Tensor:
        acc = self.factors[0].new_ones((self.rank, self.rank))
        for f in self.factors:
            acc = acc * (f.T @ f)
        w = (self.weights if self.weights is not None
             else self.factors[0].new_ones((self.rank,)))
        return torch.einsum("a,ab,b->", w, acc, w)

    def scale(self, alpha) -> "CPTensor":
        return CPTensor((self.factors[0] * alpha,) + tuple(self.factors[1:]),
                        self.weights)

    def to_tt(self) -> TTTensor:
        """Exact CP -> TT conversion with bond rank == R (diagonal cores)."""
        R = self.rank
        cores = []
        for n, f in enumerate(self.factors):  # f: (d, R)
            if n == 0:
                w = f if self.weights is None else f * self.weights[None, :]
                cores.append(w[None, :, :])                     # (1, d, R)
            elif n == len(self.factors) - 1:
                cores.append(f.T[:, :, None])                   # (R, d, 1)
            else:
                eye = torch.eye(R, dtype=f.dtype, device=f.device)
                cores.append(torch.einsum("dr,rs->rds", f, eye))
        return TTTensor(tuple(cores))


# ---------------------------------------------------------------------------
# Batched structured containers: B same-structure tensors sharing one
# leading batch axis, so a whole batch projects in ONE kernel launch
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchedTTTensor:
    """A batch of B same-structure TT tensors; cores[n]: (B, r_{n-1}, d_n, r_n).

    Every tensor in the batch shares dims and bond ranks. Build one with
    `stack` from a list of `TTTensor`s or directly from batched cores;
    `unstack` recovers the per-item tensors.
    """

    cores: tuple[torch.Tensor, ...]

    @classmethod
    def stack(cls, tensors: Sequence[TTTensor]) -> "BatchedTTTensor":
        first = tensors[0]
        for t in tensors[1:]:
            if t.dims != first.dims or t.ranks != first.ranks:
                raise ValueError(
                    f"cannot stack TT tensors with mismatched structure: "
                    f"{(t.dims, t.ranks)} != {(first.dims, first.ranks)}")
        return cls(tuple(torch.stack([t.cores[n] for t in tensors])
                         for n in range(first.order)))

    def unstack(self) -> list[TTTensor]:
        return [self[i] for i in range(self.batch)]

    def __getitem__(self, i: int) -> TTTensor:
        return TTTensor(tuple(c[i] for c in self.cores))

    @property
    def batch(self) -> int:
        return int(self.cores[0].shape[0])

    @property
    def order(self) -> int:
        return len(self.cores)

    @property
    def dims(self) -> tuple[int, ...]:
        return tuple(int(c.shape[2]) for c in self.cores)

    @property
    def ranks(self) -> tuple[int, ...]:
        return (tuple(int(c.shape[1]) for c in self.cores)
                + (int(self.cores[-1].shape[3]),))

    @property
    def dtype(self):
        return self.cores[0].dtype

    @property
    def device(self) -> torch.device:
        return self.cores[0].device

    def num_params(self) -> int:
        return sum(_prod(c.shape) for c in self.cores)

    def full(self) -> torch.Tensor:
        """Materialize the dense (B, *dims) batch (tests/small cases only)."""
        return torch.stack([t.full() for t in self.unstack()])


@dataclasses.dataclass(frozen=True)
class BatchedCPTensor:
    """A batch of B same-rank CP tensors; factors[n]: (B, d_n, R).

    Optional per-item component weights have shape (B, R); None means
    all-ones. See `BatchedTTTensor` for the stack/unstack contract.
    """

    factors: tuple[torch.Tensor, ...]
    weights: torch.Tensor | None = None

    @classmethod
    def stack(cls, tensors: Sequence[CPTensor]) -> "BatchedCPTensor":
        first = tensors[0]
        for t in tensors[1:]:
            if t.dims != first.dims or t.rank != first.rank:
                raise ValueError(
                    f"cannot stack CP tensors with mismatched structure: "
                    f"{(t.dims, t.rank)} != {(first.dims, first.rank)}")
        has_w = [t.weights is not None for t in tensors]
        if any(has_w) and not all(has_w):
            raise ValueError("cannot stack CP tensors mixing weighted and "
                             "unweighted components")
        factors = tuple(torch.stack([t.factors[n] for t in tensors])
                        for n in range(first.order))
        weights = (torch.stack([t.weights for t in tensors])
                   if all(has_w) else None)
        return cls(factors, weights)

    def unstack(self) -> list[CPTensor]:
        return [self[i] for i in range(self.batch)]

    def __getitem__(self, i: int) -> CPTensor:
        w = None if self.weights is None else self.weights[i]
        return CPTensor(tuple(f[i] for f in self.factors), w)

    @property
    def batch(self) -> int:
        return int(self.factors[0].shape[0])

    @property
    def order(self) -> int:
        return len(self.factors)

    @property
    def dims(self) -> tuple[int, ...]:
        return tuple(int(f.shape[1]) for f in self.factors)

    @property
    def rank(self) -> int:
        return int(self.factors[0].shape[2])

    @property
    def dtype(self):
        return self.factors[0].dtype

    @property
    def device(self) -> torch.device:
        return self.factors[0].device

    def num_params(self) -> int:
        n = sum(_prod(f.shape) for f in self.factors)
        if self.weights is not None:
            n += _prod(self.weights.shape)
        return n

    def full(self) -> torch.Tensor:
        """Materialize the dense (B, *dims) batch (tests/small cases only)."""
        return torch.stack([t.full() for t in self.unstack()])


# Everything that dispatches to the compressed-domain (carry-sweep) path.
STRUCT_TYPES = (TTTensor, CPTensor, BatchedTTTensor, BatchedCPTensor)


# ---------------------------------------------------------------------------
# Rank-ragged coalescing: zero-padded bond/component channels contribute a
# term with a zero factor to every entry, so padding is exact
# ---------------------------------------------------------------------------

def pad_tt_rank(t: TTTensor, ranks: Sequence[int]) -> TTTensor:
    """Zero-pad a TT tensor's INTERIOR bond ranks up to `ranks` (len N+1).

    Boundary ranks (r_0, r_N) must match the target exactly: padding a
    boundary would change the tensor's meaning, not embed it.
    """
    cur = t.ranks
    ranks = tuple(int(r) for r in ranks)
    if len(ranks) != t.order + 1:
        raise ValueError(f"target ranks {ranks} must have length "
                         f"order+1 = {t.order + 1}")
    if ranks[0] != cur[0] or ranks[-1] != cur[-1]:
        raise ValueError(f"cannot pad TT boundary ranks {cur[0], cur[-1]} "
                         f"to {ranks[0], ranks[-1]}")
    if any(r < c for r, c in zip(ranks, cur)):
        raise ValueError(f"target ranks {ranks} below current {cur}")
    cores = tuple(
        torch.nn.functional.pad(c, (0, ranks[n + 1] - cur[n + 1], 0, 0,
                                    0, ranks[n] - cur[n]))
        for n, c in enumerate(t.cores))
    return TTTensor(cores)


def pad_cp_rank(t: CPTensor, rank: int) -> CPTensor:
    """Zero-pad a CP tensor's component rank up to `rank` (exact)."""
    if rank < t.rank:
        raise ValueError(f"target rank {rank} below current {t.rank}")
    if rank == t.rank:
        return t
    factors = tuple(torch.nn.functional.pad(f, (0, rank - t.rank))
                    for f in t.factors)
    weights = (None if t.weights is None
               else torch.nn.functional.pad(t.weights, (0, rank - t.rank)))
    return CPTensor(factors, weights)


def stack_ragged_tt(tensors: Sequence[TTTensor]) -> BatchedTTTensor:
    """Stack same-dims TT tensors of possibly DIFFERENT bond ranks: interior
    ranks are zero-padded to the per-bond max (exact); mismatched dims
    raise a ValueError naming them."""
    first = tensors[0]
    for t in tensors[1:]:
        if t.dims != first.dims:
            raise ValueError(f"cannot coalesce TT tensors with mismatched "
                             f"dims: {t.dims} != {first.dims}")
    ranks = tuple(max(t.ranks[n] for t in tensors)
                  for n in range(first.order + 1))
    return BatchedTTTensor.stack([pad_tt_rank(t, ranks) for t in tensors])


def stack_ragged_cp(tensors: Sequence[CPTensor]) -> BatchedCPTensor:
    """Stack same-dims CP tensors of possibly DIFFERENT component ranks,
    zero-padded to the max (exact). Unweighted tensors mixed with weighted
    ones get all-ones weights before padding."""
    first = tensors[0]
    for t in tensors[1:]:
        if t.dims != first.dims:
            raise ValueError(f"cannot coalesce CP tensors with mismatched "
                             f"dims: {t.dims} != {first.dims}")
    rank = max(t.rank for t in tensors)
    if any(t.weights is not None for t in tensors):
        tensors = [t if t.weights is not None
                   else CPTensor(t.factors, t.factors[0].new_ones((t.rank,)))
                   for t in tensors]
    return BatchedCPTensor.stack([pad_cp_rank(t, rank) for t in tensors])


# ---------------------------------------------------------------------------
# Random constructions
# ---------------------------------------------------------------------------

def random_tt(generator: torch.Generator, dims: Sequence[int], rank: int, *,
              norm: str | None = None, dtype=torch.float32) -> TTTensor:
    """Gaussian random TT tensor with bond rank `rank`, on the generator's
    device. norm='unit' rescales to ||T||_F = 1 (the paper's experiments
    draw unit-norm rank-10 TT inputs)."""
    N = len(dims)
    ranks = [1] + [int(rank)] * (N - 1) + [1]
    cores = tuple(torch.randn((ranks[n], int(dims[n]), ranks[n + 1]),
                              generator=generator, device=generator.device,
                              dtype=dtype) for n in range(N))
    t = TTTensor(cores)
    if norm == "unit":
        nrm = torch.sqrt(t.norm_squared())
        t = t.scale(torch.where(nrm > 0, 1.0 / nrm, torch.ones_like(nrm)))
    return t


def random_cp(generator: torch.Generator, dims: Sequence[int], rank: int, *,
              norm: str | None = None, dtype=torch.float32) -> CPTensor:
    """Gaussian random CP tensor with `rank` components (see `random_tt`)."""
    factors = tuple(torch.randn((int(d), int(rank)), generator=generator,
                                device=generator.device, dtype=dtype)
                    for d in dims)
    t = CPTensor(factors)
    if norm == "unit":
        nrm = torch.sqrt(t.norm_squared())
        t = t.scale(torch.where(nrm > 0, 1.0 / nrm, torch.ones_like(nrm)))
    return t


# ---------------------------------------------------------------------------
# Inner products (never materialize the dense tensor)
# ---------------------------------------------------------------------------

def tt_inner(a: TTTensor, b: TTTensor) -> torch.Tensor:
    """<A, B> for TT tensors in O(N d R_a R_b (R_a + R_b))."""
    if a.dims != b.dims:
        raise ValueError(f"dims differ: {a.dims} != {b.dims}")
    carry = a.cores[0].new_ones((1, 1))  # (ra, rb)
    for ca, cb in zip(a.cores, b.cores):
        tmp = torch.einsum("ab,adc->bdc", carry, ca)      # (rb, d, ra')
        carry = torch.einsum("bdc,bde->ce", tmp, cb)      # (ra', rb')
    return carry.reshape(())


def _weights(t: CPTensor) -> torch.Tensor:
    return (t.weights if t.weights is not None
            else t.factors[0].new_ones((t.rank,)))


def cp_inner(a: CPTensor, b: CPTensor) -> torch.Tensor:
    """<A, B> for CP tensors in O(N d R_a R_b)."""
    if a.dims != b.dims:
        raise ValueError(f"dims differ: {a.dims} != {b.dims}")
    acc = a.factors[0].new_ones((a.rank, b.rank))
    for fa, fb in zip(a.factors, b.factors):
        acc = acc * (fa.T @ fb)
    return torch.einsum("a,ab,b->", _weights(a), acc, _weights(b))


def tt_cp_inner(a: TTTensor, b: CPTensor) -> torch.Tensor:
    """<TT, CP> in O(N d R_tt^2 R_cp)."""
    if a.dims != b.dims:
        raise ValueError(f"dims differ: {a.dims} != {b.dims}")
    carry = a.cores[0].new_ones((1, b.rank))  # (r_tt, R_cp)
    for core, fac in zip(a.cores, b.factors):
        carry = torch.einsum("rp,rds,dp->sp", carry, core, fac)
    return torch.einsum("sp,p->", carry, _weights(b))  # s == 1


def dense_inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.vdot(a.reshape(-1), b.reshape(-1))


# ---------------------------------------------------------------------------
# TT-SVD: dense -> TT (used to tensorize real data)
# ---------------------------------------------------------------------------

def tt_svd(x: torch.Tensor, max_rank: int) -> TTTensor:
    """Deterministic TT-SVD (Oseledets 2011) with a rank cap. Small inputs
    only. The cores are fixed up to the signs of the singular vectors."""
    dims = tuple(x.shape)
    N = len(dims)
    cores = []
    r_prev = 1
    mat = x.reshape(r_prev * dims[0], -1)
    for n in range(N - 1):
        u, s, vt = torch.linalg.svd(mat, full_matrices=False)
        r = min(max_rank, u.shape[1])
        u, s, vt = u[:, :r], s[:r], vt[:r, :]
        cores.append(u.reshape(r_prev, dims[n], r))
        mat = s[:, None] * vt
        r_prev = r
        if n < N - 2:
            mat = mat.reshape(r_prev * dims[n + 1], -1)
    cores.append(mat.reshape(r_prev, dims[-1], 1))
    return TTTensor(tuple(cores))


def tensorize(vec: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """Reshape a flat vector of size prod(dims) into an order-N tensor."""
    if vec.numel() != _prod(dims):
        raise ValueError(f"cannot tensorize {vec.numel()} elements into "
                         f"dims {tuple(dims)}")
    return vec.reshape(tuple(int(d) for d in dims))


def auto_dims(size: int, *, max_order: int = 4,
              align: int = 128) -> tuple[int, ...]:
    """Tensorize a flat vector of `size` elements into `align`-multiples.

    Same factorization as the reference: peel off `align` while it divides
    the remainder, then sort the modes in decreasing order.
    """
    if size <= align:
        return (size,)
    dims: list[int] = []
    rem = size
    while len(dims) < max_order - 1 and rem % align == 0 and rem > align:
        dims.append(align)
        rem //= align
    dims.append(rem)
    return tuple(sorted(dims, reverse=True))


def pad_to_tensorizable(vec: torch.Tensor, align: int = 128,
                        max_order: int = 4
                        ) -> tuple[torch.Tensor, tuple[int, ...], int]:
    """Zero-pad a flat vector so its length factorizes into aligned modes.

    Returns (padded_vec, dims, original_len).
    """
    n = vec.numel()
    padded = int(math.ceil(n / align) * align)
    dims = auto_dims(padded, max_order=max_order, align=align)
    if padded != n:
        vec = torch.cat([vec, vec.new_zeros(padded - n)])
    return vec, dims, n

