"""Tensor-train (TT) and CP tensor containers and flat-vector tensorization.

Port of `repro/core/formats.py` for the dense slice: the containers exist
so that dispatch and `SketchServer.submit` can recognise structured
payloads; projecting them (the carry sweep) comes with the structured-input
slice, together with the batched containers, rank padding, `random_tt` /
`random_cp`, `tt_svd` and the inner products.

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


STRUCT_TYPES = (TTTensor, CPTensor)
