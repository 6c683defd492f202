"""Dense Gaussian RP and very-sparse RP (Li, Hastie & Church 2006) baselines.

Port of `repro/core/baselines.py`. Both maps stream over blocks of
`block` columns of the (k, D) matrix, so it is never held whole for large
D. Each class defines its random block in `_draw`; `_StreamedFlatRP`
derives the projection, the unbiased adjoint and the materialized matrix
from that one definition, so the forward map and its adjoint cannot drift
apart.

Torch cannot replay `jax.random.fold_in(key, b)`. Block b comes from its
own `torch.Generator` on the operator's device, seeded from (the
operator's base seed, b), so `project`, `reconstruct` and `materialize`
regenerate the same block bitwise. Block b holds min(block, D - b*block)
rows: a ragged last block draws only the rows it uses. `blocks=` replaces
the seeded stream with given (block, k) matrices
(`repro_torch.core.from_numpy_operator` carries the reference's across).
"""
from __future__ import annotations

import dataclasses
import math

import torch

_SEED_MIX = 1_000_003
_SEED_MASK = (1 << 63) - 1


class _StreamedFlatRP:
    """Streaming (k, D) linear map defined block-wise by `_block_mat(b)`.

    Subclasses provide `seed`, `k`, `dim`, `block`, `device`, `blocks`
    and `_draw(generator, rows)`.
    """

    def __post_init__(self):
        # the device as its tensors report it ('cuda' -> 'cuda:0'), so
        # dispatch's device check compares like with like
        object.__setattr__(self, "device",
                           torch.empty(0, device=self.device).device)

    @property
    def in_dims(self) -> tuple[int, ...]:
        """RPOperator protocol: flat-vector operator, a single mode."""
        return (self.dim,)

    def _n_blocks(self) -> int:
        return -(-self.dim // self.block)

    def _block_mat(self, b: int, dtype=torch.float32) -> torch.Tensor:
        """Rows [b*block, min(D, (b+1)*block)) of the (D, k) matrix A^T."""
        rows = min(self.block, self.dim - b * self.block)
        if self.blocks is not None:
            return self.blocks[b][:rows].to(dtype)
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed * _SEED_MIX + b) & _SEED_MASK)
        return self._draw(gen, rows).to(dtype)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """(*batch, D) -> (*batch, k), accumulating x_blk @ A_b per block."""
        if x.shape[-1] != self.dim:
            raise ValueError(f"input shape {tuple(x.shape)} does not end in "
                             f"D = {self.dim}")
        lead = tuple(x.shape[:-1])
        x2 = x.reshape(-1, self.dim)
        out = x2.new_zeros((x2.shape[0], self.k))
        for b in range(self._n_blocks()):
            a = self._block_mat(b, x.dtype)
            lo = b * self.block
            out += x2[:, lo:lo + a.shape[0]] @ a
            del a
        return (out / math.sqrt(self.k)).reshape(lead + (self.k,))

    def reconstruct(self, y: torch.Tensor, *,
                    chunk: int | None = None) -> torch.Tensor:
        """Unbiased adjoint x_hat = A^T y / sqrt(k), streamed over blocks:
        (*batch, k) -> (*batch, D).

        `chunk` is accepted for protocol parity; streaming is governed by
        `block` (the intermediate never exceeds block * k floats).
        """
        del chunk
        if y.ndim < 1 or y.shape[-1] != self.k:
            raise ValueError(f"sketch shape {tuple(y.shape)} does not end in "
                             f"k = {self.k}")
        parts = [y @ self._block_mat(b, y.dtype).T
                 for b in range(self._n_blocks())]
        return torch.cat(parts, dim=-1) / math.sqrt(self.k)

    def materialize(self) -> torch.Tensor:
        """The dense (k, D) matrix (small D only)."""
        a = torch.cat([self._block_mat(b) for b in range(self._n_blocks())])
        return a.T / math.sqrt(self.k)

    def as_dense_matrix(self) -> torch.Tensor:
        """RPOperator protocol alias of `materialize`."""
        return self.materialize()


@dataclasses.dataclass(frozen=True, eq=False)
class GaussianRP(_StreamedFlatRP):
    """Classical JLT: y = A x / sqrt(k), A_ij ~ N(0, 1)."""

    seed: int
    k: int
    dim: int
    block: int = 65536
    device: torch.device = torch.device("cpu")
    blocks: tuple[torch.Tensor, ...] | None = None

    def num_params(self) -> int:
        return self.k * self.dim

    def _draw(self, gen: torch.Generator, rows: int) -> torch.Tensor:
        return torch.randn((rows, self.k), generator=gen, device=self.device)


@dataclasses.dataclass(frozen=True, eq=False)
class VerySparseRP(_StreamedFlatRP):
    """Li et al. 2006: A_ij = +sqrt(s) w.p. 1/2s, 0 w.p. 1-1/s, -sqrt(s)
    w.p. 1/2s.

    Default s = sqrt(D) ("very sparse"), giving ~k*sqrt(D) expected
    nonzeros. E[A_ij^2] = 1, so y = A x / sqrt(k) is an expected isometry.
    """

    seed: int
    k: int
    dim: int
    s: float | None = None
    block: int = 65536
    device: torch.device = torch.device("cpu")
    blocks: tuple[torch.Tensor, ...] | None = None

    @property
    def sparsity(self) -> float:
        return float(self.s) if self.s is not None else math.sqrt(self.dim)

    def num_params(self) -> int:
        """Expected nonzeros (index+value storage in a real implementation)."""
        return int(self.k * self.dim / self.sparsity)

    def _draw(self, gen: torch.Generator, rows: int) -> torch.Tensor:
        s = self.sparsity
        u = torch.rand((rows, self.k), generator=gen, device=self.device)
        sign = ((u < 0.5 / s).to(torch.float32)
                - (u > 1.0 - 0.5 / s).to(torch.float32))
        return sign * math.sqrt(s)


def base_seed(generator: torch.Generator) -> int:
    """One 62-bit base seed drawn from a factory's generator."""
    return int(torch.randint(0, 1 << 62, (1,), generator=generator,
                             device=generator.device))
