"""The single projector protocol every RP family implements.

Port of `repro/rp/protocol.py`. `RPOperator` is structural — the port's
`TTRP` / `CPRP` and the baselines `GaussianRP` / `VerySparseRP` conform
without inheriting from anything here.
`ProjectorSpec` is the declarative description a registry factory turns
into a sampled operator.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Protocol, runtime_checkable

import torch


class FormatMismatchError(TypeError):
    """Input structure/shape is incompatible with the operator.

    Raised by `repro_torch.rp.project` (and friends) instead of bare
    asserts, so callers can catch a typed error when routing heterogeneous
    inputs.
    """


@runtime_checkable
class RPOperator(Protocol):
    """Structural interface of a sampled random-projection operator.

    k            : embedding dimension (rows of the implicit map).
    in_dims      : input mode sizes; `(D,)` for flat-vector operators,
                   `(d_1, ..., d_N)` for tensorized ones.
    num_params() : stored parameter count (the paper's memory axis).
    project(x)   : dense input `(*batch, *in_dims) -> (*batch, k)`.
    reconstruct(y, *, chunk): unbiased adjoint `(k,) -> in_dims`.
    as_dense_matrix(): the `(k, prod(in_dims))` matrix (tests only).
    """

    @property
    def k(self) -> int: ...

    @property
    def in_dims(self) -> tuple[int, ...]: ...

    def num_params(self) -> int: ...

    def project(self, x: torch.Tensor) -> torch.Tensor: ...

    def reconstruct(self, y: torch.Tensor, *,
                    chunk: int | None = None) -> torch.Tensor: ...

    def as_dense_matrix(self) -> torch.Tensor: ...


@dataclasses.dataclass(frozen=True)
class ProjectorSpec:
    """Declarative description of a projector; `make_projector` samples it.

    family  : registered family name ('tt', 'cp', 'gaussian', 'sparse').
    k       : embedding dimension.
    dims    : input mode sizes. Flat-vector families contract over
              prod(dims), so a tensorized `dims` is valid for every family.
    rank    : structural rank R (ignored by the flat families).
    dtype   : parameter dtype.
    backend : execution backend for dense inputs, 'auto' | 'kernel' |
              'torch' (see `repro_torch.rp.plan`).
    """

    family: str
    k: int
    dims: tuple[int, ...]
    rank: int = 2
    dtype: Any = torch.float32
    backend: str = "auto"

    def __post_init__(self):
        object.__setattr__(self, "dims", tuple(int(d) for d in self.dims))
        if self.k <= 0:
            raise ValueError(f"k must be positive, got {self.k}")
        # local import: plan.py imports ProjectorSpec from this module
        from .plan import validate_backend
        validate_backend(self.backend)

    @property
    def input_size(self) -> int:
        return math.prod(self.dims)

    def to_dict(self) -> dict:
        """JSON-able description; round-trips through `from_dict`."""
        return {"family": self.family, "k": self.k,
                "dims": list(self.dims), "rank": self.rank,
                "dtype": str(self.dtype).removeprefix("torch."),
                "backend": self.backend}

    @classmethod
    def from_dict(cls, d: dict) -> "ProjectorSpec":
        """Inverse of `to_dict`; equal (==, hash) to the original spec."""
        dtype = getattr(torch, str(d["dtype"]), None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"unknown dtype {d.get('dtype')!r} in spec dict")
        return cls(family=d["family"], k=int(d["k"]),
                   dims=tuple(int(x) for x in d["dims"]),
                   rank=int(d.get("rank", 2)), dtype=dtype,
                   backend=d.get("backend", "auto"))

    @classmethod
    def for_flat(cls, family: str, size: int, k: int, *, rank: int = 2,
                 dtype: Any = torch.float32, backend: str = "auto",
                 max_order: int = 4, align: int = 128) -> "ProjectorSpec":
        """Spec for a flat vector of `size` elements, auto-tensorized.

        The size is padded up to a multiple of `align` first; `rp.project`
        zero-pads short flat inputs to prod(dims), which leaves the
        projection of the embedded vector unchanged (the map is linear).
        """
        from repro_torch.core.formats import auto_dims

        padded = int(math.ceil(size / align) * align)
        dims = auto_dims(padded, max_order=max_order, align=align)
        return cls(family=family, k=k, dims=dims, rank=rank, dtype=dtype,
                   backend=backend)
