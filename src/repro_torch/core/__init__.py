"""repro_torch.core — the paper's two maps (Definitions 1 & 2) in PyTorch.

Counterpart of `repro.core`: `TTRP`/`CPRP` with their samplers, the
paper's baselines `GaussianRP`/`VerySparseRP`, the TRP helpers, the TT/CP
containers with their inner products and `tt_svd`, flat-vector
tensorization, the pytree sketcher and a copy of the Thm-1/2 theory.
`from_numpy_operator` carries the reference package's operator parameters
across (for the baselines, its blocks), so both packages compute the same
map; `from_numpy_tt` / `from_numpy_cp` do the same for structured inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from . import theory
from .baselines import GaussianRP, VerySparseRP
from .cp_rp import CPRP, sample_cp_rp, trp_average, trp_project
from .device import resolve_device
from .formats import (STRUCT_TYPES, BatchedCPTensor, BatchedTTTensor,
                      CPTensor, TTTensor, auto_dims, cp_inner, dense_inner,
                      pad_cp_rank, pad_tt_rank, pad_to_tensorizable,
                      random_cp, random_tt, stack_ragged_cp, stack_ragged_tt,
                      tensorize, tt_cp_inner, tt_inner, tt_svd)
from .sketch import PytreeSketcher, SketchConfig, SketchMonitor
from .tt_rp import TTRP, sample_tt_rp

_NDIM = {"tt": 4, "cp": 3, "gaussian": 2, "sparse": 2}


def from_numpy_operator(family: str, arrays, device, *,
                        dim: int | None = None):
    """Build the port's operator from the reference's parameters.

    family : 'tt' (arrays are `TTRP.cores`, each (k, r, d, r')), 'cp'
             (`CPRP.factors`, each (k, d, R)), or 'gaussian' / 'sparse'
             (the reference's blocks `_block_mat(b)`, each (block, k),
             b = 0, 1, ...; `dim` is the operator's D).
    arrays : the parameters as numpy arrays (float32).
    """
    ts = tuple(torch.tensor(np.asarray(a, np.float32), device=device)
               for a in arrays)
    want = _NDIM.get(family)
    if want is None:
        raise ValueError(f"unknown family {family!r}; expected one of "
                         f"{tuple(_NDIM)}")
    if not ts or any(t.ndim != want for t in ts):
        raise ValueError(f"{family} parameters must be {want}-d arrays, got "
                         f"shapes {[tuple(t.shape) for t in ts]}")
    if family == "tt":
        return TTRP(ts)
    if family == "cp":
        return CPRP(ts)
    block, k = ts[0].shape
    if dim is None or -(-int(dim) // block) != len(ts):
        raise ValueError(f"{len(ts)} blocks of {block} rows need dim in "
                         f"({(len(ts) - 1) * block}, {len(ts) * block}], "
                         f"got {dim}")
    cls = GaussianRP if family == "gaussian" else VerySparseRP
    return cls(seed=0, k=int(k), dim=int(dim), block=int(block),
               device=device, blocks=ts)


def from_numpy_tt(cores, device) -> TTTensor:
    """A `TTTensor` from the reference's cores (each (r, d, r') numpy)."""
    ts = tuple(torch.tensor(np.asarray(c, np.float32), device=device)
               for c in cores)
    if not ts or any(t.ndim != 3 for t in ts):
        raise ValueError(f"TT cores must be 3-d arrays, got shapes "
                         f"{[tuple(t.shape) for t in ts]}")
    return TTTensor(ts)


def from_numpy_cp(factors, weights, device) -> CPTensor:
    """A `CPTensor` from the reference's factors (each (d, R) numpy) and
    optional weights (R,)."""
    fs = tuple(torch.tensor(np.asarray(f, np.float32), device=device)
               for f in factors)
    if not fs or any(f.ndim != 2 for f in fs):
        raise ValueError(f"CP factors must be 2-d arrays, got shapes "
                         f"{[tuple(f.shape) for f in fs]}")
    w = (None if weights is None
         else torch.tensor(np.asarray(weights, np.float32), device=device))
    return CPTensor(fs, w)


__all__ = ["BatchedCPTensor", "BatchedTTTensor", "CPRP", "CPTensor",
           "GaussianRP", "PytreeSketcher", "STRUCT_TYPES", "SketchConfig",
           "SketchMonitor", "TTRP", "TTTensor", "VerySparseRP", "auto_dims",
           "cp_inner", "dense_inner", "from_numpy_cp", "from_numpy_operator",
           "from_numpy_tt", "pad_cp_rank", "pad_to_tensorizable",
           "pad_tt_rank", "random_cp", "random_tt", "resolve_device",
           "sample_cp_rp", "sample_tt_rp", "stack_ragged_cp",
           "stack_ragged_tt", "tensorize", "theory", "trp_average",
           "trp_project", "tt_cp_inner", "tt_inner", "tt_svd"]
