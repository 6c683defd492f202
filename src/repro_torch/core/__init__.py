"""repro_torch.core — the paper's two maps (Definitions 1 & 2) in PyTorch.

Counterpart of `repro.core`: `TTRP`/`CPRP` with their
samplers, the TT/CP containers, flat-vector tensorization and a copy of the
Thm-1/2 theory. `from_numpy_operator` carries the reference package's
operator parameters across, so both packages compute the same map;
`from_numpy_tt` / `from_numpy_cp` do the same for structured inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from . import theory
from .cp_rp import CPRP, sample_cp_rp
from .device import resolve_device
from .formats import (STRUCT_TYPES, BatchedCPTensor, BatchedTTTensor,
                      CPTensor, TTTensor, auto_dims, pad_cp_rank, pad_tt_rank,
                      pad_to_tensorizable, random_cp, random_tt,
                      stack_ragged_cp, stack_ragged_tt, tensorize)
from .tt_rp import TTRP, sample_tt_rp


def from_numpy_operator(family: str, arrays, device) -> TTRP | CPRP:
    """Build the port's operator from the reference's parameters.

    family : 'tt' (arrays are `TTRP.cores`, each (k, r, d, r')) or 'cp'
             (arrays are `CPRP.factors`, each (k, d, R)).
    arrays : the parameters as numpy arrays (float32).
    """
    ts = tuple(torch.tensor(np.asarray(a, np.float32), device=device)
               for a in arrays)
    want = {"tt": 4, "cp": 3}.get(family)
    if want is None:
        raise ValueError(f"unknown family {family!r}; expected 'tt' or 'cp'")
    if not ts or any(t.ndim != want for t in ts):
        raise ValueError(f"{family} parameters must be {want}-d arrays, got "
                         f"shapes {[tuple(t.shape) for t in ts]}")
    return TTRP(ts) if family == "tt" else CPRP(ts)


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
           "STRUCT_TYPES", "TTRP", "TTTensor", "auto_dims", "from_numpy_cp",
           "from_numpy_operator", "from_numpy_tt", "pad_cp_rank",
           "pad_to_tensorizable", "pad_tt_rank", "random_cp", "random_tt",
           "resolve_device", "sample_cp_rp", "sample_tt_rp",
           "stack_ragged_cp", "stack_ragged_tt", "tensorize", "theory"]
