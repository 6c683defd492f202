"""repro_torch.core — the paper's two maps (Definitions 1 & 2) in PyTorch.

Counterpart of `repro.core` for the dense slice: `TTRP`/`CPRP` with their
samplers, the TT/CP containers, flat-vector tensorization and a copy of the
Thm-1/2 theory. `from_numpy_operator` carries the reference package's
operator parameters across, so both packages compute the same map.
"""
from __future__ import annotations

import numpy as np
import torch

from . import theory
from .cp_rp import CPRP, sample_cp_rp
from .device import resolve_device
from .formats import (STRUCT_TYPES, CPTensor, TTTensor, auto_dims,
                      pad_to_tensorizable, tensorize)
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


__all__ = ["CPRP", "CPTensor", "STRUCT_TYPES", "TTRP", "TTTensor",
           "auto_dims", "from_numpy_operator", "pad_to_tensorizable",
           "resolve_device", "sample_cp_rp", "sample_tt_rp", "tensorize",
           "theory"]
