"""CP entries of the mode-sweep kernels K1/K5/K2 (`_sweep.py`).

Counterpart of `repro/kernels/cp_sweep.py`. Factor layout is `op.factors`
as is: f_n (k, d_n, R). The CP program keeps one rank index 'r' through
the whole sweep, so its interior steps are rank-wise products rather than
bond contractions; for the adjoint the trailing factors fold into the
transfer block m[i, r, d2..dN] = f2[i, d2, r] * ... * fN[i, dN, r].
"""
from __future__ import annotations

import torch

from ._sweep import (sweep_project, sweep_project_pipelined,
                     sweep_reconstruct)
from .ops import ContractionPlan


def _check_layout(factors, plan: ContractionPlan) -> None:
    want = [(plan.k, d, plan.rank) for d in plan.dims]
    got = [tuple(f.shape) for f in factors]
    if plan.family != "cp" or got != want:
        raise ValueError(f"CP sweep expects factors {want} under a 'cp' "
                         f"plan, got {got} under {plan.family!r}")


def cp_sweep_project(x: torch.Tensor, *factors: torch.Tensor,
                     plan: ContractionPlan, scale: float) -> torch.Tensor:
    """Batched order-N CP projection, x (B, d1, ..., dN) -> (B, k)."""
    _check_layout(factors, plan)
    kern = (sweep_project_pipelined if plan.pipeline == "double"
            else sweep_project)
    return kern(x, *factors, plan=plan, scale=scale)


def cp_sweep_reconstruct(y: torch.Tensor, *factors: torch.Tensor,
                         plan: ContractionPlan,
                         scale: float) -> torch.Tensor:
    """Batched order-N CP adjoint, y (B, k) -> (B, d1, ..., dN)."""
    _check_layout(factors, plan)
    return sweep_reconstruct(y, *factors, plan=plan, scale=scale)
