"""TT entries of the mode-sweep kernels K1/K5/K2 (`_sweep.py`).

Counterpart of `repro/kernels/tt_sweep.py`. Core layout is
`ops.tt_cores_squeezed`: (k, d1, R), interior (k, R, d, R), (k, R, dN);
these entries check it and hand the cores to the family-agnostic kernels,
which execute the TT program the planner emits (bond alternating u/v
between steps). `scale` is fused into the kernels' epilogue: pass
1/sqrt(k) for the JLT scaling.
"""
from __future__ import annotations

import torch

from ._sweep import (sweep_project, sweep_project_pipelined,
                     sweep_reconstruct)
from .ops import ContractionPlan


def _check_layout(cores, plan: ContractionPlan) -> None:
    k, r, dims = plan.k, plan.rank, plan.dims
    want = ([(k, dims[0], r)] + [(k, r, d, r) for d in dims[1:-1]]
            + [(k, r, dims[-1])])
    got = [tuple(c.shape) for c in cores]
    if plan.family != "tt" or got != want:
        raise ValueError(f"TT sweep expects squeezed cores {want} under a "
                         f"'tt' plan, got {got} under {plan.family!r}")


def tt_sweep_project(x: torch.Tensor, *cores: torch.Tensor,
                     plan: ContractionPlan, scale: float) -> torch.Tensor:
    """Batched order-N TT projection, x (B, d1, ..., dN) -> (B, k)."""
    _check_layout(cores, plan)
    kern = (sweep_project_pipelined if plan.pipeline == "double"
            else sweep_project)
    return kern(x, *cores, plan=plan, scale=scale)


def tt_sweep_reconstruct(y: torch.Tensor, *cores: torch.Tensor,
                         plan: ContractionPlan,
                         scale: float) -> torch.Tensor:
    """Batched order-N TT adjoint, y (B, k) -> (B, d1, ..., dN)."""
    _check_layout(cores, plan)
    return sweep_reconstruct(y, *cores, plan=plan, scale=scale)
