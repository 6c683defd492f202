"""Public wrapper around the carry-sweep kernels: layout + planning.

Port of `repro/kernels/struct/ops.py`. `struct_project(op, x)` projects
structured input(s) — `TTTensor`, `CPTensor`, or their batched containers
— with a TT or CP operator in ONE kernel launch, for all four (operator,
input) family pairings at any order 2..MAX_ORDER. The wrapper:

  * normalizes the input to a batched container (a single tensor becomes a
    B=1 batch; the batch axis is stripped again on return),
  * converts to the kernel layouts (squeezed TT boundary bonds on both the
    operator and the input; CP weights folded into the first factor — a
    scalar reweighting of one factor, exact by multilinearity),
  * plans the sweep (`plan.plan_carry_sweep`) and launches K3
    (`carry.carry_sweep_project`) or, under `pipeline='double'`, K6, with
    the 1/sqrt(k) scale fused. Nothing is padded: the kernels mask their
    ragged k and batch edges.

With `use_kernel=False`, or for orders above MAX_ORDER, the same layouts
run through the batched einsum oracles in `ref.py` — the einsum route
`rp.project(..., backend='torch')` uses for structured inputs. Order-1
operators project the dense input (a 1-core TT/CP tensor is its own
densification).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.cp_rp import CPRP
from repro_torch.core.formats import (STRUCT_TYPES, BatchedCPTensor,
                                      BatchedTTTensor, CPTensor, TTTensor)
from repro_torch.core.tt_rp import TTRP

from ..ops import kernel_order_supported, tt_cores_squeezed, validate_pipeline
from . import ref
from .carry import carry_sweep_project, carry_sweep_project_pipelined
from .plan import plan_carry_sweep


def _as_batched(x):
    """-> (in_family, batched container, was_batched)."""
    if isinstance(x, TTTensor):
        return "tt", BatchedTTTensor(tuple(c[None] for c in x.cores)), False
    if isinstance(x, CPTensor):
        w = None if x.weights is None else x.weights[None]
        return "cp", BatchedCPTensor(tuple(f[None] for f in x.factors),
                                     w), False
    if isinstance(x, BatchedTTTensor):
        return "tt", x, True
    if isinstance(x, BatchedCPTensor):
        return "cp", x, True
    raise TypeError(f"not a structured input: {type(x).__name__}")


def _in_operands(in_family: str, xb) -> tuple[torch.Tensor, ...]:
    """Kernel layout of the batched input: TT boundary bonds squeezed /
    CP weights folded into factor 0."""
    if in_family == "tt":
        cores = xb.cores
        if len(cores) == 1:
            return (cores[0][:, 0, :, 0],)
        return ((cores[0][:, 0, :, :],) + tuple(cores[1:-1])
                + (cores[-1][:, :, :, 0],))
    factors = xb.factors
    if xb.weights is not None:
        factors = (factors[0] * xb.weights[:, None, :],) + tuple(factors[1:])
    return tuple(factors)


def struct_rank(x) -> int:
    """Structural rank of a (batched) TT/CP input: max bond rank for TT
    (boundary 1s included), component count for CP."""
    if isinstance(x, (TTTensor, BatchedTTTensor)):
        return max(x.ranks)
    return x.rank


def struct_project(op, x, *, use_kernel: bool = True,
                   pipeline: str = "serial") -> torch.Tensor:
    """Project structured input(s) with a TT/CP operator, never densifying.

    x: TTTensor / CPTensor -> (k,); BatchedTTTensor / BatchedCPTensor with
    batch B -> (B, k) — ONE carry-sweep launch for the whole batch.
    `pipeline='double'` launches K6 instead of K3 (same function).
    """
    validate_pipeline(pipeline)
    if not isinstance(op, (TTRP, CPRP)):
        raise TypeError(f"struct_project needs a TT/CP operator, got "
                        f"{type(op).__name__}")
    op_family = "tt" if isinstance(op, TTRP) else "cp"
    in_family, xb, batched = _as_batched(x)
    if tuple(xb.dims) != tuple(op.in_dims):
        raise ValueError(f"input dims {tuple(xb.dims)} != operator in_dims "
                         f"{tuple(op.in_dims)}")
    k, b = op.k, xb.batch
    if op.order < 2:
        # a 1-core structured tensor IS dense; project it as such
        y = op.project(xb.full().reshape(b, *op.in_dims))
        return y if batched else y[0]
    op_cores = tt_cores_squeezed(op) if op_family == "tt" else op.factors
    in_cores = _in_operands(in_family, xb)
    if not use_kernel or not kernel_order_supported(op.order):
        y = ref.REFS[(op_family, in_family)](op_cores, in_cores) / math.sqrt(k)
        return y if batched else y[0]
    plan = plan_carry_sweep(op_family, in_family, k, b, op.in_dims,
                            op.rank, struct_rank(xb), pipeline=pipeline)
    kern = (carry_sweep_project_pipelined if pipeline == "double"
            else carry_sweep_project)
    cores = [c.contiguous() for c in (*op_cores, *in_cores)]
    y = kern(*cores, n_op=len(op_cores), plan=plan, scale=1.0 / math.sqrt(k))
    return y if batched else y[0]


__all__ = ["STRUCT_TYPES", "struct_project", "struct_rank"]
