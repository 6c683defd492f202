"""Structure-dispatched projection: plan lookup -> record -> execute.

Port of `repro/rp/dispatch.py`. `project` inspects the input's structure
(dense tensor, flat vector, `TTTensor` / `CPTensor`, or the batched
containers), raising a typed `FormatMismatchError` on incompatible shapes,
and every execution resolves through a cached
`repro_torch.rp.plan.ExecutionPlan`. This module imports no kernel module:
every kernel decision is behind the plan layer.

Instrumentation is CONTEXT-LOCAL: a `DispatchStats` object held in a
`contextvars.ContextVar` carries the kernel-dispatch counter and the
per-(family, structure, route, order) `breakdown`; `dispatch_stats()`
installs a fresh one for a dynamic scope. PyTorch runs eagerly, so a
kernel-route dispatch is one kernel-wrapper call. The `repro.obs` spans
wait for the telemetry slice.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import numpy as np
import torch

from repro_torch.core.cp_rp import CPRP
from repro_torch.core.formats import STRUCT_TYPES, _prod
from repro_torch.core.tt_rp import TTRP

from . import plan as _plan
from .protocol import FormatMismatchError, RPOperator


@dataclasses.dataclass
class DispatchStats:
    """Context-local dispatch instrumentation.

    kernel_calls : `project`/`reconstruct` dispatches that routed to a
                   kernel in this context.
    breakdown    : per-(family, structure, route, order) dispatch counts,
                   both routes; kernel_calls equals the sum of the
                   route == 'kernel' entries.
    """

    kernel_calls: int = 0
    breakdown: dict = dataclasses.field(default_factory=dict)

    def record(self, family: str, structure: str, route: str,
               order: int) -> None:
        """Count one dispatch; kernel routes also bump `kernel_calls`."""
        key = (family, structure, route, order)
        self.breakdown[key] = self.breakdown.get(key, 0) + 1
        if route == "kernel":
            self.kernel_calls += 1


_ROOT_STATS = DispatchStats()
_STATS: contextvars.ContextVar[DispatchStats] = contextvars.ContextVar(
    "repro_torch_rp_dispatch_stats", default=_ROOT_STATS)


def current_stats() -> DispatchStats:
    """The `DispatchStats` object active in the current context."""
    return _STATS.get()


def kernel_call_count() -> int:
    """How many dispatches routed to a kernel in this context."""
    return _STATS.get().kernel_calls


@contextlib.contextmanager
def dispatch_stats():
    """Install a fresh, isolated `DispatchStats` for the dynamic scope."""
    stats = DispatchStats()
    token = _STATS.set(stats)
    try:
        yield stats
    finally:
        _STATS.reset(token)


def dispatch_breakdown() -> dict:
    """A copy of the current context's per-(family, structure, route,
    order) dispatch counts."""
    return dict(_STATS.get().breakdown)


def count_kernel_dispatch(family: str = "extern", structure: str = "extern",
                          order: int = 0) -> None:
    """Record one kernel dispatch on the context-local stats.

    The hook for kernel wrappers that live OUTSIDE the project/reconstruct
    dispatch matrix (the fused unsketch+EF+AdamW launch in
    `optim.adamw.update_sketched`), so `kernel_call_count()` stays the one
    count of kernel dispatches. The tags place the launch in the
    per-(family, structure, route, order) `breakdown` under route
    'kernel'; untagged calls land under ('extern', 'extern', 'kernel', 0).
    """
    _STATS.get().record(family, structure, "kernel", int(order))


def _op_device(op) -> torch.device:
    return getattr(op, "device", torch.device("cpu"))


def _as_tensor(op, x) -> torch.Tensor:
    """A float tensor on the operator's device (numpy arrays are copied
    there; tensors must already live there)."""
    dev = _op_device(op)
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x, device=dev)
    if not isinstance(x, torch.Tensor):
        raise FormatMismatchError(f"expected a tensor or numpy array, got "
                                  f"{type(x).__name__}")
    if x.device != dev:
        raise FormatMismatchError(f"input on {x.device}, operator on {dev}")
    return x


def _coerce_dense(op: RPOperator, x) -> torch.Tensor:
    """Reshape/pad a dense array to `(*batch, *op.in_dims)`.

    Accepts exact `(*batch, *in_dims)` tensors; `(*batch, D)` flat vectors
    with D == prod(in_dims); any unbatched tensorization with the right
    element count; and `(*batch, D)` SHORT flat vectors, zero-padded up to
    prod(in_dims) (harmless under a linear map). Rejects near-miss tensors
    that match `in_dims` on every mode but the last — overwhelmingly
    truncated buckets, not flat-vector batches.
    """
    dims = tuple(op.in_dims)
    n = len(dims)
    size = _prod(dims)
    x = _as_tensor(op, x)
    if x.ndim >= n and tuple(x.shape[x.ndim - n:]) == dims:
        return x
    if x.ndim >= 1 and x.shape[-1] == size:
        return x.reshape(tuple(x.shape[:-1]) + dims)
    if x.ndim >= n and x.numel() == size:
        return x.reshape(dims)
    if (x.ndim >= n and n > 1 and tuple(x.shape[x.ndim - n:-1]) == dims[:-1]
            and x.shape[-1] != dims[-1]):
        raise FormatMismatchError(
            f"dense input of shape {tuple(x.shape)} matches in_dims={dims} "
            f"on every mode but the last ({x.shape[-1]} != {dims[-1]}) — "
            "refusing to reinterpret a near-miss tensor as flat vectors")
    if x.ndim >= 1 and x.shape[-1] < size:
        x = torch.nn.functional.pad(x, (0, size - x.shape[-1]))
        return x.reshape(tuple(x.shape[:-1]) + dims)
    raise FormatMismatchError(
        f"dense input of shape {tuple(x.shape)} is incompatible with "
        f"operator in_dims={dims} (flat size {size})")


def _run_planned(eplan, op, x) -> torch.Tensor:
    """Record one dispatch on the context stats and execute the plan."""
    _STATS.get().record(eplan.family, eplan.structure, eplan.route,
                        eplan.order)
    return _plan.execute_plan(eplan, op, x)


def _check_struct_dims(op: RPOperator, x) -> None:
    if tuple(x.dims) != tuple(op.in_dims):
        raise FormatMismatchError(
            f"{type(x).__name__} input dims {tuple(x.dims)} != operator "
            f"in_dims {tuple(op.in_dims)}")


def _project_struct(op: RPOperator, x, backend: str,
                    pipeline: str) -> torch.Tensor:
    """Structured (TT/CP-format) input(s), single or batched: TT/CP
    operators project in the compressed domain — the carry-sweep kernels
    on the kernel route, their einsum oracles otherwise; a batched
    container is ONE dispatch either way. Densifying for flat-vector
    families waits with those families, so any other operator raises."""
    if not isinstance(op, (TTRP, CPRP)):
        raise TypeError(f"structured inputs project with a TT/CP operator, "
                        f"got {type(op).__name__}")
    _check_struct_dims(op, x)
    if x.device != _op_device(op):
        raise FormatMismatchError(f"input on {x.device}, operator on "
                                  f"{_op_device(op)}")
    eplan = _plan.plan_execution(op, _plan.struct_signature(op, x),
                                 backend=backend, pipeline=pipeline)
    return _run_planned(eplan, op, x)


def project(op: RPOperator, x, *, backend: str = "auto",
            pipeline: str = "serial") -> torch.Tensor:
    """Project `x` with `op`, dispatching on the input's structure.

    x may be a dense array `(*batch, *op.in_dims)`, a flat vector or a
    `(*batch, D)` stack of them (short vectors zero-padded), a `TTTensor` /
    `CPTensor` (compressed-domain projection, never densified), or a
    `BatchedTTTensor` / `BatchedCPTensor` (a whole batch in ONE dispatch).

    `pipeline='double'` selects the double-buffered kernels on the kernel
    route (K5 for dense inputs, K6 for structured ones); same results to
    fp32 tolerance. The einsum route ignores it; it is validated either
    way. Returns the `(*batch, k)` sketch ((k,) for a single structured
    input, (B, k) for a batched container).
    """
    _plan.validate_pipeline(pipeline)
    if isinstance(x, STRUCT_TYPES):
        return _project_struct(op, x, backend, pipeline)
    xt = _coerce_dense(op, x)
    eplan = _plan.plan_execution(op, _plan.dense_signature(op, xt),
                                 backend=backend, pipeline=pipeline)
    return _run_planned(eplan, op, xt)


def reconstruct(op: RPOperator, y, *, chunk: int | None = None,
                backend: str = "auto") -> torch.Tensor:
    """Unbiased adjoint reconstruction, `(*batch, k) -> (*batch, *in_dims)`.

    Batched sketches go to the batched adjoint kernel K2 under the same
    backend policy as `project` — one launch for the whole batch. `chunk`
    is honored on the einsum route and recorded as 'folded' on the kernel
    route, whose own k-tiling bounds the intermediate.
    """
    y = _as_tensor(op, y)
    if y.ndim < 1 or y.shape[-1] != op.k:
        raise FormatMismatchError(
            f"sketch shape {tuple(y.shape)} does not end in k = {op.k}")
    eplan = _plan.plan_execution(op, _plan.sketch_signature(op, y, chunk),
                                 kind="reconstruct", backend=backend)
    return _run_planned(eplan, op, y)
