"""Structure-dispatched projection: plan lookup -> record -> execute.

Port of `repro/rp/dispatch.py`. `project` inspects the input's structure
(dense tensor, flat vector, `TTTensor` / `CPTensor`, or the batched
containers), raising a typed `FormatMismatchError` on incompatible shapes,
and every execution resolves through a cached
`repro_torch.rp.plan.ExecutionPlan`. This module imports no kernel module:
every kernel decision is behind the plan layer.

Instrumentation is CONTEXT-LOCAL: a `DispatchStats` object held in a
`contextvars.ContextVar` carries the kernel-dispatch counter, the
per-(family, structure, route, order) `breakdown` and the force-kernel
depth; `dispatch_stats()` installs a fresh one for a dynamic scope, and
`force_kernel()` is depth-counted so nesting composes. PyTorch runs
eagerly, so a kernel-route dispatch is one kernel-wrapper call.

Every dispatch also opens a `repro_torch.obs` span (`rp.project` /
`rp.reconstruct`, tagged family/structure/order/backend/pipeline with the
RESOLVED route plus the `plan` id) — a shared no-op when telemetry is
disabled, so the hot path pays one module-global read.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.cp_rp import CPRP
from repro_torch.core.formats import (STRUCT_TYPES, BatchedCPTensor,
                                      BatchedTTTensor, _prod)
from repro_torch.core.tt_rp import TTRP

from . import plan as _plan
from .protocol import FormatMismatchError, RPOperator


@dataclasses.dataclass
class DispatchStats:
    """Context-local dispatch instrumentation.

    kernel_calls : `project`/`reconstruct` dispatches that routed to a
                   kernel in this context.
    force_depth  : nesting depth of active `force_kernel()` scopes; > 0
                   lets 'auto' take the kernel route on the CPU.
    breakdown    : per-(family, structure, route, order) dispatch counts,
                   both routes; kernel_calls equals the sum of the
                   route == 'kernel' entries.
    """

    kernel_calls: int = 0
    force_depth: int = 0
    breakdown: dict = dataclasses.field(default_factory=dict)

    @property
    def force_kernel(self) -> bool:
        return self.force_depth > 0

    def record(self, family: str, structure: str, route: str,
               order: int) -> None:
        """Count one dispatch; kernel routes also bump `kernel_calls`."""
        key = (family, structure, route, order)
        self.breakdown[key] = self.breakdown.get(key, 0) + 1
        if route == "kernel":
            self.kernel_calls += 1

    def breakdown_table(self) -> list[dict]:
        """The breakdown as sorted JSON-able rows (telemetry sinks)."""
        return [{"family": f, "structure": s, "route": r, "order": n,
                 "calls": c}
                for (f, s, r, n), c in sorted(self.breakdown.items())]


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


@contextlib.contextmanager
def force_kernel():
    """Let `backend='auto'` take the kernel route on the CPU, where the
    kernel wrappers run their plain versions (on CUDA 'auto' already
    picks the kernel). The counterpart of the reference's
    `force_pallas()`: depth-counted on the context-local stats, so nested
    scopes compose and restore."""
    stats = _STATS.get()
    stats.force_depth += 1
    try:
        yield
    finally:
        stats.force_depth -= 1


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


def _run_planned(span_name: str, eplan, op, x) -> torch.Tensor:
    """Record one dispatch on the context stats and execute the plan."""
    _STATS.get().record(eplan.family, eplan.structure, eplan.route,
                        eplan.order)
    with obs.span(span_name, family=eplan.family, structure=eplan.structure,
                  order=eplan.order, backend=eplan.route,
                  pipeline=eplan.pipeline, plan=eplan.plan_id):
        return _plan.execute_plan(eplan, op, x)


def _check_struct_dims(op: RPOperator, x) -> None:
    if tuple(x.dims) != tuple(op.in_dims):
        raise FormatMismatchError(
            f"{type(x).__name__} input dims {tuple(x.dims)} != operator "
            f"in_dims {tuple(op.in_dims)}")


def _project_dense(op: RPOperator, x, backend: str,
                   pipeline: str) -> torch.Tensor:
    xt = _coerce_dense(op, x)
    eplan = _plan.plan_execution(op, _plan.dense_signature(op, xt),
                                 backend=backend, pipeline=pipeline)
    return _run_planned("rp.project", eplan, op, xt)


def _project_struct(op: RPOperator, x, backend: str,
                    pipeline: str) -> torch.Tensor:
    """Structured (TT/CP-format) input(s), single or batched: TT/CP
    operators project in the compressed domain — the carry-sweep kernels
    on the kernel route, their einsum oracles otherwise; a batched
    container is ONE dispatch either way. Flat-vector families
    (gaussian/sparse) densify first: `(D,)` for one input, `(B, D)` for a
    batched container — only viable at small prod(dims), the regime the
    paper could run those baselines in."""
    if not isinstance(op, (TTRP, CPRP)):
        full = x.full()
        if isinstance(x, (BatchedTTTensor, BatchedCPTensor)):
            return _project_dense(op, full.reshape(full.shape[0], -1),
                                  backend, pipeline)
        return _project_dense(op, full.reshape(-1), backend, pipeline)
    _check_struct_dims(op, x)
    if x.device != _op_device(op):
        raise FormatMismatchError(f"input on {x.device}, operator on "
                                  f"{_op_device(op)}")
    eplan = _plan.plan_execution(op, _plan.struct_signature(op, x),
                                 backend=backend, pipeline=pipeline)
    return _run_planned("rp.project", eplan, op, x)


def project(op: RPOperator, x, *, backend: str = "auto",
            pipeline: str = "serial") -> torch.Tensor:
    """Project `x` with `op`, dispatching on the input's structure.

    x may be a dense array `(*batch, *op.in_dims)`, a flat vector or a
    `(*batch, D)` stack of them (short vectors zero-padded), a `TTTensor` /
    `CPTensor` (compressed-domain projection under TT/CP operators,
    densified under the flat families), or a `BatchedTTTensor` /
    `BatchedCPTensor` (a whole batch in ONE dispatch).

    `pipeline='double'` selects the double-buffered kernels on the kernel
    route (K5 for dense inputs, K6 for structured ones); same results to
    fp32 tolerance. The einsum route ignores it; it is validated either
    way. Returns the `(*batch, k)` sketch ((k,) for a single structured
    input, (B, k) for a batched container).
    """
    _plan.validate_pipeline(pipeline)
    if isinstance(x, STRUCT_TYPES):
        return _project_struct(op, x, backend, pipeline)
    return _project_dense(op, x, backend, pipeline)


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
    return _run_planned("rp.reconstruct", eplan, op, y)
