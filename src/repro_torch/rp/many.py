"""Mixed-structure batch projection: the serving engine's fan-out entry.

Port of `repro/rp/many.py`. `project_many(op, inputs)` takes a LIST of
single-item payloads — dense tensors / flat vectors (ragged lengths,
zero-padded), `TTTensor`s (rank-ragged: interior bond ranks zero-padded,
exact) and `CPTensor`s (rank-ragged likewise) — groups them by structure,
coalesces each group into one batched container (`(B, prod(in_dims))` for
dense payloads, `BatchedTTTensor` / `BatchedCPTensor` for structured ones)
and projects each group in ONE dispatch of `rp.project`: at most three
dispatches per call, one for a structurally homogeneous list (what the
serving batcher's lanes deliver). Results come back as a
`(len(inputs), k)` sketch stack in input order.

Shape bucketing (`bucket=True`, the default): the batch is zero-padded up
to a power of two (floor 8) and structured interior ranks up to powers of
two, so a serving loop's per-tick shapes repeat and resolve one cached
plan (`rp.plan.group_signature` predicts it). Padding is exact: zero rows
and zero rank channels contribute nothing, and are sliced away.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formats import (BatchedCPTensor, BatchedTTTensor,
                                      _prod, stack_ragged_cp,
                                      stack_ragged_tt)

from .dispatch import _op_device, project
from .plan import pow2ceil, structure_tag
from .protocol import FormatMismatchError, RPOperator


def _pad_batch_tt(xb: BatchedTTTensor, b_pad: int) -> BatchedTTTensor:
    """Zero-pad batch to `b_pad` rows and interior bond ranks to powers of
    two (exact; see module docstring)."""
    rk = xb.ranks
    tgt = (rk[0],) + tuple(pow2ceil(r) for r in rk[1:-1]) + (rk[-1],)
    cores = tuple(
        torch.nn.functional.pad(c, (0, tgt[n + 1] - rk[n + 1], 0, 0,
                                    0, tgt[n] - rk[n], 0, b_pad - xb.batch))
        for n, c in enumerate(xb.cores))
    return BatchedTTTensor(cores)


def _pad_batch_cp(xb: BatchedCPTensor, b_pad: int) -> BatchedCPTensor:
    """Zero-pad batch to `b_pad` rows and the component rank to a power of
    two (exact)."""
    r_pad = pow2ceil(xb.rank)
    factors = tuple(
        torch.nn.functional.pad(f, (0, r_pad - xb.rank, 0, 0,
                                    0, b_pad - xb.batch))
        for f in xb.factors)
    weights = (None if xb.weights is None else torch.nn.functional.pad(
        xb.weights, (0, r_pad - xb.rank, 0, b_pad - xb.batch)))
    return BatchedCPTensor(factors, weights)


def _flat_payload(op: RPOperator, x) -> torch.Tensor:
    """One dense payload -> a `(prod(in_dims),)` flat vector, zero-padded,
    on the payload's own device (numpy arrays: the CPU, copied only when
    read-only)."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        x = torch.from_numpy(a if a.flags.writeable else a.copy())
    size = _prod(op.in_dims)
    if x.numel() == size:
        return x.reshape(-1)
    if x.ndim == 1 and x.numel() < size:
        return torch.nn.functional.pad(x, (0, size - x.numel()))
    raise FormatMismatchError(
        f"dense payload of shape {tuple(x.shape)} is not a single input for "
        f"operator in_dims={tuple(op.in_dims)} (flat size {size}); "
        "project_many takes one payload per sketch row")


def stack_dense(op: RPOperator, xs, *, bucket: bool = True) -> torch.Tensor:
    """Dense single payloads -> the `(B_pad, prod(in_dims))` float32 batch
    on the operator's device that `project_many` dispatches (one copy;
    `B_pad` is `pow2ceil(B, 8)` when bucketing, else `B`; pad rows zero)."""
    dev = _op_device(op)
    flats = [_flat_payload(op, x) for x in xs]
    if all(f.device.type == "cpu" for f in flats):
        xb = torch.stack(flats).to(dev, torch.float32)   # one host->device copy
    else:
        xb = torch.stack([f.to(dev, torch.float32) for f in flats])
    b_pad = pow2ceil(len(flats), 8) if bucket else len(flats)
    if b_pad > len(flats):
        xb = torch.nn.functional.pad(xb, (0, 0, 0, b_pad - len(flats)))
    return xb


def _to_device(xb, dev):
    """The coalesced container on the operator's device, float32 (one copy
    per core of the whole group)."""
    if isinstance(xb, BatchedTTTensor):
        return BatchedTTTensor(tuple(c.to(dev, torch.float32)
                                     for c in xb.cores))
    w = None if xb.weights is None else xb.weights.to(dev, torch.float32)
    return BatchedCPTensor(tuple(f.to(dev, torch.float32)
                                 for f in xb.factors), w)


def project_many(op: RPOperator, inputs, *, backend: str = "auto",
                 bucket: bool = True) -> torch.Tensor:
    """Project a heterogeneous list of payloads in the fewest dispatches.

    inputs : dense arrays / flat vectors / `TTTensor`s / `CPTensor`s, each
             a SINGLE item (batched containers already are one dispatch
             via `rp.project` and are rejected here).
    bucket : pad batch size / interior ranks to powers of two before
             dispatch (exact; keeps repeat-call shapes stable).
    Returns the `(len(inputs), k)` sketches in input order, on the
    operator's device; one dispatch per structure group present (<= 3).
    """
    inputs = list(inputs)
    if not inputs:
        return torch.zeros((0, op.k), device=_op_device(op))
    groups: dict[str, tuple[list[int], list]] = {}
    for i, x in enumerate(inputs):
        if isinstance(x, (BatchedTTTensor, BatchedCPTensor)):
            raise FormatMismatchError(
                f"project_many got a {type(x).__name__}; batched containers "
                "are already one dispatch — call rp.project directly")
        idxs, xs = groups.setdefault(structure_tag(x), ([], []))
        idxs.append(i)
        xs.append(x)
    rows: list = [None] * len(inputs)
    for tag, (idxs, xs) in groups.items():
        b_pad = pow2ceil(len(xs), 8) if bucket else len(xs)
        if tag == "dense":
            xb = stack_dense(op, xs, bucket=bucket)
        elif tag == "tt":
            xb = stack_ragged_tt(xs)
            if bucket:
                xb = _pad_batch_tt(xb, b_pad)
        else:
            xb = stack_ragged_cp(xs)
            if bucket:
                xb = _pad_batch_cp(xb, b_pad)
        if tag != "dense":
            xb = _to_device(xb, _op_device(op))
        y = project(op, xb, backend=backend)        # ONE dispatch per group
        for j, idx in enumerate(idxs):
            rows[idx] = y[j]
    if len(groups) == 1:
        return y[:len(inputs)]
    return torch.stack(rows)
