"""Batch projection of a list of payloads: the serving engine's fan-out.

Port of `repro/rp/many.py` for dense payloads. `project_many(op, inputs)`
takes a LIST of single-item dense payloads — `in_dims`-shaped tensors,
other tensorizations of the same size, or SHORT flat vectors (zero-padded)
— coalesces them into one `(B, prod(in_dims))` batch and projects it in
ONE dispatch of `rp.project`. Results come back as a `(len(inputs), k)`
sketch stack in input order.

Shape bucketing (`bucket=True`, the default): the batch is zero-padded up
to a power of two (floor 8), so a serving loop's per-tick shapes repeat
and resolve one cached plan (`rp.plan.group_signature` predicts it).
Zero rows project to zero and are sliced away. TT/CP payloads raise
NotImplementedError until the carry sweep is ported.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formats import _prod

from .dispatch import _op_device, project
from .plan import STRUCT_NOT_PORTED, pow2ceil, structure_tag
from .protocol import FormatMismatchError, RPOperator


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


def project_many(op: RPOperator, inputs, *, backend: str = "auto",
                 bucket: bool = True) -> torch.Tensor:
    """Project a list of dense payloads in ONE dispatch.

    bucket : pad the batch to a power of two (floor 8) before dispatch.
    Returns the `(len(inputs), k)` sketches in input order, on the
    operator's device.
    """
    inputs = list(inputs)
    dev = _op_device(op)
    if not inputs:
        return torch.zeros((0, op.k), device=dev)
    if any(structure_tag(x) != "dense" for x in inputs):
        raise NotImplementedError(STRUCT_NOT_PORTED)
    flats = [_flat_payload(op, x) for x in inputs]
    if all(f.device.type == "cpu" for f in flats):
        xb = torch.stack(flats).to(dev, torch.float32)   # one host->device copy
    else:
        xb = torch.stack([f.to(dev, torch.float32) for f in flats])
    b_pad = pow2ceil(len(flats), 8) if bucket else len(flats)
    if b_pad > len(flats):
        xb = torch.nn.functional.pad(xb, (0, 0, 0, b_pad - len(flats)))
    return project(op, xb, backend=backend)[:len(flats)]
