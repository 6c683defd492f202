"""K4: the fused unsketch + error-feedback + AdamW kernel (`fused_update`).

Port of `repro/kernels/fused_update.py`. The unfused sketch-compressed
step runs, per dense leaf,

    g_hat = alpha * Unsketch(y)     (reconstruct kernel -> dense write)
    resid = p - g_hat               (EF residual: two dense reads, one write)
    m/v/w updates                   (AdamW: three dense read/write passes)

which writes the dense reconstruction g_hat to device memory and then
streams every dense operand again. K4 (`csrc/fused_update.cu`) fuses the
chain into ONE call per leaf: K2's fold and operator-tile product
(`csrc/sweep_reconstruct.cuh`), whose output tile stays in registers over
the whole k depth, with an epilogue that reads p, w, m, v at the tile's
offsets and writes

    resid = p - g_hat                         (error feedback)
    m32   = b1 m + (1-b1) g_hat               (AdamW moments, f32)
    v32   = b2 v + (1-b2) g_hat^2
    w'    = w - lr ((m32/c1)/(sqrt(v32/c2)+eps) + wd w)

so g_hat is never stored. The JLT 1/sqrt(k) and the MMSE shrinkage alpha
fuse into one scale; lr, c1 and c2 go to the kernel in a float32 device
array, so a changing schedule never syncs the host.

Inputs arrive in BUCKET space, all float32 (`PytreeSketcher.
_leaf_to_buckets` casts on the way in, `_leaf_from_buckets` casts back to
the storage dtype on the way out — the cast points of the unfused chain).

`fused_hbm_bytes` / `unfused_hbm_bytes` give the analytic device-memory
traffic of the two formulations for the same plan.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.cp_rp import CPRP
from repro_torch.core.formats import _prod
from repro_torch.core.tt_rp import TTRP

from .ops import (MAX_ORDER, MAX_RANK, ContractionPlan, kernel_order_supported,
                  plan_contraction, sweep_hbm_bytes, tt_cores_squeezed)


def plan_fused_update(family: str, k: int, b: int, dims: tuple[int, ...],
                      rank: int) -> ContractionPlan:
    """Reconstruct-sweep plan for the fused launch: K2's tiles (batch
    tile, depth chunk, slab of leading indices, chunk of T) and grid.

    The reference charged the eight dense tiles its TPU kernel kept in
    VMEM against the sweep's budget and iterated to a fixed point. The
    CUDA epilogue reads p, w, m and v straight from device memory into
    registers and writes the four outputs the same way, so it charges no
    extra shared memory: the plan is K2's reconstruct plan as it is.
    """
    return plan_contraction(family, "reconstruct", k, b,
                            tuple(int(d) for d in dims), rank)


def fused_hbm_bytes(plan: ContractionPlan) -> int:
    """Analytic device-memory traffic of ONE fused launch under `plan`.

    The sweep-side traffic (`sweep_hbm_bytes`) MINUS its dense output
    write — g_hat stays in registers — plus eight dense passes: p/w/m/v
    read once each, resid/w'/m'/v' written once each.
    """
    dense = 4 * plan.b * _prod(plan.dims)
    return (sweep_hbm_bytes(plan) - dense) + 8 * dense


def unfused_hbm_bytes(plan: ContractionPlan) -> int:
    """Analytic device-memory traffic of the UNFUSED chain for `plan`.

    The reconstruct launch (`sweep_hbm_bytes`, which includes the dense
    g_hat WRITE) plus nine dense passes: g_hat and p read for the residual,
    resid written, and w/m/v each read and written by the optimizer step.
    """
    dense = 4 * plan.b * _prod(plan.dims)
    return sweep_hbm_bytes(plan) + 9 * dense


def _operator(op):
    """(family, cores in kernel layout), or the reference's typed errors."""
    if not isinstance(op, (TTRP, CPRP)):
        raise TypeError(f"fused_update_buckets needs a TT/CP operator, got "
                        f"{type(op).__name__}")
    if not kernel_order_supported(op.order):
        raise ValueError(
            f"fused_update_buckets needs a kernel-supported operator order "
            f"(2..{MAX_ORDER}), got order {op.order}")
    family = "tt" if isinstance(op, TTRP) else "cp"
    cores = tt_cores_squeezed(op) if family == "tt" else op.factors
    return family, tuple(c.contiguous() for c in cores)


def _scalars(lr, c1, c2, device) -> torch.Tensor:
    """[lr, c1, c2, 0] as float32 on `device` (floats or 0-d tensors in;
    a host value is copied without waiting for the device)."""
    vals = [torch.as_tensor(s, dtype=torch.float32).reshape(())
            for s in (lr, c1, c2)]
    vals = [v.to(device, non_blocking=True) for v in vals]
    return torch.stack(vals + [torch.zeros((), device=device)])


def fused_update_buckets_plain(op, y, p, w, m, v, lr, c1, c2, *,
                               alpha: float, b1: float, b2: float,
                               eps: float, weight_decay: float):
    """The fused function with torch ops: the reconstruct program step by
    step (`_sweep.sweep_reconstruct_plain`, scaled by alpha/sqrt(k)), then
    the epilogue. Returns (resid, w_new, m_new, v_new)."""
    from ._sweep import sweep_reconstruct_plain
    family, cores = _operator(op)
    plan = plan_fused_update(family, op.k, y.shape[0], op.in_dims, op.rank)
    g = sweep_reconstruct_plain(y, *cores, steps=plan.steps,
                                scale=float(alpha) / math.sqrt(op.k))
    return update_epilogue(g, p, w, m, v, lr, c1, c2, b1=b1, b2=b2, eps=eps,
                           weight_decay=weight_decay)


def update_epilogue(g, p, w, m, v, lr, c1, c2, *, b1: float, b2: float,
                    eps: float, weight_decay: float):
    """K4's epilogue on the reconstruction g and the dense operands at the
    same elements: (resid, w_new, m_new, v_new)."""
    m32 = b1 * m + (1.0 - b1) * g
    v32 = b2 * v + (1.0 - b2) * g * g
    step = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
    return (p - g, w - lr * (step + weight_decay * w), m32, v32)


def _check(plan: ContractionPlan, y, dense) -> None:
    want = (plan.b,) + plan.dims
    if tuple(y.shape) != (plan.b, plan.k):
        raise ValueError(f"fused_update sketch has shape {tuple(y.shape)}, "
                         f"expected {(plan.b, plan.k)}")
    for t in (y,) + tuple(dense):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_update takes float32, got {t.dtype}")
        if t.device != y.device:
            raise ValueError(f"operands on {t.device} and {y.device}")
        if not t.is_contiguous():
            raise ValueError("fused_update takes contiguous operands")
    for t in dense:
        if tuple(t.shape) != want:
            raise ValueError(f"fused_update bucket operand has shape "
                             f"{tuple(t.shape)}, expected {want}")


def fused_update_buckets(op, y, p, w, m, v, lr, c1, c2, *, alpha: float,
                         b1: float, b2: float, eps: float,
                         weight_decay: float):
    """ONE launch: unsketch + error feedback + AdamW for one leaf's buckets.

    op     : a TT/CP operator at a kernel-supported order (the one the
             sketch was drawn with).
    y      : (nb, k) sketch rows of this leaf.
    p      : (nb, *dims) error-fed gradient buckets (g + e), float32.
    w/m/v  : (nb, *dims) param / first-moment / second-moment buckets, f32.
    lr/c1/c2: learning rate and the AdamW bias corrections 1-b1^t / 1-b2^t
             (floats or 0-d tensors; they change every step).
    alpha  : MMSE shrinkage (`SketchConfig.shrinkage()`), fused with the
             JLT 1/sqrt(k) into the kernel's scale.

    Returns (resid, w_new, m_new, v_new), each (nb, *dims) float32. CPU
    tensors take the plain version; CUDA tensors launch K4 (counted in
    `fused_update_buckets.launches`) or raise.
    """
    family, cores = _operator(op)
    nb = y.shape[0]
    plan = plan_fused_update(family, op.k, nb, op.in_dims, op.rank)
    dense = (p, w, m, v)
    _check(plan, y, dense)
    hp = dict(alpha=alpha, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if y.device.type == "cpu":
        return fused_update_buckets_plain(op, y, p, w, m, v, lr, c1, c2,
                                          **hp)
    if y.device.type != "cuda":
        raise ValueError(f"fused_update_buckets runs on CUDA tensors (its "
                         f"plain version on CPU tensors), got a "
                         f"{y.device.type} tensor")
    if any(c.device != y.device or c.dtype != torch.float32 for c in cores):
        raise ValueError("fused_update_buckets needs the operator's float32 "
                         f"cores on {y.device}")
    if plan.rank > MAX_RANK:
        raise ValueError(f"fused_update holds bond ranks up to {MAX_RANK} "
                         f"per thread, got rank {plan.rank}")
    from ._sweep import _launch_reconstruct
    scal = _scalars(lr, c1, c2, y.device)
    outs = tuple(torch.empty_like(p) for _ in range(4))
    _launch_reconstruct(
        "fused_update", (y.data_ptr(), scal.data_ptr(),
                         *(t.data_ptr() for t in dense + outs)),
        cores, plan, (float(alpha) / math.sqrt(op.k), float(b1),
                      float(1.0 - b1), float(b2), float(1.0 - b2),
                      float(eps), float(weight_decay)))
    fused_update_buckets.launches += 1
    return outs


fused_update_buckets.launches = 0


def reset_launch_counts() -> None:
    """Set K4's launch counter to 0."""
    fused_update_buckets.launches = 0


__all__ = ["fused_hbm_bytes", "fused_update_buckets",
           "fused_update_buckets_plain", "plan_fused_update",
           "reset_launch_counts", "unfused_hbm_bytes", "update_epilogue"]
