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

`fused_update_block` is K4's block form, for a rank of a data mesh
(`launch/fsdp.py`) that holds its FSDP block of a leaf's params and
moments but the whole gradient and EF residual: the same reconstruction
of the whole leaf from its sketch rows, an epilogue that writes the whole
residual and w', m', v' only for the block (`BlockLayout`), read and
written at the block's own offsets. No dense bytes cross ranks. On a
(data, model) mesh a block may be split on two dims (`wq`'s dim 1 over
'data', dim 2 over 'model'); the same epilogue takes a second range.

`fused_hbm_bytes` / `unfused_hbm_bytes` give the analytic device-memory
traffic of the two formulations for the same plan.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.cp_rp import CPRP
from repro_torch.core.formats import _prod
from repro_torch.core.tt_rp import TTRP

from .ops import (MAX_ORDER, MAX_RANK, ContractionPlan, kernel_order_supported,
                  plan_contraction, sweep_hbm_bytes, tt_cores_squeezed)

# the devices whose tensors take K4's plain version: the CPU, and 'meta'
# (the dry run counts the plain program, `launch/dryrun.py`)
_PLAIN_DEVICES = ("cpu", "meta")


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
    return (p - g,) + adamw_epilogue(g, w, m, v, lr, c1, c2, b1=b1, b2=b2,
                                     eps=eps, weight_decay=weight_decay)


def adamw_epilogue(g, w, m, v, lr, c1, c2, *, b1: float, b2: float,
                   eps: float, weight_decay: float):
    """The AdamW part of K4's epilogue: (w_new, m_new, v_new)."""
    m32 = b1 * m + (1.0 - b1) * g
    v32 = b2 * v + (1.0 - b2) * g * g
    step = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
    return (w - lr * (step + weight_decay * w), m32, v32)


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """A rank's block of a leaf of `size` elements for K4's block form: the
    leaf read as (outer, n_d, inner) around its split dim a, the rank
    holding indices [lo, hi) of that dim. On a (data, model) mesh a leaf
    may be split on a second dim b > a too: `inner` then reads as (mid,
    n_b, inner_b) and the rank holds [lo_b, hi_b) of dim b, its block
    (outer, hi - lo, mid, hi_b - lo_b, inner_b) contiguous. A one-dim block
    is the case n_b = inner_b = 1, lo_b = 0, hi_b = 1; an unsplit leaf lo =
    0, hi = n_d as well."""

    size: int
    n_d: int
    inner: int
    lo: int
    hi: int
    n_b: int = 1
    inner_b: int = 1
    lo_b: int = 0
    hi_b: int = 1

    def __post_init__(self):
        if (self.size < 1 or self.n_d < 1 or self.inner < 1
                or self.size % (self.n_d * self.inner)
                or not 0 <= self.lo < self.hi <= self.n_d
                or self.n_b < 1 or self.inner_b < 1
                or self.inner % (self.n_b * self.inner_b)
                or not 0 <= self.lo_b < self.hi_b <= self.n_b):
            raise ValueError(f"not a block of a leaf: {self}")

    @classmethod
    def of(cls, shape, dim: int | None = None, lo: int = 0,
           hi: int | None = None, dim_b: int | None = None, lo_b: int = 0,
           hi_b: int | None = None) -> "BlockLayout":
        """The block [lo, hi) along `dim` (and [lo_b, hi_b) along `dim_b`
        > dim) of a leaf of `shape` (dim None: the whole leaf)."""
        shape = tuple(int(s) for s in shape)
        size = _prod(shape)
        if dim is None:
            return cls(size, size, 1, 0, size)
        hi = shape[dim] if hi is None else hi
        if dim_b is None:
            return cls(size, shape[dim], _prod(shape[dim + 1:]), lo, hi)
        if dim_b <= dim:
            raise ValueError(f"the second split dim {dim_b} must follow the "
                             f"first, {dim}")
        hi_b = shape[dim_b] if hi_b is None else hi_b
        return cls(size, shape[dim], _prod(shape[dim + 1:]), lo, hi,
                   shape[dim_b], _prod(shape[dim_b + 1:]), lo_b, hi_b)

    @property
    def two_dim(self) -> bool:
        return (self.n_b, self.inner_b, self.lo_b, self.hi_b) != (1, 1, 0, 1)

    @property
    def outer(self) -> int:
        return self.size // (self.n_d * self.inner)

    @property
    def mid(self) -> int:
        return self.inner // (self.n_b * self.inner_b)

    @property
    def shape(self) -> tuple[int, ...]:
        """The block as (outer, hi - lo, inner), or (outer, hi - lo, mid,
        hi_b - lo_b, inner_b) when it is split on two dims."""
        if not self.two_dim:
            return (self.outer, self.hi - self.lo, self.inner)
        return self.view_shape

    @property
    def view_shape(self) -> tuple[int, int, int, int, int]:
        """The block as (outer, hi - lo, mid, hi_b - lo_b, inner_b)."""
        return (self.outer, self.hi - self.lo, self.mid, self.hi_b - self.lo_b,
                self.inner_b)

    @property
    def numel(self) -> int:
        return _prod(self.view_shape)

    def tail(self) -> tuple[int, ...]:
        """The C entry's trailing arguments: (size, n_d, inner, lo, hi),
        then (n_b, inner_b, lo_b, hi_b) for a two-dim block."""
        head = (self.size, self.n_d, self.inner, self.lo, self.hi)
        return head + ((self.n_b, self.inner_b, self.lo_b, self.hi_b)
                       if self.two_dim else ())

    def block_of(self, g: torch.Tensor) -> torch.Tensor:
        """The block's elements of a flat whole leaf `g` (a view, in
        `view_shape`)."""
        return g.view(self.outer, self.n_d, self.mid, self.n_b,
                      self.inner_b)[:, self.lo:self.hi, :,
                                    self.lo_b:self.hi_b]


def _check_block(plan: ContractionPlan, layout: BlockLayout, y, p,
                 blocks) -> None:
    """Raise on what K4's block form does not take."""
    if tuple(y.shape) != (plan.b, plan.k):
        raise ValueError(f"fused_update sketch has shape {tuple(y.shape)}, "
                         f"expected {(plan.b, plan.k)}")
    bucket = _prod(plan.dims)
    if not (plan.b - 1) * bucket < layout.size <= plan.b * bucket:
        raise ValueError(f"a leaf of {layout.size} elements does not fill "
                         f"{plan.b} buckets of {bucket}")
    for t in (y, p) + tuple(blocks):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_update takes float32, got {t.dtype}")
        if t.device != y.device:
            raise ValueError(f"operands on {t.device} and {y.device}")
        if not t.is_contiguous():
            raise ValueError("fused_update takes contiguous operands")
    if p.numel() != layout.size:
        raise ValueError(f"fused_update_block's gradient has {p.numel()} "
                         f"elements, the leaf {layout.size}")
    for t in blocks:
        if t.shape != blocks[0].shape or t.numel() != layout.numel:
            raise ValueError(
                f"fused_update_block's block operands have shapes "
                f"{[tuple(b.shape) for b in blocks]}, the block "
                f"{layout.shape} {layout.numel} elements")


def fused_update_block_plain(op, y, p, w, m, v, lr, c1, c2, *,
                             layout: BlockLayout, alpha: float, b1: float,
                             b2: float, eps: float, weight_decay: float):
    """K4's block form with torch ops: the whole leaf's reconstruction as
    `fused_update_buckets_plain` makes it, the residual of the whole leaf,
    and the AdamW epilogue on the block's elements of it. Returns (resid
    in p's shape, w_new, m_new, v_new in w's shape)."""
    from ._sweep import sweep_reconstruct_plain
    family, cores = _operator(op)
    plan = plan_fused_update(family, op.k, y.shape[0], op.in_dims, op.rank)
    g = sweep_reconstruct_plain(y, *cores, steps=plan.steps,
                                scale=float(alpha) / math.sqrt(op.k))
    g = g.reshape(-1)[:layout.size]
    resid = (p.reshape(-1) - g).view(p.shape)
    outs = adamw_epilogue(layout.block_of(g),
                          *(t.view(layout.view_shape) for t in (w, m, v)),
                          lr, c1, c2, b1=b1, b2=b2, eps=eps,
                          weight_decay=weight_decay)
    return (resid,) + tuple(o.reshape(w.shape) for o in outs)


def block_epilogue(layout: BlockLayout, plan: ContractionPlan, p, w, m, v,
                   lr, c1, c2, *, b1: float, b2: float, eps: float,
                   weight_decay: float):
    """K4's block epilogue for `_sweep.sweep_reconstruct_tiled_plain`:
    (epilogue, outputs). The epilogue takes a finished tile and its index
    into the (B, d1, T) view of the leaf's buckets and does what the
    kernel's does at each element's flat offset `off = (n*d1 + a)*T + t`:
    below `layout.size` it writes resid[off], and where the element's
    indices on the split dims lie in [lo, hi) and [lo_b, hi_b) the AdamW
    outputs at the block's offset. The outputs (the flat residual, and the block's w',
    m', v' flat) start as NaN, so an element no tile wrote shows."""
    d1, trail = plan.dims[0], plan.trail
    span = layout.n_d * layout.inner
    span_b = layout.n_b * layout.inner_b
    pf = p.reshape(-1)
    wf, mf, vf = (t.reshape(-1) for t in (w, m, v))
    outs = (torch.full_like(pf, float("nan")),) + tuple(
        torch.full_like(wf, float("nan")) for _ in range(3))

    def epilogue(index, g):
        n_i, a_i, t_i = (torch.arange(s.start, s.stop) for s in index)
        off = ((n_i[:, None, None] * d1 + a_i[None, :, None]) * trail
               + t_i[None, None, :])
        inside = off < layout.size
        o, g1 = off[inside], g[inside]
        outs[0][o] = pf[o] - g1
        r = o % span
        j = r // layout.inner
        r1 = r - j * layout.inner
        mi, r2 = r1 // span_b, r1 % span_b
        jb = r2 // layout.inner_b
        mine = ((j >= layout.lo) & (j < layout.hi) & (jb >= layout.lo_b)
                & (jb < layout.hi_b))
        b = (((((o // span) * (layout.hi - layout.lo) + j - layout.lo)
               * layout.mid + mi) * (layout.hi_b - layout.lo_b) + jb
              - layout.lo_b) * layout.inner_b + r2
             - jb * layout.inner_b)[mine]
        vals = adamw_epilogue(g1[mine], wf[b], mf[b], vf[b], lr, c1, c2,
                              b1=b1, b2=b2, eps=eps,
                              weight_decay=weight_decay)
        for out, val in zip(outs[1:], vals):
            out[b] = val

    return epilogue, outs


def fused_update_block_tiled_plain(op, y, p, w, m, v, lr, c1, c2, *,
                                   layout: BlockLayout, alpha: float,
                                   b1: float, b2: float, eps: float,
                                   weight_decay: float):
    """K4's block form on K2's tile schedule
    (`_sweep.sweep_reconstruct_tiled_plain` with `block_epilogue`): a
    check of the kernel's index arithmetic on the CPU; no path runs it.
    Returns what `fused_update_block` returns."""
    from ._sweep import sweep_reconstruct_tiled_plain
    family, cores = _operator(op)
    plan = plan_fused_update(family, op.k, y.shape[0], op.in_dims, op.rank)
    epilogue, outs = block_epilogue(layout, plan, p, w, m, v, lr, c1, c2,
                                    b1=b1, b2=b2, eps=eps,
                                    weight_decay=weight_decay)
    sweep_reconstruct_tiled_plain(y, *cores, plan=plan,
                                  scale=float(alpha) / math.sqrt(op.k),
                                  epilogue=epilogue)
    return (outs[0].view(p.shape),) + tuple(o.view(w.shape)
                                            for o in outs[1:])


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


def _launch(entry: str, op, cores, plan: ContractionPlan, y, dense, outs,
            lr, c1, c2, hp: dict, tail: tuple = ()) -> None:
    """One launch of K4's C `entry` on CUDA tensors, or its refusal."""
    if y.device.type != "cuda":
        raise ValueError(f"{entry} runs on CUDA tensors (its plain version "
                         f"on CPU tensors), got a {y.device.type} tensor")
    if any(c.device != y.device or c.dtype != torch.float32 for c in cores):
        raise ValueError(f"{entry} needs the operator's float32 cores on "
                         f"{y.device}")
    if plan.rank > MAX_RANK:
        raise ValueError(f"fused_update holds bond ranks up to {MAX_RANK} "
                         f"per thread, got rank {plan.rank}")
    from ._sweep import _launch_reconstruct
    scal = _scalars(lr, c1, c2, y.device)
    b1, b2 = hp["b1"], hp["b2"]
    _launch_reconstruct(
        entry, (y.data_ptr(), scal.data_ptr(),
                *(t.data_ptr() for t in tuple(dense) + tuple(outs))),
        cores, plan, (float(hp["alpha"]) / math.sqrt(op.k), float(b1),
                      float(1.0 - b1), float(b2), float(1.0 - b2),
                      float(hp["eps"]), float(hp["weight_decay"])) + tail)


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
    and meta tensors take the plain version; CUDA tensors launch K4
    (counted in `fused_update_buckets.launches`) or raise.
    """
    family, cores = _operator(op)
    nb = y.shape[0]
    plan = plan_fused_update(family, op.k, nb, op.in_dims, op.rank)
    dense = (p, w, m, v)
    _check(plan, y, dense)
    hp = dict(alpha=alpha, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if y.device.type in _PLAIN_DEVICES:
        return fused_update_buckets_plain(op, y, p, w, m, v, lr, c1, c2,
                                          **hp)
    outs = tuple(torch.empty_like(p) for _ in range(4))
    _launch("fused_update", op, cores, plan, y, dense, outs, lr, c1, c2, hp)
    fused_update_buckets.launches += 1
    return outs


fused_update_buckets.launches = 0


def fused_update_block(op, y, p, w, m, v, lr, c1, c2, *,
                       layout: BlockLayout, alpha: float, b1: float,
                       b2: float, eps: float, weight_decay: float):
    """ONE launch of K4's block form for one leaf on a rank of a data mesh.

    y      : (nb, k) sketch rows of the leaf (all of its buckets).
    p      : the whole error-fed gradient leaf (g + e), `layout.size`
             float32 elements in any shape, not bucketized.
    w/m/v  : the rank's blocks of the param and moments (`layout`),
             float32, any one shape of `layout.numel` elements.
    The rest as `fused_update_buckets`.

    Returns (resid in p's shape, whole; w_new, m_new, v_new in w's shape,
    the block). CPU and meta tensors take the plain version; CUDA
    tensors launch the kernel or raise. A block split on two dims (a rank
    of a (data, model) mesh) launches the entry `fused_update_block2`, counted in
    `fused_update_block.launches_2d`; the others `fused_update_block`,
    counted in `fused_update_block.launches`.
    """
    family, cores = _operator(op)
    nb = y.shape[0]
    plan = plan_fused_update(family, op.k, nb, op.in_dims, op.rank)
    _check_block(plan, layout, y, p, (w, m, v))
    hp = dict(alpha=alpha, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if y.device.type in _PLAIN_DEVICES:
        return fused_update_block_plain(op, y, p, w, m, v, lr, c1, c2,
                                        layout=layout, **hp)
    outs = (torch.empty_like(p),) + tuple(torch.empty_like(w)
                                          for _ in range(3))
    entry = "fused_update_block2" if layout.two_dim else "fused_update_block"
    _launch(entry, op, cores, plan, y, (p, w, m, v), outs, lr, c1, c2, hp,
            layout.tail())
    if layout.two_dim:
        fused_update_block.launches_2d += 1
    else:
        fused_update_block.launches += 1
    return outs


fused_update_block.launches = 0     # the one-dim (and whole) block entry
fused_update_block.launches_2d = 0  # the two-dim block entry


def reset_launch_counts() -> None:
    """Set K4's launch counters (whole-leaf and both block forms) to 0."""
    fused_update_buckets.launches = 0
    fused_update_block.launches = 0
    fused_update_block.launches_2d = 0


__all__ = ["BlockLayout", "adamw_epilogue", "block_epilogue",
           "fused_hbm_bytes", "fused_update_block",
           "fused_update_block_plain", "fused_update_block_tiled_plain",
           "fused_update_buckets", "fused_update_buckets_plain",
           "plan_fused_update", "reset_launch_counts", "unfused_hbm_bytes",
           "update_epilogue"]
