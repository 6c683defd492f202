"""Carry-sweep planner for structured (TT/CP-format) inputs.

Port of `repro/kernels/struct/plan.py`. Instead of streaming a dense
`(B, d1..dN)` block, the carry sweep contracts one mode of the OPERATOR
against the same mode of the INPUT's compressed representation, carrying a
small `(R_op, R_in)` bond state per (item, k-row) between modes. All four
pairings share one program shape — a tuple of two-operand einsum steps
`(dst, spec, src_a, src_b)` emitted by `_carry_program`, the reference's
strings verbatim (the CPU tests diff them):

  op   input  per-mode carry update                       carry axes
  tt x tt     c,g -> t;  t,x -> c                          (b, k, R, R~)
  tt x cp     c,g -> t;  t,a -> c                          (b, k, R, R~)
  cp x tt     c,x -> t;  t,f -> c                          (b, k, R, R~)
  cp x cp     f,a -> t;  c * t (Hadamard on the bond)      (b, k, R, R~)

`plan_carry_sweep` picks the CUDA tiles, budgeted against one block's
shared memory (the TPU's 8 MiB VMEM budget and 128-lane k tile do not carry
over). A block runs one warp per (item, k-row) pair, tk k-rows x tb items:

* serial (K3, grid (B/tb, k/tk)): the block stages mode by mode its
  items' input core n; its warps read their k-rows of the operator cores
  through the caches (staging them per mode was slower on an H100 at
  every serving shape). Shared memory holds the largest input mode and
  every warp's carry region.
* double (K6, grid (k/tk,)): the k-tile's operator cores stay resident for
  every mode, and the input cores of a batch tile (all modes) have two
  slots, the next tile streaming in while the current one runs. A shape
  whose operator cores do not fit even at tk = tb = 1 (a large interior
  TT core) is refused; K3 runs it.

A warp's carry region holds the carry and its successor (R_op * R_in
floats each) and, for tt x tt only, one d-slice of the temp (R_in * R_op):
the kernels fuse each mode's two steps over d, so the mode axis the
program's temp keeps (bkedv, bkrdf) is never formed.
"""
from __future__ import annotations

import dataclasses
import math

from ..ops import H100_SMS, MAX_ORDER, SMEM_BUDGET_BYTES, validate_pipeline

_FAMILIES = ("tt", "cp")
# Warps per block the planner aims for: serial (K3) and double (K6).
K3_WARPS = 16
K6_WARPS = 16


def _require_family(name: str, value: str) -> None:
    if value not in _FAMILIES:
        raise ValueError(f"unknown {name} {value!r}; expected {_FAMILIES}")


def _carry_program(op_family: str, in_family: str, order: int) -> tuple:
    """The einsum carry program for one (operator, input) family pairing.

    Step letters are local to each spec: b batch, k sketch row, d the mode
    being contracted, u/v the operator TT bond (in/out), e/f the input TT
    bond (in/out), r the operator CP component, p the input CP component.
    Operator operands use the squeezed kernel layouts
    (`ops.tt_cores_squeezed` / `op.factors`); input operands the squeezed
    batched layouts (TT: (B, d1, R~), (B, R~, d, R~), (B, R~, dN); CP:
    (B, d, R~) with weights folded into factor 0).
    """
    _require_family("operator family", op_family)
    _require_family("input family", in_family)
    if not 2 <= order <= MAX_ORDER:
        raise ValueError(
            f"carry-sweep kernels need 2 <= order <= {MAX_ORDER}, "
            f"got {order}")
    steps: list[tuple] = []
    last = order - 1
    if op_family == "tt" and in_family == "tt":
        steps.append(("c", "kdu,bde->bkue", "g0", "x0"))
        for n in range(1, last):
            steps.append(("t", "bkue,kudv->bkedv", "c", f"g{n}"))
            steps.append(("c", "bkedv,bedf->bkvf", "t", f"x{n}"))
        steps.append(("t", "bkue,kud->bked", "c", f"g{last}"))
        steps.append(("c", "bked,bed->bk", "t", f"x{last}"))
    elif op_family == "tt" and in_family == "cp":
        steps.append(("c", "kdu,bdp->bkup", "g0", "x0"))
        for n in range(1, last):
            steps.append(("t", "bkup,kudv->bkpdv", "c", f"g{n}"))
            steps.append(("c", "bkpdv,bdp->bkvp", "t", f"x{n}"))
        steps.append(("t", "bkup,kud->bkpd", "c", f"g{last}"))
        steps.append(("c", "bkpd,bdp->bk", "t", f"x{last}"))
    elif op_family == "cp" and in_family == "tt":
        steps.append(("c", "kdr,bde->bkre", "g0", "x0"))
        for n in range(1, last):
            steps.append(("t", "bkre,bedf->bkrdf", "c", f"x{n}"))
            steps.append(("c", "bkrdf,kdr->bkrf", "t", f"g{n}"))
        steps.append(("t", "bkre,bed->bkrd", "c", f"x{last}"))
        steps.append(("c", "bkrd,kdr->bk", "t", f"g{last}"))
    else:  # cp x cp: per-mode Hadamard on the (r, p) bond
        steps.append(("c", "kdr,bdp->bkrp", "g0", "x0"))
        for n in range(1, last):
            steps.append(("t", "kdr,bdp->bkrp", f"g{n}", f"x{n}"))
            steps.append(("c", "bkrp,bkrp->bkrp", "c", "t"))
        steps.append(("t", "kdr,bdp->bkrp", f"g{last}", f"x{last}"))
        steps.append(("c", "bkrp,bkrp->bk", "c", "t"))
    return tuple(steps)


@dataclasses.dataclass(frozen=True)
class CarryPlan:
    """A fully-resolved carry-sweep schedule for one structured launch.

    `program` is the einsum step tuple the kernels execute (lowered by
    `carry.carry_codes`); `smem_bytes` the shared memory one block takes at
    the chosen `(tk, tb)` tiles, which the launch allocates as is.
    """

    op_family: str
    in_family: str
    k: int
    b: int
    dims: tuple[int, ...]
    r_op: int
    r_in: int
    tk: int
    tb: int
    program: tuple
    smem_bytes: int
    pipeline: str = "serial"

    @property
    def order(self) -> int:
        return len(self.dims)

    @property
    def warps(self) -> int:
        """Warps per block: one per (item, k-row) pair of the tile."""
        return self.tk * self.tb

    @property
    def grid(self) -> tuple[int, ...]:
        """CUDA grid: (batch tiles, k tiles) for K3; (k tiles,) for K6,
        whose blocks loop over the batch tiles themselves."""
        nk = -(-self.k // self.tk)
        if self.pipeline == "double":
            return (nk,)
        return (-(-self.b // self.tb), nk)

    @property
    def carry_bytes(self) -> int:
        """Bytes of the carried bond state for the FULL problem —
        b * k * R_op * R_in floats, the `(B, k, R_op·R_in)` carry that
        replaces the dense path's (B, k, d2..dN) sweep intermediates."""
        return 4 * self.b * self.k * self.r_op * self.r_in


def _mode_elems(family: str, dims: tuple[int, ...], rank: int) -> list[int]:
    """Per-row (k or batch) element count of each squeezed core/factor."""
    if family == "cp":
        return [d * rank for d in dims]
    n = len(dims)
    return [(1 if i == 0 else rank) * d * (1 if i == n - 1 else rank)
            for i, d in enumerate(dims)]


def _core_elems(family: str, dims: tuple[int, ...], rank: int) -> int:
    """Per-row element count of a whole squeezed core/factor list."""
    if family == "tt" and len(dims) == 1:
        return dims[0]
    return sum(_mode_elems(family, dims, rank))


def _up4(n: int) -> int:
    return -(-n // 4) * 4


def carry_smem_bytes(op_family: str, in_family: str, dims: tuple[int, ...],
                     r_op: int, r_in: int, tk: int, tb: int,
                     pipeline: str = "serial") -> int:
    """Dynamic shared memory of one K3/K6 block (csrc/carry_sweep.cu),
    each region 16-byte aligned.

    serial (K3): tb items of the largest input mode and tk*tb warp carry
    regions.
    double (K6): tk rows of every operator mode, two slots of tb items of
    every input mode, and the warp carry regions.
    A warp's region: carry + successor (r_op*r_in each) and, for tt x tt,
    one d-slice of the temp (r_in*r_op).
    """
    op_modes = _mode_elems(op_family, dims, r_op)
    in_modes = _mode_elems(in_family, dims, r_in)
    cm = r_op * r_in
    warp = 2 * cm + (cm if (op_family, in_family) == ("tt", "tt") else 0)
    carries = _up4(tk * tb * warp)
    if pipeline == "double":
        return 4 * (_up4(tk * sum(op_modes)) + 2 * _up4(tb * sum(in_modes))
                     + carries)
    return 4 * (_up4(tb * max(in_modes)) + carries)


def plan_carry_sweep(op_family: str, in_family: str, k: int, b: int,
                     dims: tuple[int, ...], r_op: int, r_in: int, *,
                     budget: int = SMEM_BUDGET_BYTES,
                     pipeline: str = "serial") -> CarryPlan:
    """Plan a carry-sweep kernel launch for order N = len(dims).

    serial (K3): K3_WARPS k-rows of one item a block (on an H100 the
    fastest of the splits of 8 or 16 warps tried).
    double (K6): the grid is k tiles only, so tk is the largest power of
    two <= 8 that still gives a block per SM (132 blocks at k=512 need
    tk <= 2; with fewer k-rows than that, tk = 1); tb fills the block up
    to K6_WARPS warps (no more items than the batch holds).
    Then tb, and after it tk, halve until two blocks fit one SM's shared
    memory, or at least one fits `budget`; what still does not fit raises.
    """
    dims = tuple(int(d) for d in dims)
    program = _carry_program(op_family, in_family, len(dims))  # validates
    validate_pipeline(pipeline)
    r_op, r_in = max(1, int(r_op)), max(1, int(r_in))
    k, b = int(k), max(1, int(b))
    if pipeline == "double":
        tk = 8
        while tk > 1 and -(-k // tk) < H100_SMS:
            tk //= 2
        tb = min(K6_WARPS // tk, 1 << (b - 1).bit_length())
    else:
        tk, tb = K3_WARPS, 1

    def smem() -> int:
        return carry_smem_bytes(op_family, in_family, dims, r_op, r_in, tk,
                                tb, pipeline)

    for limit in (budget // 2, budget):
        while smem() > limit and (tb > 1 or tk > 1):
            if tb > 1:
                tb //= 2
            else:
                tk //= 2
    nbytes = smem()
    if nbytes > budget:
        held = ("its operator cores, " if pipeline == "double" else "")
        raise ValueError(
            f"plan_carry_sweep: {op_family} x {in_family} dims={dims}, "
            f"r_op={r_op}, r_in={r_in}, pipeline={pipeline!r} need {nbytes} "
            f"bytes of shared memory for one (item, k-row) pair ({held}"
            f"input cores and carry), over the {budget}-byte block budget")
    return CarryPlan(op_family=op_family, in_family=in_family, k=k, b=b,
                     dims=dims, r_op=r_op, r_in=r_in, tk=tk, tb=tb,
                     program=program, smem_bytes=nbytes, pipeline=pipeline)


def struct_hbm_bytes(plan: CarryPlan) -> int:
    """Analytic device-memory traffic of one carry-sweep launch, following
    the kernels' schedules: every block reads its k-rows of the operator
    cores and its items' input cores once, so under K3's (k, batch) grid
    the operator is read once per batch tile and the inputs once per k
    tile; under K6's (k,) grid the operator once and the inputs once per
    k tile. Each output is written once."""
    nk = -(-plan.k // plan.tk)
    nb = 1 if plan.pipeline == "double" else -(-plan.b // plan.tb)
    op_bytes = 4 * plan.k * _core_elems(plan.op_family, plan.dims, plan.r_op)
    in_bytes = 4 * plan.b * _core_elems(plan.in_family, plan.dims, plan.r_in)
    return nb * op_bytes + nk * in_bytes + 4 * plan.b * plan.k


def carry_program_flops(program, op_shapes, in_shapes) -> int:
    """Flops of a carry program on operands of the given shapes (operator
    cores, then input cores, in the squeezed layouts, so the boundary bonds
    and every per-bond input rank count as they are): each einsum step
    costs 2 * prod(index sizes) when it sums an index out, and
    prod(index sizes) when it sums none (cp x cp's Hadamard step)."""
    shapes: dict[str, tuple[int, ...]] = {}

    def shape(name):
        if name in shapes:                    # 'c' or 't'
            return shapes[name]
        return tuple((op_shapes if name[0] == "g" else in_shapes)[
            int(name[1:])])

    total = 0
    for dst, spec, a, b in program:
        ins, out = spec.split("->")
        size: dict[str, int] = {}
        for letters, dims in zip(ins.split(","), (shape(a), shape(b))):
            if len(letters) != len(dims):
                raise ValueError(f"operand {letters} of {spec!r} has shape "
                                 f"{dims}")
            for ch, n in zip(letters, dims):
                if size.setdefault(ch, n) != n:
                    raise ValueError(f"index {ch} of {spec!r} is "
                                     f"{size[ch]} and {n}")
        work = math.prod(size.values())
        total += 2 * work if set(size) - set(out) else work
        shapes[dst] = tuple(size[ch] for ch in out)
    return total


__all__ = ["CarryPlan", "carry_program_flops", "carry_smem_bytes",
           "plan_carry_sweep", "struct_hbm_bytes"]
