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

`plan_carry_sweep` picks the CUDA schedule, budgeted against one block's
shared memory and one thread's registers (the TPU's 8 MiB VMEM budget and
128-lane k tile do not carry over). A block owns tk k-rows x tb items:

* a pair's carry is cut into nv x nf register tiles of ro operator-bond
  rows x ri input-bond columns (`CARRY_TILES`, the list
  csrc/carry_sweep.cu compiles), nv = ceil(R / ro), nf = ceil(R~ / ri).
  It sits in shared memory between modes; a thread loads the carry tiles
  it contracts into registers once per chunk of d and accumulates one
  output tile there. A bond of any size is more tiles: the pair's tps
  tile threads own the output tiles tps apart (one each where tps =
  nv * nf; past CARRY_THREADS a thread walks several, its partials kept
  in shared memory between chunks).
* tpd threads split each mode's d range; their partial tiles meet in
  shared memory at the end of the mode, summed in a fixed order, as do
  the partial outputs of the last mode.
* serial (K3, grid (B/tb, k/tk)): mode by mode, chunk by chunk of dc
  values of d, the block stages its k-rows of operator core n and its
  items' input core n into one of two slots (16-byte `cp.async` where a
  row allows it) while the other slot's chunk computes.
* double (K6, grid (k/tk,)): the k-tile's operator cores stay resident
  for every mode, and the input cores of a batch tile (all modes) have
  two slots, the next tile streaming in while the current one runs. A
  shape whose operator cores do not fit even at tk = tb = 1 (a large
  interior TT core) is refused; K3 runs it.

Each mode's two einsum steps are fused over d, so the mode axis the
program's temp keeps (bkedv, bkrdf) is never formed. Carry entries past
the true bonds are held at zero, so a thread may read a core's columns
past its bonds (into the padded row stride, `row_extent`; rows are
clamped) without a guard.
"""
from __future__ import annotations

import dataclasses
import functools
import math

from ..ops import H100_SMS, MAX_ORDER, SMEM_BUDGET_BYTES, validate_pipeline

_FAMILIES = ("tt", "cp")
# Register tiles (ro, ri) the kernels are compiled for
# (csrc/carry_sweep.cu's CARRY_TILES holds the same list): ro operator-bond
# rows x ri input-bond columns of the carry. (5, 4) holds the serving
# shapes' carry whole (TT(5) x rank 4) or a fifth of it (CP(25)); (8, 8)
# takes larger bonds in fewer tiles.
CARRY_TILES = ((5, 4), (8, 8))
CARRY_THREADS = 256        # most threads a block (the kernels' launch bound)
CARRY_TARGET_THREADS = 32_768   # threads a launch aims for: 8 warps an SM
MAX_TPD = 8                # most threads splitting one pair's d range
DC_CHOICES = (64, 32, 16, 8, 4, 2, 1)  # K3's d chunks, deepest first


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
    `carry.carry_codes`); `smem_bytes` the shared memory one block takes,
    which the launch allocates as is. A block owns `tk` k-rows x `tb`
    items; each pair's carry is `n_tiles` register tiles `(ro, ri)`, run by
    `tps` tile threads x `tpd` d-parts; K3 stages `dc` values of d a chunk,
    and of an interior TT operator core `uc` bond rows a chunk (a multiple
    of ro; every row unless one value of d outgrows the block).
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
    ro: int = 5
    ri: int = 4
    tps: int = 1
    tpd: int = 1
    dc: int = 4
    uc: int = 5

    @property
    def order(self) -> int:
        return len(self.dims)

    @property
    def nv(self) -> int:
        """Register tiles along the operator bond."""
        return -(-self.r_op // self.ro)

    @property
    def nf(self) -> int:
        """Register tiles along the input bond."""
        return -(-self.r_in // self.ri)

    @property
    def n_tiles(self) -> int:
        """Register tiles of one pair's carry."""
        return self.nv * self.nf

    @property
    def single(self) -> bool:
        """Each tile thread owns one output tile (else several, their
        partials kept in shared memory between chunks of d)."""
        return self.tps == self.n_tiles

    @property
    def tpp(self) -> int:
        """Threads per (item, k-row) pair."""
        return self.tps * self.tpd

    @property
    def threads(self) -> int:
        """Threads per block."""
        return self.tk * self.tb * self.tpp

    @property
    def warps(self) -> int:
        """Warps per block (the last one may be partial)."""
        return -(-self.threads // 32)

    @property
    def carry_stride(self) -> int:
        """Floats between two pairs' carries in shared memory: the padded
        (nv*ro, nf*ri) carry, odd so that a warp's pairs hit 32 banks."""
        return self.n_tiles * self.ro * self.ri | 1

    @property
    def xbuf_floats(self) -> int:
        """Floats of one pair's exchange buffer, where its partial tiles
        meet: a tile's ro*ri floats (odd stride) for every tile and
        d-part, where a pair has more than one d-part or a thread more
        than one tile; else 0."""
        if self.single and self.tpd == 1:
            return 0
        return self.n_tiles * self.tpd * (self.ro * self.ri | 1)

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


def row_extent(a: int, length: int, c: int, cr: int) -> int:
    """Floats one staged row of a core chunk [a][length][c] spans when it
    is read at columns < cr (the register tile's bound, which may pass the
    bond c; rows are clamped to the bond a)."""
    return a * length * c + max(0, cr - c)


def row_stride(extent: int) -> int:
    """Distance between two staged rows: a multiple of 4 floats (16-byte
    copies), moved off a multiple of 32 (rows in different banks)."""
    s = _up4(extent)
    return s + 4 if s % 32 == 0 else s


def u_chunked(plan: CarryPlan, n: int) -> bool:
    """Whether K3 stages mode n's operator core `uc` bond rows a chunk."""
    return plan.op_family == "tt" and 0 < n < plan.order - 1


def core_bounds(plan: CarryPlan, side: str, n: int) -> tuple[int, int, int]:
    """(a, c, cr) of mode n's operator (`side` 'op') or input ('in') core
    row: its bonds a x c around d and the columns the kernels read (the
    padded carry's)."""
    first, last = n == 0, n == plan.order - 1
    if side == "op":
        family, rank, cols = plan.op_family, plan.r_op, plan.nv * plan.ro
    else:
        family, rank, cols = plan.in_family, plan.r_in, plan.nf * plan.ri
    if family == "cp":
        return 1, rank, cols
    return 1 if first else rank, 1 if last else rank, 1 if last else cols


def stage_strides(plan: CarryPlan, length_of,
                  rows: int | None = None) -> tuple[list[int], list[int]]:
    """Row strides of every mode's operator and input rows, each mode's
    chunk `length_of(d)` values of d long and (`rows`) an interior TT
    operator core's that many bond rows."""
    ops_, ins = [], []
    for m, d in enumerate(plan.dims):
        a, c, cr = core_bounds(plan, "op", m)
        if rows is not None and u_chunked(plan, m):
            a = min(a, rows)
        ops_.append(row_stride(row_extent(a, length_of(d), c, cr)))
        a, c, cr = core_bounds(plan, "in", m)
        ins.append(row_stride(row_extent(a, length_of(d), c, cr)))
    return ops_, ins


def carry_smem_bytes(plan: CarryPlan) -> int:
    """Dynamic shared memory of one K3/K6 block (csrc/carry_sweep.cu),
    each region a multiple of 16 bytes.

    serial (K3): two slots, each tk operator rows and tb input rows of one
    chunk of dc values of d (and uc bond rows; the row strides the widest
    mode's).
    double (K6): tk operator rows of every mode (whole d), two slots of tb
    input rows of every mode.
    Both: then each pair's carry (`carry_stride`) and exchange buffer
    (`xbuf_floats`).
    """
    pairs = plan.tk * plan.tb
    held = (_up4(pairs * plan.carry_stride)
            + (_up4(pairs * plan.xbuf_floats) if plan.xbuf_floats else 0))
    if plan.pipeline == "double":
        ops_, ins = stage_strides(plan, lambda d: d)
        resident = sum(_up4(plan.tk * s) for s in ops_)
        slot = sum(_up4(plan.tb * s) for s in ins)
        return 4 * (resident + 2 * slot + held)
    ops_, ins = stage_strides(plan, lambda d: min(plan.dc, d), plan.uc)
    slot = _up4(plan.tk * max(ops_)) + _up4(plan.tb * max(ins))
    return 4 * (2 * slot + held)


def tile_work(op_family: str, in_family: str, r_op: int, r_in: int,
              tile: tuple[int, int]) -> int:
    """FMAs a pair's threads issue per value of d in an interior mode
    under the register tile (ro, ri), padding included: every output tile
    walks the carry tiles it contracts (TT x TT: all of them; TT x CP: its
    column; CP x TT: its row; CP x CP: none)."""
    ro, ri = tile
    nv, nf = -(-r_op // ro), -(-r_in // ri)
    if op_family == "tt" and in_family == "tt":
        return (nv * nf) ** 2 * ro * ri * (ro + ri)
    if op_family == "tt":
        return nv * nv * nf * ro * ri * (ro + 1)
    if in_family == "tt":
        return nv * nf * nf * ro * ri * (ri + 1)
    return nv * nf * ro * ri


def _tile(op_family: str, in_family: str, r_op: int,
          r_in: int) -> tuple[int, int]:
    """The compiled register tile with the least padded work per pair
    (`tile_work`; the first listed on a tie)."""
    return min(CARRY_TILES, key=lambda t: tile_work(op_family, in_family,
                                                      r_op, r_in, t))


def _pow2floor(n: int) -> int:
    return 1 << (max(1, int(n)).bit_length() - 1)


def plan_carry_sweep(op_family: str, in_family: str, k: int, b: int,
                     dims: tuple[int, ...], r_op: int, r_in: int, *,
                     budget: int = SMEM_BUDGET_BYTES,
                     pipeline: str = "serial") -> CarryPlan:
    """Plan a carry-sweep kernel launch for order N = len(dims) (see
    `_plan`). Plans are cached: `struct_project` plans every serve tick,
    and a plan is a pure function of its arguments."""
    validate_pipeline(pipeline)
    return _plan(op_family, in_family, int(k), max(1, int(b)),
                 tuple(int(d) for d in dims), max(1, int(r_op)),
                 max(1, int(r_in)), int(budget), pipeline)


@functools.lru_cache(maxsize=1024)
def _plan(op_family: str, in_family: str, k: int, b: int,
          dims: tuple[int, ...], r_op: int, r_in: int, budget: int,
          pipeline: str) -> CarryPlan:
    """Plan a carry-sweep kernel launch for order N = len(dims).

    * The register tile: the compiled one with the least padded work
      (`_tile`); the pair's carry is n_tiles of them, and tps = n_tiles
      tile threads own one each (at most CARRY_THREADS; past that a thread
      owns several).
    * tpd doubles (up to MAX_TPD, while each d-part keeps 2 values of the
      widest mode and the pair CARRY_THREADS threads) until the launch has
      CARRY_TARGET_THREADS threads: a B=8 serve tick at k=512 splits each
      TT(5) pair 8 ways; at B=64 a thread runs a whole pair (or tile).
    * A block holds the power of two <= CARRY_THREADS // (tps*tpd) pairs
      (32 for CP(25)'s 5 tiles: smaller blocks, more of them an SM, were
      faster on an H100 than 48 pairs). K3: tb the largest
      power of two <= sqrt(2 * pairs) (at most the batch), tk the rest;
      its chunk as `_plan_serial` picks it, tb and then tk halving where
      none fits `budget`. K6: `_plan_double`.
    * What still does not fit raises: K3 only where one value of d of a
      k-row's operator core does not fit beside the pair's carry.
    """
    program = _carry_program(op_family, in_family, len(dims))  # validates
    ro, ri = _tile(op_family, in_family, r_op, r_in)
    tps = min(-(-r_op // ro) * -(-r_in // ri), CARRY_THREADS)

    def deepen(tpd, enough):
        while (tpd < MAX_TPD and not enough(tpd) and 4 * tpd <= max(dims)
               and 2 * tps * tpd <= CARRY_THREADS):
            tpd *= 2
        return tpd

    base = CarryPlan(op_family=op_family, in_family=in_family, k=k, b=b,
                     dims=dims, r_op=r_op, r_in=r_in, tk=1, tb=1,
                     program=program, smem_bytes=0, pipeline=pipeline,
                     ro=ro, ri=ri, tps=tps, tpd=1, dc=DC_CHOICES[-1],
                     uc=-(-r_op // ro) * ro)
    if pipeline == "double":
        plan = _plan_double(base, deepen, budget)
    else:
        tpd = deepen(1, lambda t: k * b * tps * t >= CARRY_TARGET_THREADS)
        pairs = _pow2floor(CARRY_THREADS // (tps * tpd))
        tb = max(1, min(b, _pow2floor(math.isqrt(2 * pairs))))
        plan = _plan_serial(dataclasses.replace(
            base, tpd=tpd, tb=tb, tk=max(1, min(k, pairs // tb))), budget)
    if plan is None:
        nbytes = carry_smem_bytes(base)
        held = ("its operator cores, " if pipeline == "double" else "")
        raise ValueError(
            f"plan_carry_sweep: {op_family} x {in_family} dims={dims}, "
            f"r_op={r_op}, r_in={r_in}, pipeline={pipeline!r} need {nbytes} "
            f"bytes of shared memory for one (item, k-row) pair ({held}"
            f"input cores and carry), over the {budget}-byte block budget")
    return dataclasses.replace(plan, smem_bytes=carry_smem_bytes(plan))


def _plan_serial(plan: CarryPlan, budget: int) -> CarryPlan | None:
    """K3: the deepest chunk, up to 32 values a d-part (64 when tpd > 1),
    that fits the block's shared memory; tb, then tk, halve where none
    fits, then the pair's d-parts go, and last an interior TT operator
    core is staged fewer bond rows a chunk (uc). On an H100 at the serving shapes, 32-value chunks beat 16-value
    ones at B=64 even where they leave room for one block an SM, and beat
    64-value ones (K3 at CP(25)); at a B=8 tick, whose pairs split over
    8 or 2 d-parts, 64-value chunks were the fastest."""
    deepest = 32 if plan.tpd == 1 else 64
    while True:
        for dc in (c for c in DC_CHOICES if c <= deepest):
            fit = dataclasses.replace(plan, dc=dc)
            if carry_smem_bytes(fit) <= budget:
                return fit
        if plan.tb > 1:
            plan = dataclasses.replace(plan, tb=plan.tb // 2)
        elif plan.tk > 1:
            plan = dataclasses.replace(plan, tk=plan.tk // 2)
        elif plan.tpd > 1:      # the exchange buffer goes
            plan = dataclasses.replace(plan, tpd=1)
            deepest = 32
        elif plan.uc > plan.ro and plan.order > 2 and plan.op_family == "tt":
            plan = dataclasses.replace(plan, uc=plan.uc - plan.ro)
        else:
            return None


def _plan_double(plan: CarryPlan, deepen, budget: int) -> CarryPlan | None:
    """K6: tk the power of two at or above k / 132 (about a block per SM;
    at most 8), tb the most items (a power of two, at most 32, the batch
    and what CARRY_THREADS leaves) whose two slots fit beside the resident
    operator rows in `budget`; then tpd doubles until the
    block has CARRY_THREADS threads (full blocks beat a grid of more,
    smaller ones on an H100 at the serving shapes). Where one pair does
    not fit, its d-parts (and their exchange buffer) go."""
    room = max(1, CARRY_THREADS // plan.tps)        # pairs a block holds
    tk = max(1, min(8, _pow2floor(room),
                    1 << (max(1, plan.k // H100_SMS) - 1).bit_length()))
    tb = min(32, 1 << (plan.b - 1).bit_length(), _pow2floor(room // tk))
    while True:
        trial = dataclasses.replace(plan, tk=tk, tb=tb)
        tpd = deepen(1, lambda t: tk * tb * plan.tps * t * 2
                     > CARRY_THREADS)
        trial = dataclasses.replace(trial, tpd=tpd)
        if carry_smem_bytes(trial) <= budget:
            return trial
        if tb > 1:
            tb //= 2
        elif tk > 1:
            tk //= 2
        else:
            trial = dataclasses.replace(trial, tpd=1)
            return trial if carry_smem_bytes(trial) <= budget else None


def struct_hbm_bytes(plan: CarryPlan) -> int:
    """Analytic device-memory traffic of one carry-sweep launch, following
    the kernels' schedules: every block stages its k-rows of the operator
    cores and its items' input cores once (K3 chunk by chunk), so under
    K3's (batch, k) grid the operator is read once per batch tile and the
    inputs once per k tile; under K6's (k,) grid the operator once and the
    inputs once per k tile. Each output is written once."""
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
