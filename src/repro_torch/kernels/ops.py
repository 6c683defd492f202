"""Contraction planner + public wrappers around the mode-sweep kernels.

Port of `repro/kernels/ops.py`. The planner (`plan_contraction` ->
`ContractionPlan`) is the single source of truth for the order-N
mode-sweep schedule: it emits the einsum program of the sweep — the SAME
strings the reference planner emits (`_project_steps` /
`_reconstruct_steps`), which tests diff against `repro` — plus tiles
budgeted against Hopper's per-block shared memory, and `program_codes`
lowers the program to the integer opcodes the CUDA kernels execute.

Tiles, re-budgeted for the H100 (the TPU's 8 MiB VMEM budget and 128-lane
tiles do not carry over):

* project (K1): one block owns a (tk k-rows x tb batch rows) output tile
  and loops over every prefix (d1, ..., d_{N-1}) of the input inside the
  block; each thread carries `TBT` batch rows of one k-row, and `tg`
  thread groups share the d1 loop. `ba` is the number of prefixes each
  group stages in shared memory per step. Shared memory
  holds the block's k-rows of the last core, the staged input and the
  per-thread bond accumulators of every sweep level. Under
  `pipeline='double'` (K5) the staged input and the block's tile of the
  leading core have two slots each, so the next chunk streams in while
  the current one contracts.
* reconstruct (K2): a fold launch writes the batch-independent transfer
  block m (k, R, d2..dN) to a scratch buffer, then a tiled product kernel
  owns a (tb rows of (n, d1) x ba columns of d2..dN) output tile and loops
  over the k*R depth in steps of tk.

The wrappers (`tt_project` / `cp_project` and the adjoints) handle single
vs batched inputs and layout conversion from the operator containers for
any order 2 <= N <= MAX_ORDER; other orders take the operator's einsum
route. The kernels mask their own ragged edges, so nothing is padded.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.cp_rp import CPRP
from repro_torch.core.formats import _prod
from repro_torch.core.tt_rp import TTRP

# Per-block shared memory an H100 kernel may opt into (227 KB).
SMEM_BUDGET_BYTES = 232_448
# Streaming multiprocessors of an H100 SXM: the project planner shrinks
# the batch and k tiles until the grid has a block per SM, then adds
# thread groups along d1 up to BLOCK_THREADS threads per block.
H100_SMS = 132
BLOCK_THREADS = 256

# Mode axis letters of the einsum programs ('a' = leading mode).
MODES = "abcdefgh"
MAX_ORDER = len(MODES)

_FAMILIES = ("tt", "cp")
_KINDS = ("project", "reconstruct")
# 'serial': K1 stages each input chunk, then contracts it.
# 'double': K5 copies chunk i+1 (input rows and the leading-core tile) into
# a second shared-memory slot with cp.async while chunk i contracts
# (project only); the planner charges the second slot.
PIPELINES = ("serial", "double")


def validate_pipeline(pipeline: str) -> str:
    """The single `pipeline=` check (planners, dispatch and the plan layer
    delegate here): returns it, or raises the one typed ValueError naming
    the accepted set."""
    if pipeline not in PIPELINES:
        raise ValueError(f"unknown pipeline {pipeline!r}; expected "
                         f"{PIPELINES}")
    return pipeline

# Batch rows each thread of the project kernel carries (csrc: TBT).
TBT = 4
# Floats of padding between the thread groups' staged inputs (csrc: XPAD).
XPAD = 4
# Bond ranks the kernels hold per thread (csrc: MAXR, reconstruct fold).
MAX_RANK = 64
# Tile of the reconstruct product kernel (csrc: BM, BN, BK).
RECON_TILE = (128, 128, 8)

# Opcodes of the lowered program (csrc/sweep_common.cuh holds the same).
OP_FIRST_TT, OP_FIRST_CP, OP_MIX_TT, OP_HAD_CP, OP_LAST = 1, 2, 3, 4, 5
OP_M_INIT_TT, OP_M_INIT_CP, OP_M_MIX_TT, OP_M_HAD_CP = 6, 7, 8, 9


def _pow2ceil(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


# ---------------------------------------------------------------------------
# mode-sweep einsum programs (identical to the reference planner's)
# ---------------------------------------------------------------------------

def _project_steps(family: str, order: int) -> tuple[str, ...]:
    """Einsum program of the projection mode sweep, rightmost mode first.

    Step s contracts operands `(carry, core)`: the carry starts as the
    batched input and the cores are visited last to first; the rank bond
    ('u'/'v' for TT, 'r' for CP) is carried between steps and the final
    step collapses it against the leading core into the `(B, k)` output.
    """
    modes = MODES[:order]
    steps = []
    if family == "tt":
        steps.append(f"n{modes},ku{modes[-1]}->kn{modes[:-1]}u")
        carry = "u"
        for i in range(order - 2, 0, -1):
            new = "v" if carry == "u" else "u"
            steps.append(f"kn{modes[:i + 1]}{carry},k{new}{modes[i]}{carry}"
                         f"->kn{modes[:i]}{new}")
            carry = new
        steps.append(f"kna{carry},ka{carry}->nk")
    else:
        steps.append(f"n{modes},k{modes[-1]}r->kn{modes[:-1]}r")
        for i in range(order - 2, 0, -1):
            steps.append(f"kn{modes[:i + 1]}r,k{modes[i]}r->kn{modes[:i]}r")
        steps.append("knar,kar->nk")
    return tuple(steps)


def _reconstruct_steps(family: str, order: int):
    """Einsum program of the adjoint: `(m_steps, h_spec, out_spec)`.

    The trailing cores fold right-to-left into the batch-independent
    transfer block m `(k, R, d2..dN)` (m_steps; the first entry is a unary
    layout transpose for CP, None for TT whose squeezed last core already
    has the bond leading); h grafts the sketch onto the leading core, and
    out_spec is the one `(B*d1, k*R) x (k*R, prod(d2..dN))` contraction.
    """
    modes = MODES[:order]
    m_steps = []
    if family == "tt":
        m_steps.append(None)
        carry = "u"
        for i in range(order - 2, 0, -1):
            new = "v" if carry == "u" else "u"
            m_steps.append(f"k{new}{modes[i]}{carry},k{carry}{modes[i + 1:]}"
                           f"->k{new}{modes[i:]}")
            carry = new
    else:
        m_steps.append(f"k{modes[-1]}r->kr{modes[-1]}")
        carry = "r"
        for i in range(order - 2, 0, -1):
            m_steps.append(f"k{modes[i]}r,kr{modes[i + 1:]}->kr{modes[i:]}")
    h_spec = f"nk,ka{carry}->nak{carry}"
    out_spec = f"nak{carry},k{carry}{modes[1:]}->na{modes[1:]}"
    return (tuple(m_steps), h_spec, out_spec)


def _project_code(spec: str, order: int, s: int) -> int:
    """Opcode of project step `s`, read off its einsum string."""
    lhs, out = spec.split("->")
    carry, core = lhs.split(",")
    mode = MODES[order - 1 - s]
    if s == 0 and carry == "n" + MODES[:order]:
        if core == f"k{core[1]}{mode}" and core[1] in "uv":
            return OP_FIRST_TT                    # core (k, R, dN)
        if core == f"k{mode}r":
            return OP_FIRST_CP                    # core (k, dN, R)
    elif out == "nk" and mode == "a" and core == "ka" + carry[-1]:
        return OP_LAST                            # core (k, d1, R)
    elif len(core) == 4 and core == f"k{out[-1]}{mode}{carry[-1]}":
        return OP_MIX_TT                          # core (k, Rout, d, Rin)
    elif core == f"k{mode}r" and carry[-1] == out[-1] == "r":
        return OP_HAD_CP                          # core (k, d, R)
    raise ValueError(f"project step {s} {spec!r} has no kernel opcode")


def _m_code(spec: str | None, order: int, j: int) -> int:
    """Opcode of transfer-block step `j` of the reconstruct program."""
    mode = MODES[order - 1 - j]
    if j == 0:
        if spec is None:
            return OP_M_INIT_TT                   # core (k, R, dN) as is
        if spec == f"k{mode}r->kr{mode}":
            return OP_M_INIT_CP                   # core (k, dN, R), transposed
    else:
        lhs, out = spec.split("->")
        core, m = lhs.split(",")
        rest = MODES[order - j:order]
        if (len(core) == 4 and core[2] == mode and m == f"k{core[3]}{rest}"
                and out == f"k{core[1]}{mode}{rest}"):
            return OP_M_MIX_TT
        if core == f"k{mode}r" and m == f"kr{rest}" and out == f"kr{mode}{rest}":
            return OP_M_HAD_CP
    raise ValueError(f"reconstruct step {j} {spec!r} has no kernel opcode")


def program_codes(plan: "ContractionPlan") -> tuple[int, ...]:
    """Lower the plan's einsum program to the kernels' integer opcodes.

    project: one opcode per step (step s contracts mode N-1-s).
    reconstruct: one opcode per transfer-block step; the graft and the
    final contraction are checked to be the fixed forms the product
    kernel computes.
    """
    n = plan.order
    if plan.kind == "project":
        return tuple(_project_code(s, n, i) for i, s in enumerate(plan.steps))
    m_steps, h_spec, out_spec = plan.steps
    carry = "r" if plan.family == "cp" else ("u" if n % 2 == 0 else "v")
    if (h_spec != f"nk,ka{carry}->nak{carry}" or out_spec !=
            f"nak{carry},k{carry}{MODES[1:n]}->na{MODES[1:n]}"):
        raise ValueError(f"reconstruct program {plan.steps!r} has no kernel "
                         "lowering")
    return tuple(_m_code(s, n, j) for j, s in enumerate(m_steps))


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ContractionPlan:
    """A fully-resolved mode-sweep schedule for one kernel launch.

    `steps` is the einsum program the kernels execute (via
    `program_codes`); `smem_bytes` the shared memory one block takes at
    the chosen tiles, which the K1 launch allocates as is (see the module
    docstring for what tk / tb / ba tile in each direction).
    """

    family: str
    kind: str
    k: int
    b: int
    dims: tuple[int, ...]
    rank: int
    tk: int
    tb: int
    ba: int
    steps: tuple
    smem_bytes: int
    tg: int = 1
    pipeline: str = "serial"

    @property
    def order(self) -> int:
        return len(self.dims)

    @property
    def grid(self) -> tuple[int, ...]:
        """CUDA grid: (k tiles, batch tiles) for project; (d2..dN column
        tiles, (n, d1) row tiles) for the reconstruct product."""
        if self.kind == "project":
            return (-(-self.k // self.tk), -(-self.b // self.tb))
        return (-(-_prod(self.dims[1:]) // self.ba),
                -(-(self.b * self.dims[0]) // self.tb))


def project_smem_bytes(tk: int, tb: int, ba: int, tg: int,
                       dims: tuple[int, ...], rank: int,
                       pipeline: str = "serial") -> int:
    """Dynamic shared memory of one K1/K5 block (csrc/sweep_project.cu):
    the last core's tk rows (padded by one float per row against bank
    conflicts), `ba` staged input prefixes per thread group (padded by
    XPAD floats per group), the bond accumulators of the N-2 interior sweep
    levels and one output slot per thread for the group reduction; each
    region 16-byte aligned. 'double' (K5) holds two slots of the staged
    input and two of the block's (tk, tg, rank) leading-core tile."""
    def up4(n):
        return -(-n // 4) * 4
    last = dims[-1]
    nthr = tb // TBT * tk * tg
    slots = 2 if pipeline == "double" else 1
    lead = 2 * up4(tk * tg * rank) if pipeline == "double" else 0
    return 4 * (up4(tk * (rank * last + 1))
                + slots * up4(tg * (ba * last * tb + XPAD)) + lead
                + up4((len(dims) - 2) * rank * TBT * nthr) + TBT * nthr)


def plan_contraction(family: str, kind: str, k: int, b: int,
                     dims: tuple[int, ...], rank: int, *,
                     budget: int = SMEM_BUDGET_BYTES,
                     pipeline: str = "serial") -> ContractionPlan:
    """Plan a mode-sweep kernel launch for order N = len(dims).

    project: at most 32 k-rows with their last-core rows within 48 KB of
    shared memory; the smallest power-of-two batch tile holding the batch
    (at most 16 rows); the batch tile, then tk (floor 4), halved until the
    grid has a block per SM; thread groups along d1 up to
    BLOCK_THREADS threads per block; then ba, tg, tk and tb shrink until
    two blocks fit one SM's shared memory, or at least one fits `budget`. A shape whose single k-row of the last core cannot fit
    raises: the kernel stages that row whole.
    reconstruct: the fixed RECON_TILE product tile; the transfer block
    lives in device memory, so shared memory does not depend on shape.
    `pipeline='double'` (project only) charges K5's second slots.
    """
    if kind not in _KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected {_KINDS}")
    if family not in _FAMILIES:
        raise ValueError(f"unknown family {family!r}; expected {_FAMILIES}")
    validate_pipeline(pipeline)
    if pipeline == "double" and kind != "project":
        raise ValueError(
            "pipeline='double' is implemented for kind='project' only: the "
            "reconstruct sweep accumulates over k and stays serial")
    dims = tuple(int(d) for d in dims)
    order = len(dims)
    if order < 2:
        raise ValueError(f"mode-sweep kernels need order >= 2, got dims={dims}")
    if order > MAX_ORDER:
        raise ValueError(f"order {order} exceeds MAX_ORDER={MAX_ORDER}")
    r = max(1, int(rank))
    b = max(1, int(b))
    if kind == "project":
        tk = 32
        while tk > 1 and 4 * tk * (r * dims[-1] + 1) > 48 * 1024:
            tk //= 2
        tb = TBT * min(8, _pow2ceil(-(-b // TBT)))

        def blocks():
            return -(-k // tk) * -(-b // tb)

        while tb > TBT and blocks() < H100_SMS:
            tb //= 2
        while tk > 4 and blocks() < H100_SMS:
            tk //= 2
        tg = max(1, min(dims[0], BLOCK_THREADS // (tk * tb // TBT)))
        ba = min(8, _prod(dims[1:-1]))

        def smem():
            return project_smem_bytes(tk, tb, ba, tg, dims, r, pipeline)

        # two blocks per SM where possible, then the hard block budget
        for limit in (budget // 2, budget):
            while smem() > limit and (ba > 1 or tg > 1 or tk > 1
                                      or tb > TBT):
                if ba > 1:
                    ba //= 2
                elif tg > 1:
                    tg //= 2
                elif tk > 1:
                    tk //= 2
                else:
                    tb //= 2
        nbytes = smem()
        if nbytes > budget:
            raise ValueError(
                f"plan_contraction(project): dims={dims}, rank={r} need "
                f"{nbytes} bytes of shared memory at the smallest tiling, "
                f"over the {budget}-byte block budget: one k-row of the "
                "last core (rank x last mode) must fit; use a smaller last "
                "mode")
        steps = _project_steps(family, order)
    else:
        tb, ba, tk = RECON_TILE
        tg = 1
        nbytes = 4 * tk * (tb + ba)
        steps = _reconstruct_steps(family, order)
    return ContractionPlan(family=family, kind=kind, k=int(k), b=b, dims=dims,
                           rank=r, tk=tk, tb=tb, ba=ba, steps=steps,
                           smem_bytes=nbytes, tg=tg, pipeline=pipeline)


def sweep_hbm_bytes(plan: ContractionPlan) -> int:
    """Analytic device-memory traffic of one batched sweep call, following
    the kernels' schedules.

    project: each block streams its batch rows of x once (so x is read
    once per k tile) and reads its k-rows of every core once; K5 copies
    the same tiles, only earlier.
    reconstruct: the fold reads the trailing cores and writes m; the
    product reads the sketch and leading core once per column tile, m once
    per row tile, and writes the output once.
    """
    k, b, dims, r = plan.k, plan.b, plan.dims, plan.rank
    x_total = 4 * b * _prod(dims)
    y_total = 4 * b * k
    c1 = 4 * k * dims[0] * r
    if plan.family == "tt":
        c_rest = (sum(4 * k * r * d * r for d in dims[1:-1])
                  + 4 * k * r * dims[-1])
    else:
        c_rest = sum(4 * k * d * r for d in dims[1:])
    if plan.kind == "project":
        nk, nb = plan.grid
        return nk * x_total + nb * (c1 + c_rest) + y_total
    m_total = 4 * k * r * _prod(dims[1:])
    n_cols, n_rows = plan.grid
    return (c_rest + m_total                                  # fold
            + n_cols * (y_total + c1) + n_rows * m_total + x_total)


# ---------------------------------------------------------------------------
# operator-container layouts
# ---------------------------------------------------------------------------

def tt_cores_squeezed(op: TTRP) -> tuple[torch.Tensor, ...]:
    """Kernel layout of TT cores: boundary bonds (r_0 = r_N = 1) squeezed —
    (k, d1, R), interior (k, R, dn, R), (k, R, dN). Requires order >= 2."""
    cores = op.cores
    return ((cores[0][:, 0, :, :],) + tuple(cores[1:-1])
            + (cores[-1][:, :, :, 0],))


def kernel_order_supported(order: int) -> bool:
    """Orders the mode-sweep kernels cover; outside it (order-1 classical
    Gaussian, order > MAX_ORDER) the wrappers take the einsum route."""
    return 2 <= order <= MAX_ORDER


def _as_batch(x: torch.Tensor, ndim: int) -> tuple[torch.Tensor, bool]:
    """Add a singleton batch axis when `x` is a single input of rank `ndim`."""
    if x.ndim == ndim:
        return x[None], False
    if x.ndim != ndim + 1:
        raise ValueError(f"expected {ndim} or {ndim + 1} axes, got shape "
                         f"{tuple(x.shape)}")
    return x, True


# ---------------------------------------------------------------------------
# projections and adjoints
# ---------------------------------------------------------------------------

def _sweep_project(family, op, cores, x, pipeline="serial"):
    from .cp_sweep import cp_sweep_project
    from .tt_sweep import tt_sweep_project
    xb, batched = _as_batch(x, op.order)
    plan = plan_contraction(family, "project", op.k, xb.shape[0], op.in_dims,
                            op.rank, pipeline=pipeline)
    kern = tt_sweep_project if family == "tt" else cp_sweep_project
    y = kern(xb.contiguous(), *(c.contiguous() for c in cores), plan=plan,
             scale=1.0 / math.sqrt(op.k))
    return y if batched else y[0]


def _sweep_reconstruct(family, op, cores, y):
    from .cp_sweep import cp_sweep_reconstruct
    from .tt_sweep import tt_sweep_reconstruct
    yb, batched = _as_batch(y, 1)
    plan = plan_contraction(family, "reconstruct", op.k, yb.shape[0],
                            op.in_dims, op.rank)
    kern = tt_sweep_reconstruct if family == "tt" else cp_sweep_reconstruct
    out = kern(yb.contiguous(), *(c.contiguous() for c in cores), plan=plan,
               scale=1.0 / math.sqrt(op.k))
    return out if batched else out[0]


def _einsum_reconstruct(op, y):
    if y.ndim == 2:
        return torch.stack([op.reconstruct(row) for row in y])
    return op.reconstruct(y)


def tt_project(op: TTRP, x: torch.Tensor, *,
               pipeline: str = "serial") -> torch.Tensor:
    """f_TT(R)(x) for dense order-N input(s) via the mode-sweep kernel.

    x: (*dims) -> (k,)  or  (B, *dims) -> (B, k), one launch either way.
    `pipeline='double'` launches K5 (`sweep_project_pipelined`) instead of
    K1 — the same function with double-buffered input streams.
    """
    validate_pipeline(pipeline)
    if not kernel_order_supported(op.order):
        return op.project(x)
    return _sweep_project("tt", op, tt_cores_squeezed(op), x, pipeline)


def cp_project(op: CPRP, x: torch.Tensor, *,
               pipeline: str = "serial") -> torch.Tensor:
    """f_CP(R)(x) for dense order-N input(s) via the mode-sweep kernel."""
    validate_pipeline(pipeline)
    if not kernel_order_supported(op.order):
        return op.project(x)
    return _sweep_project("cp", op, op.factors, x, pipeline)


def tt_reconstruct(op: TTRP, y: torch.Tensor) -> torch.Tensor:
    """Unbiased adjoint for sketch(es): (k,) -> dims or (B,k) -> (B,*dims),
    one launch per call."""
    if not kernel_order_supported(op.order):
        return _einsum_reconstruct(op, y)
    return _sweep_reconstruct("tt", op, tt_cores_squeezed(op), y)


def cp_reconstruct(op: CPRP, y: torch.Tensor) -> torch.Tensor:
    """Unbiased adjoint for sketch(es) of a CP operator; see tt_reconstruct."""
    if not kernel_order_supported(op.order):
        return _einsum_reconstruct(op, y)
    return _sweep_reconstruct("cp", op, op.factors, y)


__all__ = ["ContractionPlan", "MAX_ORDER", "PIPELINES", "SMEM_BUDGET_BYTES",
           "cp_project", "cp_reconstruct", "kernel_order_supported",
           "plan_contraction", "program_codes", "sweep_hbm_bytes",
           "tt_cores_squeezed", "tt_project", "tt_reconstruct",
           "validate_pipeline"]
