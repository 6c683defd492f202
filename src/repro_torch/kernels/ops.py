"""Contraction planner + public wrappers around the mode-sweep kernels.

Port of `repro/kernels/ops.py`. The planner (`plan_contraction` ->
`ContractionPlan`) is the single source of truth for the order-N
mode-sweep schedule: it emits the einsum program of the sweep — the SAME
strings the reference planner emits (`_project_steps` /
`_reconstruct_steps`), which tests diff against `repro` — plus tiles
budgeted against Hopper's per-block shared memory, and `program_codes`
lowers the fold that both directions run to the integer opcodes the CUDA
kernels execute.

Tiles, re-budgeted for the H100 (the TPU's 8 MiB VMEM budget and 128-lane
tiles do not carry over):

* project (K1): the dense-operator route in three launches. The fold
  writes the transfer block m (k, R, T = d2..dN) to a scratch buffer (the
  reconstruct program's m steps, `program_codes`); a product kernel builds
  the operator S[i, a, t] = sum_u g1[i, a, u] m[i, u, t] tile by tile in
  shared memory and contracts it with the input; a reduce sums the
  partials. A block owns a (tb batch rows x tk k-rows) tile and one of
  `groups` runs of T-chunks of `tc` columns; it keeps each chunk of m
  resident while it walks the leading index `ba` values (a slab) at a
  time. Under `pipeline='double'` (K5) the staged input and leading-core
  slab have two slots, and the m chunk `m_slots` (two where they fit),
  so the next slab streams in while the current one contracts.
* reconstruct (K2, K4): the same route backwards, in two launches. The
  fold writes m (k, R, T) to a scratch buffer; a product kernel owns an
  output tile of tb batch rows x a slab of `ba` leading indices x a chunk
  of `tc` columns of T (ba * tc = RECON_TILE_N), walks the depth k in
  chunks of tk, builds the operator tile S[k-chunk, slab, chunk] in shared
  memory and accumulates the (B, k) x (k, D) product in registers. Its
  blocks run slab fastest, then batch tile, then chunk, so the blocks that
  read one chunk of m run together and L2 serves the repeats.

The wrappers (`tt_project` / `cp_project` and the adjoints) handle single
vs batched inputs and layout conversion from the operator containers for
any order 2 <= N <= MAX_ORDER; other orders take the operator's einsum
route. The kernels mask their own ragged edges, so nothing is padded.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.core.cp_rp import CPRP
from repro_torch.core.formats import _prod
from repro_torch.core.tt_rp import TTRP

# Per-block shared memory an H100 kernel may opt into (227 KB).
SMEM_BUDGET_BYTES = 232_448
# Streaming multiprocessors of an H100 SXM: the project planner splits T
# into groups until the grid holds two blocks per SM.
H100_SMS = 132

# Mode axis letters of the einsum programs ('a' = leading mode).
MODES = "abcdefgh"
MAX_ORDER = len(MODES)

_FAMILIES = ("tt", "cp")
_KINDS = ("project", "reconstruct")
# 'serial': K1 stages each slab of the input, then contracts it.
# 'double': K5 copies slab i+1 (input rows and the leading-core tile, and
# the next chunk of m where two slots fit) into second shared-memory slots
# with cp.async while slab i contracts (project only); the planner charges
# the second slots.
PIPELINES = ("serial", "double")


def validate_pipeline(pipeline: str) -> str:
    """The single `pipeline=` check (planners, dispatch and the plan layer
    delegate here): returns it, or raises the one typed ValueError naming
    the accepted set."""
    if pipeline not in PIPELINES:
        raise ValueError(f"unknown pipeline {pipeline!r}; expected "
                         f"{PIPELINES}")
    return pipeline

# The project product kernel (csrc/sweep_project.cu): PROJECT_THREADS
# threads as 16 x 16, each owning TM batch rows x TN k-rows, so a block
# tile is 16*TM batch rows (TM in PROJECT_TM) x 16*TN k-rows (PROJECT_TILE_K).
PROJECT_THREADS = 256
PROJECT_TM = (1, 2, 3, 4, 6, 8)
PROJECT_TILE_K = (128, 64)
# T-chunk candidates (powers of 2 from 4: float4 reads of m), and the
# product depth a slab (ba leading indices x tc columns) aims for between
# barriers.
PROJECT_TILE_T = (16, 8, 4)
PROJECT_DEPTH = 64
# Bond ranks the fold holds per thread (csrc/sweep_fold.cuh: MAXR); K1,
# K5, K2 and K4 share the fold.
MAX_RANK = 64
# The reconstruct product kernel (csrc/sweep_reconstruct.cuh, K2 and K4):
# RECON_THREADS threads as 16 x 16, each owning TM batch rows x 8 columns,
# so a block tile is 16*TM batch rows (TM in RECON_TM) x RECON_TILE_N
# output columns (a slab of ba leading indices x a chunk of tc columns of
# T, ba * tc = RECON_TILE_N, tc a power of 2 in RECON_TILE_T); the depth k
# goes in chunks of tk (RECON_TILE_K). The operator tile's rows are
# RECON_S_STRIDE floats apart.
RECON_THREADS = 256
RECON_TM = (1, 2, 3, 4, 6, 8)
RECON_TILE_N = 128
RECON_TILE_K = (64, 32, 16)
RECON_TILE_T = (4, 8, 16, 32, 64, 128)
RECON_S_STRIDE = 132

# Opcodes of the lowered fold (csrc/sweep_common.cuh holds the same).
OP_M_INIT_TT, OP_M_INIT_CP, OP_M_MIX_TT, OP_M_HAD_CP = 6, 7, 8, 9


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
    """The opcodes the kernels execute for the plan: the fold of the
    trailing cores, one opcode per transfer-block step of the reconstruct
    program of the plan's family and order. K1, K5, K2 and K4 share it.
    For a reconstruct plan the program's graft and final contraction are
    checked to be the fixed forms whose function the operator-tile product
    computes; a plan's steps stay the reference's program, which the plain
    versions run.
    """
    n = plan.order
    if plan.kind == "project":
        m_steps = _reconstruct_steps(plan.family, n)[0]
    else:
        m_steps, h_spec, out_spec = plan.steps
        carry = "r" if plan.family == "cp" else ("u" if n % 2 == 0 else "v")
        if (h_spec != f"nk,ka{carry}->nak{carry}" or out_spec !=
                f"nak{carry},k{carry}{MODES[1:n]}->na{MODES[1:n]}"):
            raise ValueError(f"reconstruct program {plan.steps!r} has no "
                             "kernel lowering")
    return tuple(_m_code(s, n, j) for j, s in enumerate(m_steps))


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

class RankLimitError(ValueError):
    """A bond rank above what the fold holds per thread (MAX_RANK)."""


@dataclasses.dataclass(frozen=True)
class ContractionPlan:
    """A fully-resolved mode-sweep schedule for one kernel launch.

    `steps` is the einsum program of the reference planner (via
    `program_codes`); `smem_bytes` the shared memory one block of the
    product kernel takes at the chosen tiles, which the launch allocates
    as is. project: tk k-rows x tb batch rows per block, ba leading
    indices per slab, tc columns of T = prod(d2..dN) per chunk, the chunks
    split into `groups` runs (one per grid z), m_slots chunks of m
    resident (K5: 2 where they fit). reconstruct: tb batch rows x a slab
    of ba leading indices x a chunk of tc columns of T per block, the
    depth k in chunks of tk.
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
    tc: int = 0
    groups: int = 1
    m_slots: int = 1
    pipeline: str = "serial"

    @property
    def order(self) -> int:
        return len(self.dims)

    @property
    def trail(self) -> int:
        """T = prod(d2..dN), the columns of the transfer block m."""
        return _prod(self.dims[1:])

    @property
    def grid(self) -> tuple[int, ...]:
        """The product kernel's blocks. project: the CUDA grid (k tiles,
        batch tiles, groups). reconstruct: (slabs of ba leading indices,
        batch tiles, T-chunks), launched as one linear grid of their
        product with the slab fastest, then the batch tile."""
        if self.kind == "project":
            return (-(-self.k // self.tk), -(-self.b // self.tb), self.groups)
        return (-(-self.dims[0] // self.ba), -(-self.b // self.tb),
                -(-self.trail // self.tc))

    @property
    def m_scratch_shape(self) -> tuple[int, int, int]:
        """The fold's output m (k, R, T), a scratch of K1, K5, K2 and
        K4."""
        return (self.k, self.rank, self.trail)

    @property
    def partial_shape(self) -> tuple[int, int, int]:
        """The project product's partial sums (groups, B, k), a scratch of
        K1 and K5 that the reduce launch sums in group order."""
        return (self.groups, self.b, self.k)


def _up4(n: int) -> int:
    return -(-n // 4) * 4


def m_row_stride(rank: int, tc: int) -> int:
    """Floats between two k-rows of the staged m chunk: R*tc padded to 4
    (mod 32), so the float4 reads of eight consecutive k-rows fall in
    distinct banks (csrc: ProjectArgs.ms)."""
    return rank * tc + (4 - rank * tc % 32) % 32


def project_smem_bytes(tb: int, tk: int, ba: int, tc: int, rank: int,
                       pipeline: str = "serial", m_slots: int = 1) -> int:
    """Dynamic shared memory of one K1/K5 product block
    (csrc/sweep_project.cu, `layout`): `m_slots` chunks of m (tk rows of
    `m_row_stride` floats), the input slab (ba*tc rows of tb+1 floats) and
    the leading-core slab (ba*R rows of tk floats), each with a second
    slot under 'double', and the operator tile (ba*tc rows of tk floats);
    each region 16-byte aligned."""
    xslots = 2 if pipeline == "double" else 1
    return 4 * (m_slots * tk * m_row_stride(rank, tc)
                + xslots * (_up4(ba * tc * (tb + 1)) + ba * rank * tk)
                + ba * tc * tk)


def _groups(n_chunks: int, tiles: int) -> int:
    """Groups of T-chunks (grid z) for `tiles` (k, batch) tiles: at least
    two blocks per SM where T has the chunks, at most four waves of them,
    every group non-empty, and of those the split with the fewest
    chunk-steps on the busiest SM (the grid's waves of 2 * H100_SMS blocks
    times the chunks per block), then the fewest blocks (partials)."""
    slots = 2 * H100_SMS
    need = min(n_chunks, -(-slots // tiles))
    best = None
    for per in range(1, -(-n_chunks // need) + 1):
        groups = -(-n_chunks // per)
        blocks = tiles * groups
        key = (-(-blocks // slots) * per, blocks)
        if (groups >= need and (blocks <= 4 * slots or groups == need)
                and (best is None or key < best[0])):
            best = (key, groups)
    return best[1]


def _batch_tile(b: int, tms: tuple[int, ...]) -> int:
    """The smallest 16*TM rows (TM in `tms`) that hold the batch, at most
    the largest."""
    return 16 * next((t for t in tms if 16 * t >= b), tms[-1])


@functools.lru_cache(maxsize=1024)
def _plan_project(k: int, b: int, dims: tuple[int, ...], r: int, budget: int,
                  pipeline: str) -> dict:
    """Tiles of the K1/K5 product kernel.

    The batch tile is the smallest 16*TM holding the batch (TM in
    PROJECT_TM; larger batches take several tiles of 128 rows). Then the
    first (tc, tk) of PROJECT_TILE_T x PROJECT_TILE_K, wide chunks first
    (tc no wider than T needs), whose block fits two to an SM, else one
    within `budget`, with ba = PROJECT_DEPTH // tc leading indices per
    slab (at most d1), cut until it fits. Wide chunks come first because
    the leading-core slab is staged again for every chunk. K5 ('double') charges its second slots, and keeps two
    m chunks where they fit the same limit. Then T's chunks split into
    groups until the grid holds two blocks per SM.
    """
    d1, trail = dims[0], _prod(dims[1:])
    tb = _batch_tile(b, PROJECT_TM)
    tc_max = _up4(trail)
    double = pipeline == "double"
    for limit in (budget // 2 - 1024, budget):   # two blocks an SM, then one
        for tc in PROJECT_TILE_T:
            for tk in PROJECT_TILE_K:
                if tc > tc_max and tc != PROJECT_TILE_T[-1]:
                    continue
                ba = max(1, min(d1, PROJECT_DEPTH // tc))

                def smem(m_slots=1):
                    return project_smem_bytes(tb, tk, ba, tc, r, pipeline,
                                              m_slots)

                while ba > 1 and smem() > limit:
                    ba -= 1
                if smem() > limit:
                    continue
                m_slots = 2 if double and smem(2) <= limit else 1
                tiles = -(-k // tk) * -(-b // tb)
                return dict(tk=tk, tb=tb, ba=ba, tc=tc,
                            groups=_groups(-(-trail // tc), tiles),
                            m_slots=m_slots, smem_bytes=smem(m_slots))
    raise ValueError(
        f"plan_contraction(project): dims={dims}, rank={r} need "
        f"{project_smem_bytes(tb, PROJECT_TILE_K[-1], 1, 4, r, pipeline)} "
        f"bytes of shared memory at the smallest tiling, over the "
        f"{budget}-byte block budget")


def recon_smem_bytes(tb: int, tk: int, ba: int, tc: int, rank: int) -> int:
    """Dynamic shared memory of one K2/K4 product block
    (csrc/sweep_reconstruct.cuh, `recon_smem_floats`): the sketch chunk
    (tk rows of tb+1 floats), the leading-core slab (ba*R rows of tk
    floats), the chunk of m (tk rows of `m_row_stride` floats) and the
    operator tile (tk rows of RECON_S_STRIDE floats)."""
    return 4 * (_up4(tk * (tb + 1)) + tk * ba * rank
                + tk * m_row_stride(rank, tc) + tk * RECON_S_STRIDE)


@functools.lru_cache(maxsize=1024)
def _plan_reconstruct(k: int, b: int, dims: tuple[int, ...], r: int,
                      budget: int) -> dict:
    """Tiles of the K2/K4 product kernel.

    The batch tile is the smallest 16*TM holding the batch, up to 128 rows
    (larger batches take several tiles): the operator tile is built once
    per batch tile, so the build costs R/tb of the product. The chunk
    width tc (ba = RECON_TILE_N // tc leading
    indices a slab) comes first by the fewest blocks (the least masked
    waste at the ragged edges of d1 and T), then by the fewest floats
    staged per output column (1/ba + 1/tc: the chunk of m is staged for
    each slab, the leading-core slab for each chunk), then the wider chunk;
    the first that fits takes the deepest tk of RECON_TILE_K that fits
    (fewer barriers a block). Fitting means two blocks to an SM where any
    tiling does, else one within `budget`.
    """
    d1, trail = dims[0], _prod(dims[1:])
    tb = _batch_tile(b, RECON_TM)

    def key(tc):
        ba = RECON_TILE_N // tc
        return (-(-d1 // ba) * -(-trail // tc), 1 / ba + 1 / tc, -tc)

    for limit in (budget // 2 - 1024, budget):   # two blocks an SM, then one
        for tc in sorted(RECON_TILE_T, key=key):
            ba = RECON_TILE_N // tc
            for tk in RECON_TILE_K:
                smem = recon_smem_bytes(tb, tk, ba, tc, r)
                if smem <= limit:
                    return dict(tk=tk, tb=tb, ba=ba, tc=tc, smem_bytes=smem)
    least = min(recon_smem_bytes(tb, RECON_TILE_K[-1], RECON_TILE_N // tc,
                                 tc, r) for tc in RECON_TILE_T)
    raise ValueError(
        f"plan_contraction(reconstruct): dims={dims}, rank={r} need "
        f"{least} bytes of shared memory at the smallest tiling, over the "
        f"{budget}-byte block budget")


def plan_contraction(family: str, kind: str, k: int, b: int,
                     dims: tuple[int, ...], rank: int, *,
                     budget: int = SMEM_BUDGET_BYTES,
                     pipeline: str = "serial") -> ContractionPlan:
    """Plan a mode-sweep kernel launch for order N = len(dims).

    project: the K1/K5 tiles of `_plan_project`; a bond rank above
    MAX_RANK raises RankLimitError (the fold holds a rank-vector per
    thread, as K2's and K4's does; their wrappers refuse such a rank at
    launch, so a reconstruct plan still serves the plain version on the
    CPU). reconstruct: the K2/K4 tiles of `_plan_reconstruct`.
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
        if r > MAX_RANK:
            raise RankLimitError(
                f"plan_contraction(project): rank {r} exceeds MAX_RANK="
                f"{MAX_RANK}, the bond rank the fold holds per thread")
        tiles = _plan_project(int(k), b, dims, r, budget, pipeline)
        steps = _project_steps(family, order)
    else:
        tiles = _plan_reconstruct(int(k), b, dims, r, budget)
        steps = _reconstruct_steps(family, order)
    return ContractionPlan(family=family, kind=kind, k=int(k), b=b, dims=dims,
                           rank=r, steps=steps, pipeline=pipeline, **tiles)


def sweep_hbm_bytes(plan: ContractionPlan) -> int:
    """Analytic device-memory traffic of one batched sweep call, following
    the kernels' schedules.

    Both directions fold first: the fold reads the trailing cores and
    writes m. project: each block reads its chunks of m once (so m is read
    once per batch tile), its input rows once (x once per k tile) and its
    k-rows of the leading core once per chunk, and writes its partial
    tile; the reduce reads the partials and writes y. K5 copies the same
    tiles, only earlier. reconstruct: every block stages its chunk of m,
    its rows of the sketch and its slab of the leading core over the whole
    depth, so the blocks read m d1/ba times per batch tile and the sketch
    and the leading core once per chunk. The blocks that share a chunk of
    m run together (slab fastest, then batch tile), and the sketch and the
    leading core are small beside L2, so L2 serves those repeats: each is
    counted once from device memory, beside the output written once.
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
    m_total = 4 * k * r * plan.trail
    fold = c_rest + m_total
    if plan.kind == "project":
        nk, nb, groups = plan.grid
        n_chunks = -(-plan.trail // plan.tc)
        partials = 4 * groups * b * k
        return (fold + nb * m_total + nk * x_total + nb * n_chunks * c1
                + 2 * partials + y_total)
    return fold + m_total + y_total + c1 + x_total


def pick_tiles(k: int, b: int, dims: tuple[int, ...], rank: int, *,
               kind: str = "project", family: str = "tt",
               budget: int = SMEM_BUDGET_BYTES) -> tuple[int, int, int, int]:
    """(tk, tb, ba, tc) of an order-N mode-sweep launch under a block's
    shared-memory budget — the tile view of `plan_contraction`, kept as the
    stable public selector (the reference's returns the TPU planner's
    (tk, tb, ba))."""
    plan = plan_contraction(family, kind, k, b, dims, rank, budget=budget)
    return plan.tk, plan.tb, plan.ba, plan.tc


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


__all__ = ["ContractionPlan", "MAX_ORDER", "PIPELINES", "RankLimitError",
           "SMEM_BUDGET_BYTES", "cp_project", "cp_reconstruct",
           "kernel_order_supported", "pick_tiles", "plan_contraction",
           "program_codes", "sweep_hbm_bytes",
           "tt_cores_squeezed", "tt_project", "tt_reconstruct",
           "validate_pipeline"]
