"""ExecutionPlan: the one plan layer under every projection path.

Port of `repro/rp/plan.py`. Every `rp.project` / `rp.reconstruct` /
`rp.project_many` / serve tick resolves through a frozen, hashable
`ExecutionPlan` held in an LRU plan cache keyed by (family, k, dims, rank)
x (structure, batch, in_rank, chunk) x (kind, backend, pipeline) x the
device type the operator lives on.

Dispatch matrix (input format x operator family -> route):

  dense/flat x tt/cp (2<=N<=MAX_ORDER)  mode-sweep kernel K1 (K5 under
                                        pipeline='double') | einsum
  (*batch, k) sketch x tt/cp            mode-sweep adjoint K2 | einsum
  (Batched)TT/CP x tt/cp (2<=N)         carry-sweep kernel K3 (K6 under
                                        pipeline='double'), ONE launch
                                        per batched call | batched einsum
                                        oracles (`kernels.struct.ref`)
  order outside [2, MAX_ORDER] x any    einsum, even under 'kernel'
  dense/flat x gaussian/sparse          streamed blocks (`core.baselines`)
  (Batched)TT/CP x gaussian/sparse      densified, then the dense row

Backend policy (`backend='auto' | 'kernel' | 'torch'`, standing in for
the reference's 'auto' | 'pallas' | 'xla'):

* 'torch'  — always the operator's einsum path.
* 'kernel' — always the kernel wrappers; on a CUDA operator they launch
             the hand-written kernels, on a CPU operator they run the
             kernels' plain versions (the CPU counterpart of interpret mode).
* 'auto'   — the kernel for every tt/cp operator of a supported order on a
             CUDA device; the einsum path on the CPU unless
             `rp.force_kernel()` is active (then the plain versions run).
             The force depth is part of the cache key.

`pipeline='serial' | 'double'` picks the double-buffered kernels K5/K6 on
the kernel route; the einsum route has nothing to pipeline and ignores it
(it is validated either way).

The plan carries a `CostLedger` (flops, analytic device-memory bytes of
the route, the kernel's shared memory per block, the operator's parameter
count and the Thm-1 variance factor) and, on structured rows, the bytes of
the carried bond state; `rp.explain(op, x)` returns the plan with its
rejected alternatives and reasons.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict

import torch

from repro_torch.core import theory
from repro_torch.core.baselines import GaussianRP, VerySparseRP
from repro_torch.core.cp_rp import CPRP
from repro_torch.core.formats import (STRUCT_TYPES, BatchedCPTensor,
                                      BatchedTTTensor, CPTensor, TTTensor,
                                      _prod)
from repro_torch.core.tt_rp import TTRP

from .protocol import ProjectorSpec

BACKENDS = ("auto", "kernel", "torch")
STRUCTURES = ("dense", "tt", "cp", "sketch")


def validate_backend(backend: str) -> str:
    """The single `backend=` check: returns it, or raises the one typed
    ValueError naming the accepted set."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    return backend


def validate_pipeline(pipeline: str) -> str:
    """The single `pipeline=` check — delegates to the kernels layer, which
    owns the `PIPELINES` tuple the schedules implement."""
    # local import: the kernels package is not a module-level dependency
    from repro_torch.kernels.ops import validate_pipeline as _vp
    return _vp(pipeline)


def pow2ceil(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor) — the shape bucket
    `project_many` pads batches to and the serve engine plans against."""
    out = 1
    while out < max(int(n), floor):
        out *= 2
    return out


def structure_tag(payload) -> str:
    """'tt' | 'cp' | 'dense' — the structure of ONE payload (the group key
    of `project_many` and the serve batcher's lane splitter)."""
    if isinstance(payload, (TTTensor, BatchedTTTensor)):
        return "tt"
    if isinstance(payload, (CPTensor, BatchedCPTensor)):
        return "cp"
    return "dense"


# ---------------------------------------------------------------------------
# the plan IR
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StructureSig:
    """Signature of WHAT is being executed.

    structure : 'dense' | 'tt' | 'cp' (structured input) | 'sketch'
                (reconstruct input).
    batch     : coalesced batch rows the dispatch will see.
    in_rank   : structured-input rank as the carry-sweep planner sees it
                (TT: max bond rank incl. boundary 1s; CP: component rank);
                0 for dense/sketch.
    chunk     : reconstruct-only k-intermediate bound (None elsewhere).
    """

    structure: str = "dense"
    batch: int = 1
    in_rank: int = 0
    chunk: int | None = None

    def __post_init__(self):
        if self.structure not in STRUCTURES:
            raise ValueError(f"unknown structure {self.structure!r}; "
                             f"expected {STRUCTURES}")


@dataclasses.dataclass(frozen=True)
class CostLedger:
    """Analytic cost of one planned execution.

    flops      : 2x multiply-add count for the whole batch, from theory
                 (`flops_project_struct` on structured rows).
    hbm_bytes  : device-memory traffic: the kernel routes read the
                 planners' `sweep_hbm_bytes` / `struct_hbm_bytes`; the
                 einsum route reports the one-pass lower bound (inputs +
                 operator + outputs).
    smem_bytes : the kernel's dynamic shared memory per block (0 on torch).
    wire_bytes : collective payload bytes (0 for a local dispatch; the
                 compressed all-reduce's ledger is `collective_wire_bytes`).
    params     : operator parameter count (the paper's memory axis).
    var_factor : Thm-1 variance factor of the family at this order/rank.
    """

    flops: int
    hbm_bytes: int
    smem_bytes: int
    wire_bytes: int
    params: int
    var_factor: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A fully-resolved, frozen, hashable execution decision.

    `route` is the RESOLVED backend ('kernel' | 'torch'); `rejected` names
    every alternative route with the reason it lost. `tiles` / `grid` come
    from the kernel planner (`plan_contraction`); None on the torch route.
    `device` is the device type the operator lives on.
    """

    plan_id: str
    family: str
    structure: str
    kind: str                      # 'project' | 'reconstruct' |
                                   # 'update' | 'update-unfused'
    order: int
    k: int
    batch: int
    dims: tuple
    rank: int
    in_rank: int
    backend: str                   # requested policy
    route: str                     # resolved 'kernel' | 'torch'
    kernel: str
    pipeline: str
    device: str
    chunk: int | None
    chunk_policy: str              # 'n/a' | 'folded' | 'honored'
    tiles: tuple | None            # dense sweep and update: (tk, tb, ba,
                                   # tc); carry sweep: (tk, tb)
    grid: tuple | None
    rejected: tuple                # ((route, reason), ...)
    cost: CostLedger
    carry_bytes: int = 0           # structured rows: the (B, k, R·R~)
                                   # bond state replacing dense sweep temps

    def as_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["cost"] = self.cost.as_dict()
        return out

    def describe(self) -> str:
        """Markdown block for `rp.explain`."""
        c = self.cost
        lines = [
            f"### plan {self.plan_id}: {self.kind} "
            f"{self.family}/{self.structure} N={self.order}",
            "",
            f"* route: **{self.route}** (requested backend="
            f"'{self.backend}', pipeline='{self.pipeline}', "
            f"device={self.device})",
            f"* kernel: {self.kernel}",
            f"* shape: k={self.k} dims={'x'.join(map(str, self.dims))} "
            f"rank={self.rank} batch={self.batch}"
            + (f" in_rank={self.in_rank}" if self.in_rank else ""),
        ]
        if self.tiles is not None:
            lines.append(f"* tiles: {self.tiles} grid={self.grid}")
        if self.carry_bytes:
            lines.append(f"* carry_bytes: {self.carry_bytes}")
        if self.kind == "reconstruct":
            lines.append(f"* chunk: {self.chunk} ({self.chunk_policy})")
        lines += [
            f"* cost: flops={c.flops} hbm_bytes={c.hbm_bytes} "
            f"smem_bytes={c.smem_bytes} wire_bytes={c.wire_bytes} "
            f"params={c.params} "
            f"var_factor={c.var_factor:.2f}",
            "",
            "rejected alternatives:",
        ]
        for route, reason in self.rejected:
            lines.append(f"* {route}: {reason}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# plan cache
# ---------------------------------------------------------------------------

_CACHE_CAP = 512


@dataclasses.dataclass
class PlanCacheStats:
    builds: int = 0
    hits: int = 0
    evictions: int = 0

    @property
    def lookups(self) -> int:
        return self.builds + self.hits

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> dict:
        return {"builds": self.builds, "hits": self.hits,
                "evictions": self.evictions, "hit_rate": self.hit_rate}


_PLAN_CACHE: "OrderedDict[tuple, ExecutionPlan]" = OrderedDict()
_CACHE_STATS = PlanCacheStats()


def plan_cache_stats() -> PlanCacheStats:
    """The LIVE plan-cache stats object (builds/hits/evictions)."""
    return _CACHE_STATS


def clear_plan_cache() -> None:
    """Drop every cached plan and reset the stats."""
    _PLAN_CACHE.clear()
    _CACHE_STATS.builds = _CACHE_STATS.hits = _CACHE_STATS.evictions = 0


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

_FAMILY_BY_TYPE = {TTRP: "tt", CPRP: "cp", GaussianRP: "gaussian",
                   VerySparseRP: "sparse"}
_TN_FAMILIES = ("tt", "cp")


@dataclasses.dataclass(frozen=True)
class _OpSig:
    """Signature of the OPERATOR side of a plan key."""

    family: str
    k: int
    dims: tuple
    rank: int
    is_tn: bool
    device: str


def _op_signature(op_spec, device: str | None = None) -> _OpSig:
    """Normalize an operator instance OR a `ProjectorSpec` to one key.

    A spec has no device: pass `device` ('cuda' or 'cpu') to plan for one;
    an operator's own device is authoritative.
    """
    if isinstance(op_spec, ProjectorSpec):
        is_tn = op_spec.family in _TN_FAMILIES
        return _OpSig(family=op_spec.family, k=int(op_spec.k),
                      dims=tuple(op_spec.dims),
                      rank=int(op_spec.rank) if is_tn else 0, is_tn=is_tn,
                      device=device or "cuda")
    op = op_spec
    family = _FAMILY_BY_TYPE.get(type(op), type(op).__name__.lower())
    is_tn = family in _TN_FAMILIES
    dev = getattr(op, "device", torch.device("cpu"))
    return _OpSig(family=family, k=int(op.k),
                  dims=tuple(int(d) for d in op.in_dims),
                  rank=int(op.rank) if is_tn else 0, is_tn=is_tn,
                  device=torch.device(dev).type)


def struct_in_rank(x) -> int:
    """The structured-input rank exactly as the carry-sweep planner sees
    it: max TT bond rank (boundary 1s included) or the CP component rank."""
    if isinstance(x, (TTTensor, BatchedTTTensor)):
        return int(max(x.ranks))
    return int(x.rank)


def group_signature(op, payloads, *, bucket: bool = True) -> StructureSig:
    """The `StructureSig` a coalesced `project_many` group will dispatch.

    Computes, without materializing the batch, the padded shape `many.py`
    produces for a homogeneous payload list: batch rows bucketed to
    `pow2ceil(n, 8)`, TT interior bond ranks / CP component ranks bucketed
    per position to powers of two. The serve engine plans with it, so its
    tick hits the plan-cache entry the coalesced dispatch resolves.
    """
    del op
    payloads = list(payloads)
    if not payloads:
        raise ValueError("group_signature needs at least one payload")
    tags = {structure_tag(p) for p in payloads}
    if len(tags) > 1:
        raise ValueError(
            f"group_signature needs a structurally homogeneous group, got "
            f"{sorted(tags)}; split by structure_tag first")
    tag = tags.pop()
    b = pow2ceil(len(payloads), 8) if bucket else len(payloads)
    if tag == "dense":
        return StructureSig(structure="dense", batch=b)
    if tag == "tt":
        per_pos = [max(p.ranks[i] for p in payloads)
                   for i in range(len(payloads[0].ranks))]
        if bucket:
            per_pos = ([per_pos[0]] + [pow2ceil(r) for r in per_pos[1:-1]]
                       + [per_pos[-1]])
        return StructureSig(structure="tt", batch=b, in_rank=max(per_pos))
    r = max(int(p.rank) for p in payloads)
    return StructureSig(structure="cp", batch=b,
                        in_rank=pow2ceil(r) if bucket else r)


# ---------------------------------------------------------------------------
# the resolver
# ---------------------------------------------------------------------------

def _force_kernel_active() -> bool:
    # local import: dispatch imports this module at module level
    from . import dispatch
    return dispatch.current_stats().force_kernel


def _resolve_route(backend: str, *, supported: bool, on_cuda: bool,
                   force: bool) -> tuple[str, tuple]:
    """(route, rejected) under the backend policy."""
    if not supported:
        return "torch", (("kernel", "no mode-sweep kernel for this "
                          "(family, order): kernels cover tt/cp at "
                          "2 <= N <= MAX_ORDER"),)
    if backend == "kernel":
        return "kernel", (("torch", "backend='kernel' pins the kernel "
                           "route"),)
    if backend == "torch":
        return "torch", (("kernel", "backend='torch' pins the einsum "
                          "route"),)
    if on_cuda:
        return "kernel", (("torch", "'auto' on a CUDA device selects the "
                           "kernel"),)
    if force:
        return "kernel", (("torch", "'auto' under force_kernel() takes the "
                           "kernel route (its plain versions on the CPU)"),)
    return "torch", (("kernel", "'auto' on the CPU takes the einsum route; "
                      "backend='kernel' or force_kernel() runs the kernels' "
                      "plain versions"),)


def _safe_params(family: str, k: int, dims: tuple, rank: int) -> int:
    try:
        return int(theory.params_rp(family, k, dims, max(1, rank)))
    except KeyError:
        return int(k * _prod(dims))  # unknown registered family: dense-eq


def _kernel_name(sig: StructureSig, kind: str, route: str,
                 pipeline: str) -> str:
    if route == "torch":
        return "einsum" if kind == "project" else "einsum_adjoint"
    if sig.structure in ("tt", "cp"):
        return ("carry_sweep_pipelined" if pipeline == "double"
                else "carry_sweep")
    if kind == "reconstruct":
        return "sweep_reconstruct"
    return ("sweep_pipelined" if pipeline == "double"
            else "sweep_project")


def _build_plan(op_sig: _OpSig, sig: StructureSig, kind: str, backend: str,
                pipeline: str, force: bool, key: tuple) -> ExecutionPlan:
    # local import: the kernels package is not a module-level dependency
    # of the rp layer
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.struct import plan as ksplan

    f, k, dims, rank = op_sig.family, op_sig.k, op_sig.dims, op_sig.rank
    order, b = len(dims), int(sig.batch)
    supported = op_sig.is_tn and kops.kernel_order_supported(order)
    route, rejected = _resolve_route(backend, supported=supported,
                                     on_cuda=op_sig.device == "cuda",
                                     force=force)
    params = _safe_params(f, k, dims, rank)
    var = float(theory.variance_factor(f, N=order, R=max(1, rank),
                                       D=_prod(dims)))
    tiles = grid = None
    smem = carry = 0
    if sig.structure in ("tt", "cp"):
        # structured input x TT/CP operator: the carry sweep
        r_in = max(1, sig.in_rank)
        per_item = theory.flops_project_struct(f, sig.structure, k, dims,
                                               max(1, rank), r_in)
        carry = theory.mem_carry_struct(k, max(1, rank), r_in, batch=b)
        if route == "kernel":
            cplan = ksplan.plan_carry_sweep(f, sig.structure, k, b, dims,
                                            rank, r_in, pipeline=pipeline)
            tiles, grid = (cplan.tk, cplan.tb), cplan.grid
            smem = cplan.smem_bytes
            hbm = ksplan.struct_hbm_bytes(cplan)
        else:
            hbm = 4 * (k * ksplan._core_elems(f, dims, max(1, rank))
                       + b * ksplan._core_elems(sig.structure, dims, r_in)
                       + b * k)
    else:
        if op_sig.is_tn:
            per_item = (theory.flops_project_dense_tt(k, dims, max(1, rank))
                        if f == "tt"
                        else theory.flops_project_dense_cp(k, dims,
                                                           max(1, rank)))
        else:
            # flat-vector families: 2 flops per stored parameter per item
            per_item = 2 * params
        if route == "kernel":
            kplan = kops.plan_contraction(f, kind, k, b, dims, rank,
                                          pipeline=pipeline)
            tiles = (kplan.tk, kplan.tb, kplan.ba, kplan.tc)
            grid = kplan.grid
            smem = kplan.smem_bytes
            hbm = kops.sweep_hbm_bytes(kplan)
        else:
            hbm = 4 * (b * _prod(dims) + params + b * k)
    kernel = _kernel_name(sig, kind, route, pipeline)
    if kind == "reconstruct":
        chunk_policy = "folded" if route == "kernel" else "honored"
    else:
        chunk_policy = "n/a"
    plan_id = hashlib.blake2s(repr(key).encode(), digest_size=6).hexdigest()
    return ExecutionPlan(
        plan_id=plan_id, family=f, structure=sig.structure, kind=kind,
        order=order, k=k, batch=b, dims=dims, rank=rank,
        in_rank=int(sig.in_rank), backend=backend, route=route,
        kernel=kernel, pipeline=pipeline, device=op_sig.device,
        chunk=sig.chunk, chunk_policy=chunk_policy, tiles=tiles, grid=grid,
        rejected=rejected,
        cost=CostLedger(flops=int(b * per_item), hbm_bytes=int(hbm),
                        smem_bytes=int(smem), wire_bytes=0, params=params,
                        var_factor=var),
        carry_bytes=int(carry))


def plan_execution(op_spec, structure_sig: StructureSig | None = None, *,
                   kind: str = "project", backend: str = "auto",
                   pipeline: str = "serial",
                   device: str | None = None) -> ExecutionPlan:
    """Resolve (or fetch from the LRU cache) the `ExecutionPlan` for one
    execution of `op_spec` (an operator, or a `ProjectorSpec` planned for
    `device`) against `structure_sig` (defaults to one dense payload).
    Whether a `force_kernel()` scope is active in this context is part of
    the cache key."""
    validate_backend(backend)
    validate_pipeline(pipeline)
    if kind not in ("project", "reconstruct"):
        raise ValueError(f"unknown kind {kind!r}; expected "
                         "('project', 'reconstruct')")
    sig = structure_sig if structure_sig is not None else StructureSig()
    if (kind == "reconstruct") != (sig.structure == "sketch"):
        raise ValueError(
            f"kind={kind!r} does not take structure={sig.structure!r}: "
            "reconstruct plans take 'sketch' signatures, projects the rest")
    op_sig = _op_signature(op_spec, device)
    if sig.structure in ("tt", "cp") and not op_sig.is_tn:
        raise ValueError(
            f"structured ({sig.structure!r}) execution plans exist for "
            f"tt/cp operators only, got family {op_sig.family!r}")
    force = _force_kernel_active()
    key = (op_sig, sig, kind, backend, pipeline, force)
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        _PLAN_CACHE.move_to_end(key)
        _CACHE_STATS.hits += 1
        return cached
    plan = _build_plan(op_sig, sig, kind, backend, pipeline, force, key)
    _CACHE_STATS.builds += 1
    _PLAN_CACHE[key] = plan
    while len(_PLAN_CACHE) > _CACHE_CAP:
        _PLAN_CACHE.popitem(last=False)
        _CACHE_STATS.evictions += 1
    return plan


# ---------------------------------------------------------------------------
# signature builders used by dispatch (operator + concrete input -> sig)
# ---------------------------------------------------------------------------

def dense_signature(op, xt) -> StructureSig:
    """Signature of a COERCED dense input `(*batch, *op.in_dims)`."""
    n = len(tuple(op.in_dims))
    return StructureSig(structure="dense",
                        batch=int(_prod(xt.shape[:-n])) if xt.ndim > n else 1)


def struct_signature(op, x) -> StructureSig:
    """Signature of a structured (TT/CP-format) input, single or batched."""
    del op
    batch = (int(x.batch)
             if isinstance(x, (BatchedTTTensor, BatchedCPTensor)) else 1)
    return StructureSig(structure=structure_tag(x), batch=batch,
                        in_rank=struct_in_rank(x))


def sketch_signature(op, y, chunk: int | None = None) -> StructureSig:
    """Signature of a reconstruct input `(*batch, k)`."""
    del op
    return StructureSig(structure="sketch",
                        batch=int(_prod(y.shape[:-1])) if y.ndim > 1 else 1,
                        chunk=chunk)


# ---------------------------------------------------------------------------
# execution: the plan's route, run (owns every kernels import)
# ---------------------------------------------------------------------------

def execute_plan(plan: ExecutionPlan, op, x):
    """Run one planned execution on a coerced dense array, a structured
    container, or a sketch."""
    if plan.kind == "reconstruct":
        return _exec_reconstruct(plan, op, x)
    if plan.structure in ("tt", "cp"):
        return _exec_struct_project(plan, op, x)
    return _exec_dense_project(plan, op, x)


def _exec_dense_project(plan: ExecutionPlan, op, xt):
    if plan.route == "torch":
        return op.project(xt)
    from repro_torch.kernels import ops as kops
    kern = kops.tt_project if plan.family == "tt" else kops.cp_project
    n = plan.order
    if xt.ndim <= n + 1:  # single input / one batch axis
        return kern(op, xt, pipeline=plan.pipeline)
    batch = xt.shape[:-n]
    flat = xt.reshape((-1,) + tuple(xt.shape[-n:]))
    return kern(op, flat, pipeline=plan.pipeline).reshape(batch + (op.k,))


def _exec_struct_project(plan: ExecutionPlan, op, x):
    from repro_torch.kernels import struct as kstruct
    if plan.route == "kernel":
        return kstruct.struct_project(op, x, pipeline=plan.pipeline)
    return kstruct.struct_project(op, x, use_kernel=False)


def _exec_reconstruct(plan: ExecutionPlan, op, y):
    if plan.route == "kernel":
        # chunk_policy='folded': the kernel tiles k itself, no dense
        # (D, k) intermediate exists
        from repro_torch.kernels import ops as kops
        kern = (kops.tt_reconstruct if plan.family == "tt"
                else kops.cp_reconstruct)
        if y.ndim <= 2:
            return kern(op, y)
        out = kern(op, y.reshape(-1, op.k))
        return out.reshape(y.shape[:-1] + tuple(op.in_dims))
    if y.ndim == 1 or plan.family not in _TN_FAMILIES:
        # the flat families' streamed adjoint takes a batch of sketches
        return op.reconstruct(y, chunk=plan.chunk)
    rows = [op.reconstruct(r, chunk=plan.chunk) for r in y.reshape(-1, op.k)]
    return torch.stack(rows).reshape(y.shape[:-1] + tuple(op.in_dims))


# ---------------------------------------------------------------------------
# explain
# ---------------------------------------------------------------------------

def explain(op, x, *, kind: str = "project", backend: str = "auto",
            pipeline: str = "serial",
            chunk: int | None = None) -> ExecutionPlan:
    """The `ExecutionPlan` that `rp.project` / `rp.reconstruct` would
    resolve for `(op, x)`, with its rejected alternatives. Pure: nothing
    executes, but the plan lands in the cache the dispatch reads. `x` may
    be anything `project` takes, or for kind='reconstruct' a sketch.
    Mirrors dispatch: a structured input under a flat-vector operator
    densifies, so it is explained as the dense plan it executes."""
    if kind == "reconstruct":
        y = torch.as_tensor(x)
        return plan_execution(op, sketch_signature(op, y, chunk),
                              kind="reconstruct", backend=backend)
    if isinstance(x, STRUCT_TYPES):
        if _op_signature(op).is_tn:
            return plan_execution(op, struct_signature(op, x),
                                  backend=backend, pipeline=pipeline)
        batch = (int(x.batch)
                 if isinstance(x, (BatchedTTTensor, BatchedCPTensor)) else 1)
        return plan_execution(op, StructureSig(structure="dense",
                                               batch=batch),
                              backend=backend, pipeline=pipeline)
    from .dispatch import _coerce_dense
    xt = _coerce_dense(op, x)
    return plan_execution(op, dense_signature(op, xt), backend=backend,
                          pipeline=pipeline)


# ---------------------------------------------------------------------------
# update (fused unsketch+EF+AdamW)
# ---------------------------------------------------------------------------

def plan_update(op_spec, batch: int, *, fused: bool = True) -> ExecutionPlan:
    """The `ExecutionPlan` of one fused unsketch+EF+AdamW launch (K4) over
    `batch` buckets, or of the UNFUSED reconstruct -> EF -> AdamW chain
    when `fused=False` (the same reconstruct plan, nine extra dense passes
    in the ledger). `cost.hbm_bytes` is the analytic traffic
    (`fused_hbm_bytes` / `unfused_hbm_bytes`); `smem_bytes` the product
    kernel's shared memory per block. Cached with the other plans."""
    from repro_torch.kernels import fused_update as kfused

    op_sig = _op_signature(op_spec)
    if not op_sig.is_tn:
        raise ValueError(
            f"plan_update needs a tt/cp operator (the fused kernel IS the "
            f"reconstruct sweep), got family {op_sig.family!r}")
    sig = StructureSig(structure="sketch", batch=int(batch))
    kind = "update" if fused else "update-unfused"
    key = (op_sig, sig, kind, "kernel", "serial")
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        _PLAN_CACHE.move_to_end(key)
        _CACHE_STATS.hits += 1
        return cached
    f, k, dims, rank = op_sig.family, op_sig.k, op_sig.dims, op_sig.rank
    fplan = kfused.plan_fused_update(f, k, int(batch), dims, rank)
    hbm = (kfused.fused_hbm_bytes(fplan) if fused
           else kfused.unfused_hbm_bytes(fplan))
    per_item = (theory.flops_project_dense_tt(k, dims, max(1, rank))
                if f == "tt"
                else theory.flops_project_dense_cp(k, dims, max(1, rank)))
    plan = ExecutionPlan(
        plan_id=hashlib.blake2s(repr(key).encode(),
                                digest_size=6).hexdigest(),
        family=f, structure="sketch", kind=kind, order=len(dims), k=k,
        batch=int(batch), dims=dims, rank=rank, in_rank=0, backend="kernel",
        route="kernel" if fused else "torch",
        kernel="fused_update" if fused else "unfused_chain",
        pipeline="serial", device=op_sig.device, chunk=None,
        chunk_policy="folded",
        tiles=(fplan.tk, fplan.tb, fplan.ba, fplan.tc),
        grid=fplan.grid,
        rejected=((("torch", "fused path requested: the dense gradient "
                    "estimate is never stored"),) if fused
                  else (("kernel", "unfused chain requested for "
                         "comparison"),)),
        cost=CostLedger(
            flops=int(batch) * int(per_item), hbm_bytes=int(hbm),
            smem_bytes=int(fplan.smem_bytes), wire_bytes=0,
            params=_safe_params(f, k, dims, rank),
            var_factor=float(theory.variance_factor(
                f, N=len(dims), R=max(1, rank), D=_prod(dims)))))
    _CACHE_STATS.builds += 1
    _PLAN_CACHE[key] = plan
    while len(_PLAN_CACHE) > _CACHE_CAP:
        _PLAN_CACHE.popitem(last=False)
        _CACHE_STATS.evictions += 1
    return plan


def collective_wire_bytes(*, sync: str, wire: str, sketch_bytes: int,
                          dense_bytes: int, n_buckets: int,
                          n_leaves: int) -> int:
    """Per-step pod-link payload of the compressed all-reduce, the plan
    layer's wire ledger (`SketchCompressor.wire_bytes` reads it):
    'sketch-mean' syncs the (nb, k) sketch, 'local-mean' the dense tree;
    int8 payloads carry their float32 scales (one per bucket row under
    'sketch-mean', one per leaf under 'local-mean')."""
    payload = sketch_bytes if sync == "sketch-mean" else dense_bytes
    if wire == "fp32":
        return int(payload)
    scales = n_buckets if sync == "sketch-mean" else n_leaves
    return int(payload) // 4 + 4 * int(scales)


__all__ = [
    "BACKENDS", "CostLedger", "ExecutionPlan", "PlanCacheStats",
    "StructureSig", "clear_plan_cache", "collective_wire_bytes",
    "dense_signature", "execute_plan",
    "explain", "group_signature", "plan_cache_stats", "plan_execution",
    "plan_update", "pow2ceil", "sketch_signature", "struct_in_rank",
    "struct_signature", "structure_tag", "validate_backend",
    "validate_pipeline",
]
