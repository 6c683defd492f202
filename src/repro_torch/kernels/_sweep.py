"""The mode-sweep kernels K1 (`sweep_project`), K5
(`sweep_project_pipelined`) and K2 (`sweep_reconstruct`).

Python side of the hand-written CUDA kernels in `csrc/`: the build and
load of every kernel source listed in `SOURCES`, and for the mode sweeps
the argument checks, output and scratch allocation, and the launch
counters. Counterpart of the Pallas machinery in `repro/kernels/_sweep.py`;
`tt_sweep.py` / `cp_sweep.py` add the family core layouts.

Each kernel source is compiled at first use by `nvcc` for `sm_90a` into a
shared library with a plain C interface under the repository's `build/`
directory (named by a digest of the sources and flags, so an edited source
is rebuilt), and loaded with `ctypes`.

Beside each kernel sits its plain PyTorch version: the planner's einsum
program run step by step with `torch.einsum`, exactly the Pallas kernel
body. A wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .ops import (MAX_ORDER, MAX_RANK, ContractionPlan, _reconstruct_steps,
                  program_codes)

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = {"sweep_project": "sweep_project.cu",
           "sweep_reconstruct": "sweep_reconstruct.cu",
           "carry_sweep": "carry_sweep.cu",
           "fused_update": "fused_update.cu"}
_HEADERS = ("sweep_common.cuh", "sweep_fold.cuh", "sweep_stage.cuh",
            "sweep_reconstruct.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # x, y, m_scratch, part_scratch, cores, dims, fold ops, order, B, K, R,
    # tile_m, tile_k, tile_a, tile_t, groups, m_slots, smem_bytes, scale,
    # stream (K5: the same)
    "sweep_project": [_P, _P, _P, _P, ctypes.POINTER(_P), ctypes.POINTER(_I),
                      ctypes.POINTER(_I)] + [_I] * 11 + [ctypes.c_float, _P],
    # y, out, m_scratch, cores, dims, ops, order, B, K, R, tile_m, tile_k,
    # tile_a, tile_t, smem_bytes, scale, stream
    "sweep_reconstruct": [_P, _P, _P, ctypes.POINTER(_P), ctypes.POINTER(_I),
                          ctypes.POINTER(_I)] + [_I] * 9
                         + [ctypes.c_float, _P],
    # y, scal, p, w, m, v, resid, w_out, m_out, v_out, m_scratch, cores,
    # dims, ops, order, B, K, R, tile_m, tile_k, tile_a, tile_t,
    # smem_bytes, scale, b1, 1-b1, b2, 1-b2, eps, wd, stream
    "fused_update": [_P] * 11 + [ctypes.POINTER(_P), ctypes.POINTER(_I),
                                 ctypes.POINTER(_I)] + [_I] * 9
                    + [ctypes.c_float] * 7 + [_P],
}
# K4's block form: the same, then size, n_d, inner, lo, hi (int64)
_ARGTYPES["fused_update_block"] = (_ARGTYPES["fused_update"][:-1]
                                   + [ctypes.c_longlong] * 5 + [_P])
# its two-dim form: then n_b, inner_b, lo_b, hi_b of the second split dim
_ARGTYPES["fused_update_block2"] = (_ARGTYPES["fused_update_block"][:-1]
                                    + [ctypes.c_longlong] * 4 + [_P])
_ARGTYPES["sweep_project_pipelined"] = _ARGTYPES["sweep_project"]
# the source of an entry not named like it
_ENTRY_SOURCE = {"sweep_project_pipelined": "sweep_project",
                 "fused_update_block": "fused_update",
                 "fused_update_block2": "fused_update"}
_FNS: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernels "
                           "are built on first use and need the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    """Where the shared library of kernel source `name` is built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + _HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile the named kernel sources (all by default) with one `nvcc`
    per source, all started together; returns each source's compiler
    output (`-Xptxas -v`: registers, shared memory, spills). A library
    already built from the same sources is reused with its saved log."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs, procs = {}, {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            logs[name] = out.with_suffix(".log").read_text()
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name} "
                               f"(exit {proc.returncode}):\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        logs[name] = log
    return logs


def _launcher(entry: str, source: str | None = None, argtypes=None):
    """The C entry `<entry>_launch` of kernel source `source` (default: the
    source named like the entry), built and loaded at first use."""
    fn = _FNS.get(entry)
    if fn is None:
        source = _ENTRY_SOURCE.get(entry, entry) if source is None else source
        build([source])
        fn = getattr(ctypes.CDLL(str(lib_path(source))), f"{entry}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[entry] if argtypes is None else argtypes
        _FNS[entry] = fn
    return fn


def _check(kind: str, a: torch.Tensor, cores, plan: ContractionPlan) -> None:
    """Raise on what the kernels do not take: dtype, device, layout,
    shapes."""
    if plan.kind != kind or len(cores) != plan.order:
        raise ValueError(f"{kind} sweep got a {plan.kind!r} plan of order "
                         f"{plan.order} and {len(cores)} cores")
    want = ((plan.b,) + plan.dims if kind == "project"
            else (plan.b, plan.k))
    if tuple(a.shape) != want:
        raise ValueError(f"{kind} sweep input has shape {tuple(a.shape)}, "
                         f"plan expects {want}")
    for t in (a,) + tuple(cores):
        if t.dtype != torch.float32:
            raise TypeError(f"mode-sweep kernels take float32, got {t.dtype}")
        if t.device != a.device:
            raise ValueError(f"operands on {t.device} and {a.device}")
        if not t.is_contiguous():
            raise ValueError("mode-sweep kernels take contiguous operands")
    for c in cores:
        if c.shape[0] != plan.k:
            raise ValueError(f"core of shape {tuple(c.shape)} does not lead "
                             f"with k = {plan.k}")


def _cuda_only(a: torch.Tensor, name: str) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors (its plain version "
                         f"on CPU tensors), got a {a.device.type} tensor")


def _pointers(tensors):
    return (_P * MAX_ORDER)(*[t.data_ptr() for t in tensors])


def _ints(values):
    return (_I * MAX_ORDER)(*[int(v) for v in values])


# ---------------------------------------------------------------------------
# K1: project
# ---------------------------------------------------------------------------

def sweep_project_plain(x: torch.Tensor, *cores: torch.Tensor, steps,
                        scale: float) -> torch.Tensor:
    """The project program step by step with `torch.einsum`: x (B, *dims)
    and the cores in kernel layout -> (B, k)."""
    z = x
    for spec, g in zip(steps, reversed(cores)):
        z = torch.einsum(spec, z, g)
    return z * scale


def _fold_plain(cores, plan: ContractionPlan) -> torch.Tensor:
    """The transfer block m (k, R, T): the reconstruct program's m steps,
    the fold that K1, K5, K2 and K4 launch."""
    m_steps = _reconstruct_steps(plan.family, plan.order)[0]
    m = cores[-1]
    if m_steps[0] is not None:
        m = torch.einsum(m_steps[0], m)
    for spec, g in zip(m_steps[1:], reversed(cores[1:-1])):
        m = torch.einsum(spec, g, m)
    return m.reshape(plan.m_scratch_shape)


def sweep_project_tiled_plain(x: torch.Tensor, *cores: torch.Tensor,
                              plan: ContractionPlan,
                              scale: float) -> torch.Tensor:
    """K1's and K5's schedule in torch ops, block by block: the fold
    through the reconstruct program's m steps; for every (k tile, batch
    tile, group) block, each T-chunk of the group, each slab of `ba`
    leading indices, the operator tile S = sum_u g1 m built and contracted
    with the input slab into the block's partial; then the partials summed
    in group order. Ragged edges are clipped where the kernel masks them.
    A check of the kernel's index arithmetic on the CPU; no path runs it.
    """
    m = _fold_plain(cores, plan)
    g1, d1, trail = cores[0], plan.dims[0], plan.trail
    xf = x.reshape(plan.b, d1, trail)
    n_k, n_b, groups = plan.grid
    n_chunks = -(-trail // plan.tc)
    cpg = -(-n_chunks // groups)
    part = x.new_zeros(plan.partial_shape)
    for bk in range(n_k):
        k0, k1 = bk * plan.tk, min((bk + 1) * plan.tk, plan.k)
        for bb in range(n_b):
            n0, n1 = bb * plan.tb, min((bb + 1) * plan.tb, plan.b)
            for g in range(groups):
                acc = x.new_zeros((n1 - n0, k1 - k0))
                for c in range(g * cpg, min((g + 1) * cpg, n_chunks)):
                    t0, t1 = c * plan.tc, min((c + 1) * plan.tc, trail)
                    m_chunk = m[k0:k1, :, t0:t1]
                    for a0 in range(0, d1, plan.ba):
                        a1 = min(a0 + plan.ba, d1)
                        s = torch.einsum("iau,iut->iat", g1[k0:k1, a0:a1],
                                         m_chunk)
                        acc += torch.einsum("nat,iat->ni",
                                            xf[n0:n1, a0:a1, t0:t1], s)
                part[g, n0:n1, k0:k1] = acc
    y = part[0]
    for g in range(1, groups):
        y = y + part[g]
    return y * scale


def _launch_project(entry: str, x, cores, plan: ContractionPlan,
                    scale: float) -> torch.Tensor:
    """Launch K1 or K5 (same C signature: fold, product, reduce) and
    return y (B, k)."""
    _cuda_only(x, entry)
    codes = program_codes(plan)
    y = torch.empty((plan.b, plan.k), device=x.device, dtype=torch.float32)
    m = torch.empty(plan.m_scratch_shape, device=x.device,
                    dtype=torch.float32)
    part = torch.empty(plan.partial_shape, device=x.device,
                       dtype=torch.float32)
    # the leading core as (d1, R, k): a slab of it is rows of k-contiguous
    # floats, which the kernel stages 16 bytes at a time
    lead = cores[0].permute(1, 2, 0).contiguous()
    with torch.cuda.device(x.device):
        err = _launcher(entry)(
            x.data_ptr(), y.data_ptr(), m.data_ptr(), part.data_ptr(),
            _pointers((lead,) + tuple(cores[1:])), _ints(plan.dims),
            _ints(codes), plan.order,
            plan.b, plan.k, plan.rank, plan.tb, plan.tk, plan.ba, plan.tc,
            plan.groups, plan.m_slots, plan.smem_bytes, float(scale),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {err} "
                           f"(plan {plan})")
    return y


def sweep_project(x: torch.Tensor, *cores: torch.Tensor,
                  plan: ContractionPlan, scale: float) -> torch.Tensor:
    """K1: y = scale * sweep(x) for x (B, *dims) -> (B, k) float32.

    A CPU tensor takes the plain version; a CUDA tensor launches the fold,
    product and reduce kernels (counted once in `sweep_project.launches`)
    or raises.
    """
    _check("project", x, cores, plan)
    if plan.pipeline != "serial":
        raise ValueError(f"sweep_project runs serial plans; a "
                         f"{plan.pipeline!r} plan goes to "
                         "sweep_project_pipelined")
    if x.device.type == "cpu":
        return sweep_project_plain(x, *cores, steps=plan.steps, scale=scale)
    y = _launch_project("sweep_project", x, cores, plan, scale)
    sweep_project.launches += 1
    return y


sweep_project.launches = 0


# ---------------------------------------------------------------------------
# K5: project, double-buffered
# ---------------------------------------------------------------------------

def sweep_project_pipelined_plain(x: torch.Tensor, *cores: torch.Tensor,
                                  steps, ba: int,
                                  scale: float) -> torch.Tensor:
    """K5's slabs with `torch.einsum`: the project program run on each
    slab of `ba` leading indices (input rows and leading-core tile, the
    operands K5 double-buffers), the slabs' outputs summed."""
    y = None
    for a0 in range(0, x.shape[1], ba):
        z = x[:, a0:a0 + ba]
        for spec, g in zip(steps, reversed(cores[1:])):
            z = torch.einsum(spec, z, g)
        z = torch.einsum(steps[-1], z, cores[0][:, a0:a0 + ba])
        y = z if y is None else y + z
    return y * scale


def sweep_project_pipelined(x: torch.Tensor, *cores: torch.Tensor,
                            plan: ContractionPlan,
                            scale: float) -> torch.Tensor:
    """K5: K1's function, with the next slab's input rows and leading-core
    tile (and the next chunk of m where two slots fit) copied by cp.async
    into second shared-memory slots while the current slab contracts. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (counted in
    `sweep_project_pipelined.launches`) or raises."""
    _check("project", x, cores, plan)
    if plan.pipeline != "double":
        raise ValueError(f"sweep_project_pipelined runs 'double' plans, got "
                         f"{plan.pipeline!r}")
    if x.device.type == "cpu":
        return sweep_project_pipelined_plain(x, *cores, steps=plan.steps,
                                             ba=plan.ba, scale=scale)
    y = _launch_project("sweep_project_pipelined", x, cores, plan, scale)
    sweep_project_pipelined.launches += 1
    return y


sweep_project_pipelined.launches = 0


# ---------------------------------------------------------------------------
# K2: reconstruct
# ---------------------------------------------------------------------------

def sweep_reconstruct_plain(y: torch.Tensor, *cores: torch.Tensor, steps,
                            scale: float) -> torch.Tensor:
    """The adjoint program step by step with `torch.einsum`: fold the
    trailing cores into m, graft y onto the leading core, contract."""
    m_steps, h_spec, out_spec = steps
    m = cores[-1]
    if m_steps[0] is not None:
        m = torch.einsum(m_steps[0], m)
    for spec, g in zip(m_steps[1:], reversed(cores[1:-1])):
        m = torch.einsum(spec, g, m)
    h = torch.einsum(h_spec, y, cores[0])
    return torch.einsum(out_spec, h, m) * scale


def sweep_reconstruct_tiled_plain(y: torch.Tensor, *cores: torch.Tensor,
                                  plan: ContractionPlan, scale: float,
                                  epilogue=None):
    """K2's and K4's schedule in torch ops, block by block: the fold; for
    every (slab, batch tile, T-chunk) block in launch order (slab fastest),
    each k-chunk's operator tile S = sum_u g1 m built from the leading-core
    slab and the chunk of m and contracted with the sketch rows into the
    block's accumulator; then the epilogue. `epilogue(index, g)` gets each
    finished tile g = scale * acc and its `index`, three slices (batch
    rows, leading indices, columns of T) into the (B, d1, T) view of the
    output; the default, K2's, stores it, and the function then returns
    the (B, *dims) output (None under another epilogue). Ragged edges are
    clipped where the kernel masks them. A check of the kernel's index
    arithmetic on the CPU; no path runs it.
    """
    m = _fold_plain(cores, plan)
    g1, d1, trail = cores[0], plan.dims[0], plan.trail
    out = None
    if epilogue is None:
        out = y.new_empty((plan.b, d1, trail))

        def epilogue(index, g):
            out[index] = g
    n_slabs, n_b, n_chunks = plan.grid
    for c in range(n_chunks):
        t0, t1 = c * plan.tc, min((c + 1) * plan.tc, trail)
        for bb in range(n_b):
            n0, n1 = bb * plan.tb, min((bb + 1) * plan.tb, plan.b)
            for sl in range(n_slabs):
                a0, a1 = sl * plan.ba, min((sl + 1) * plan.ba, d1)
                acc = y.new_zeros((n1 - n0, a1 - a0, t1 - t0))
                for k0 in range(0, plan.k, plan.tk):
                    k1 = min(k0 + plan.tk, plan.k)
                    s = torch.einsum("iau,iut->iat", g1[k0:k1, a0:a1],
                                     m[k0:k1, :, t0:t1])
                    acc += torch.einsum("ni,iat->nat", y[n0:n1, k0:k1], s)
                epilogue((slice(n0, n1), slice(a0, a1), slice(t0, t1)),
                         acc * scale)
    return None if out is None else out.reshape((plan.b,) + plan.dims)


def _launch_reconstruct(entry: str, head, cores, plan: ContractionPlan,
                        tail) -> None:
    """Launch K2 or K4 (the fold, then the operator-tile product) with the
    plan's tiles: entry(*head, m scratch, cores, dims, opcodes, order, B,
    K, R, tiles, smem_bytes, *tail, stream)."""
    codes = program_codes(plan)
    device = cores[0].device
    m = torch.empty(plan.m_scratch_shape, device=device, dtype=torch.float32)
    # the leading core as (d1, R, k): a slab of it is rows of k-contiguous
    # floats, which the kernel stages 16 bytes at a time
    lead = cores[0].permute(1, 2, 0).contiguous()
    with torch.cuda.device(device):
        err = _launcher(entry)(
            *head, m.data_ptr(), _pointers((lead,) + tuple(cores[1:])),
            _ints(plan.dims), _ints(codes), plan.order, plan.b, plan.k,
            plan.rank, plan.tb, plan.tk, plan.ba, plan.tc, plan.smem_bytes,
            *tail, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {err} "
                           f"(plan {plan})")


def sweep_reconstruct(y: torch.Tensor, *cores: torch.Tensor,
                      plan: ContractionPlan, scale: float) -> torch.Tensor:
    """K2: x_hat = scale * adjoint(y) for y (B, k) -> (B, *dims) float32.

    A CPU tensor takes the plain version; a CUDA tensor launches the fold
    and the operator-tile product (counted once in
    `sweep_reconstruct.launches`) or raises.
    """
    _check("reconstruct", y, cores, plan)
    if y.device.type == "cpu":
        return sweep_reconstruct_plain(y, *cores, steps=plan.steps,
                                       scale=scale)
    _cuda_only(y, "sweep_reconstruct")
    if plan.rank > MAX_RANK:
        raise ValueError(f"sweep_reconstruct holds bond ranks up to "
                         f"{MAX_RANK} per thread, got rank {plan.rank}")
    out = torch.empty((plan.b,) + plan.dims, device=y.device,
                      dtype=torch.float32)
    _launch_reconstruct("sweep_reconstruct", (y.data_ptr(), out.data_ptr()),
                        cores, plan, (float(scale),))
    sweep_reconstruct.launches += 1
    return out


sweep_reconstruct.launches = 0


def reset_launch_counts() -> None:
    """Set K1's, K5's and K2's launch counters to 0."""
    sweep_project.launches = 0
    sweep_project_pipelined.launches = 0
    sweep_reconstruct.launches = 0
