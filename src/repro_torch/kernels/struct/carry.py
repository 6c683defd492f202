"""The carry-sweep kernels K3 (`carry_sweep_project`) and K6
(`carry_sweep_project_pipelined`).

Python side of the hand-written CUDA kernels in `csrc/carry_sweep.cu`
(built by `_sweep.build`, like every kernel source): argument checks, the
lowering of the carry program to the kernels' per-mode opcodes, the
launches and their counters. Counterpart of the Pallas kernels in
`repro/kernels/struct/carry.py`.

Beside each kernel sits its plain PyTorch version: the planner's carry
program run step by step with `torch.einsum`, exactly the Pallas kernel
body (K6's version sweeps the batch tile by tile, as the kernel does). A
wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .._sweep import _cuda_only, _launcher
from ..ops import MAX_ORDER
from .plan import CarryPlan

# Opcodes of the lowered carry program, one per mode (csrc/carry_sweep.cu
# holds the same values).
C_FIRST = 1
C_MIX_TT_TT, C_MIX_TT_CP, C_MIX_CP_TT, C_MIX_CP_CP = 2, 3, 4, 5
C_LAST_TT_TT, C_LAST_TT_CP, C_LAST_CP_TT, C_LAST_CP_CP = 6, 7, 8, 9

_MIX_CODE = {("tt", "tt"): C_MIX_TT_TT, ("tt", "cp"): C_MIX_TT_CP,
             ("cp", "tt"): C_MIX_CP_TT, ("cp", "cp"): C_MIX_CP_CP}
# The forms each opcode computes: the first step, and the two steps of an
# interior ('mix') and of the last mode, with {n} the mode index.
_FIRST_FORMS = {("tt", "tt"): "kdu,bde->bkue", ("tt", "cp"): "kdu,bdp->bkup",
                ("cp", "tt"): "kdr,bde->bkre", ("cp", "cp"): "kdr,bdp->bkrp"}
_MODE_FORMS = {
    ("tt", "tt"): ((("t", "bkue,kudv->bkedv", "c", "g{n}"),
                    ("c", "bkedv,bedf->bkvf", "t", "x{n}")),
                   (("t", "bkue,kud->bked", "c", "g{n}"),
                    ("c", "bked,bed->bk", "t", "x{n}"))),
    ("tt", "cp"): ((("t", "bkup,kudv->bkpdv", "c", "g{n}"),
                    ("c", "bkpdv,bdp->bkvp", "t", "x{n}")),
                   (("t", "bkup,kud->bkpd", "c", "g{n}"),
                    ("c", "bkpd,bdp->bk", "t", "x{n}"))),
    ("cp", "tt"): ((("t", "bkre,bedf->bkrdf", "c", "x{n}"),
                    ("c", "bkrdf,kdr->bkrf", "t", "g{n}")),
                   (("t", "bkre,bed->bkrd", "c", "x{n}"),
                    ("c", "bkrd,kdr->bk", "t", "g{n}"))),
    ("cp", "cp"): ((("t", "kdr,bdp->bkrp", "g{n}", "x{n}"),
                    ("c", "bkrp,bkrp->bkrp", "c", "t")),
                   (("t", "kdr,bdp->bkrp", "g{n}", "x{n}"),
                    ("c", "bkrp,bkrp->bk", "c", "t"))),
}


def _form(steps, n):
    return tuple(tuple(s.format(n=n) for s in step) for step in steps)


def carry_codes(plan: CarryPlan) -> tuple[int, ...]:
    """Lower the plan's carry program to one kernel opcode per mode.

    Mode 0 must be the pairing's opening contraction, modes 1..N-2 its two
    interior steps and mode N-1 its two closing steps, each string as the
    kernels compute it; anything else raises.
    """
    pair = (plan.op_family, plan.in_family)
    prog, n_modes = plan.program, plan.order
    if pair not in _MIX_CODE or len(prog) != 2 * n_modes - 1:
        raise ValueError(f"carry program {prog!r} has no kernel lowering")
    if prog[0] != ("c", _FIRST_FORMS[pair], "g0", "x0"):
        raise ValueError(f"carry step 0 {prog[0]!r} has no kernel opcode")
    codes = [C_FIRST]
    mix, last = _MODE_FORMS[pair]
    for n in range(1, n_modes):
        closing = n == n_modes - 1
        if tuple(prog[2 * n - 1:2 * n + 1]) != _form(last if closing else mix,
                                                     n):
            raise ValueError(f"carry steps of mode {n} "
                             f"{prog[2 * n - 1:2 * n + 1]!r} have no kernel "
                             "opcode")
        codes.append(_MIX_CODE[pair] + (4 if closing else 0))
    return tuple(codes)


def in_bonds(in_family: str, in_cores, order: int) -> tuple[int, ...]:
    """The input's bond ranks r_0..r_N as the kernels take them: TT from the
    squeezed cores (boundary 1s), CP the component rank at every bond."""
    if in_family == "cp":
        return (int(in_cores[0].shape[2]),) * (order + 1)
    inner = [int(c.shape[1]) for c in in_cores[1:]]
    return (1, *inner, 1)


def _check(cores, n_op: int, plan: CarryPlan) -> tuple[int, ...]:
    """Raise on what the kernels do not take; return the input bonds."""
    op_cores, in_cores = cores[:n_op], cores[n_op:]
    n = plan.order
    if len(op_cores) != n or len(in_cores) != n:
        raise ValueError(f"carry sweep of order {n} got {len(op_cores)} "
                         f"operator and {len(in_cores)} input cores")
    dev = cores[0].device
    for t in cores:
        if t.dtype != torch.float32:
            raise TypeError(f"carry-sweep kernels take float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("carry-sweep kernels take contiguous operands")
    k, b, r, dims = plan.k, plan.b, plan.r_op, plan.dims
    if plan.op_family == "tt":
        want = ([(k, dims[0], r)] + [(k, r, d, r) for d in dims[1:-1]]
                + [(k, r, dims[-1])])
    else:
        want = [(k, d, r) for d in dims]
    got = [tuple(c.shape) for c in op_cores]
    if got != want:
        raise ValueError(f"{plan.op_family} operator cores {got}, the plan "
                         f"expects {want}")
    bonds = in_bonds(plan.in_family, in_cores, n)
    if plan.in_family == "tt":
        want = ([(b, dims[0], bonds[1])]
                + [(b, bonds[i], dims[i], bonds[i + 1])
                   for i in range(1, n - 1)] + [(b, bonds[n - 1], dims[-1])])
    else:
        want = [(b, d, bonds[0]) for d in dims]
    got = [tuple(c.shape) for c in in_cores]
    if got != want:
        raise ValueError(f"{plan.in_family} input cores {got}, the plan "
                         f"expects {want}")
    if max(bonds) > plan.r_in:
        raise ValueError(f"input rank {max(bonds)} above the plan's "
                         f"r_in={plan.r_in}")
    return bonds


def _run(program, op_cores, in_cores):
    env = {}

    def operand(name):
        if name in env:                       # 'c' or 't'
            return env[name]
        idx = int(name[1:])
        return (op_cores if name[0] == "g" else in_cores)[idx]

    for dst, spec, a, b in program:
        env[dst] = torch.einsum(spec, operand(a), operand(b))
    return env["c"]


def carry_sweep_project_plain(*cores: torch.Tensor, n_op: int, program,
                              scale: float) -> torch.Tensor:
    """The carry program step by step with `torch.einsum` -> (B, k)."""
    return _run(program, cores[:n_op], cores[n_op:]) * scale


def carry_sweep_project_pipelined_plain(*cores: torch.Tensor, n_op: int,
                                        program, tb: int,
                                        scale: float) -> torch.Tensor:
    """K6's schedule with `torch.einsum`: the carry program on each batch
    tile of `tb` items against the same operator cores, tiles stacked."""
    op_cores, in_cores = cores[:n_op], cores[n_op:]
    b = in_cores[0].shape[0]
    tiles = [_run(program, op_cores, [x[i:i + tb] for x in in_cores])
             for i in range(0, b, tb)]
    return torch.cat(tiles) * scale


_P, _I = ctypes.c_void_p, ctypes.c_int
# op, in, y, dims, codes, rin, order, B, K, R, op_tt, in_tt, tk, tb,
# smem_bytes, scale, stream
_ARGTYPES = [ctypes.POINTER(_P), ctypes.POINTER(_P), _P, ctypes.POINTER(_I),
             ctypes.POINTER(_I), ctypes.POINTER(_I), _I, _I, _I, _I, _I, _I,
             _I, _I, _I, ctypes.c_float, _P]


def _launch(entry: str, cores, n_op: int, plan: CarryPlan, bonds,
            scale: float) -> torch.Tensor:
    x0 = cores[n_op]
    _cuda_only(x0, entry)
    codes = carry_codes(plan)
    y = torch.empty((plan.b, plan.k), device=x0.device, dtype=torch.float32)

    def ptrs(ts):
        return (_P * MAX_ORDER)(*[t.data_ptr() for t in ts])

    def ints(vs, n=MAX_ORDER):
        return (_I * n)(*[int(v) for v in vs])

    with torch.cuda.device(x0.device):
        err = _launcher(entry, "carry_sweep", _ARGTYPES)(
            ptrs(cores[:n_op]), ptrs(cores[n_op:]), y.data_ptr(),
            ints(plan.dims), ints(codes), ints(bonds, MAX_ORDER + 1),
            plan.order, plan.b, plan.k, plan.r_op,
            int(plan.op_family == "tt"), int(plan.in_family == "tt"),
            plan.tk, plan.tb, plan.smem_bytes, float(scale),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {err} "
                           f"(plan {plan})")
    return y


def carry_sweep_project(*cores: torch.Tensor, n_op: int, plan: CarryPlan,
                        scale: float) -> torch.Tensor:
    """K3: y = scale * carry(op, x) -> (B, k) float32, for the squeezed
    operator cores (`n_op` of them, k leading) then the input cores
    (batch leading). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (counted in `carry_sweep_project.launches`) or
    raises."""
    bonds = _check(cores, n_op, plan)
    if plan.pipeline != "serial":
        raise ValueError(f"carry_sweep_project runs serial plans; a "
                         f"{plan.pipeline!r} plan goes to "
                         "carry_sweep_project_pipelined")
    if cores[0].device.type == "cpu":
        return carry_sweep_project_plain(*cores, n_op=n_op,
                                         program=plan.program, scale=scale)
    y = _launch("carry_sweep_project", cores, n_op, plan, bonds, scale)
    carry_sweep_project.launches += 1
    return y


carry_sweep_project.launches = 0


def carry_sweep_project_pipelined(*cores: torch.Tensor, n_op: int,
                                  plan: CarryPlan,
                                  scale: float) -> torch.Tensor:
    """K6: K3's function with the k-tile's operator cores resident and the
    batch tiles of input cores double-buffered (see `carry_sweep_project`
    for the operands). Counted in
    `carry_sweep_project_pipelined.launches`."""
    bonds = _check(cores, n_op, plan)
    if plan.pipeline != "double":
        raise ValueError(f"carry_sweep_project_pipelined runs 'double' "
                         f"plans, got {plan.pipeline!r}")
    if cores[0].device.type == "cpu":
        return carry_sweep_project_pipelined_plain(
            *cores, n_op=n_op, program=plan.program, tb=plan.tb, scale=scale)
    y = _launch("carry_sweep_project_pipelined", cores, n_op, plan, bonds,
                scale)
    carry_sweep_project_pipelined.launches += 1
    return y


carry_sweep_project_pipelined.launches = 0


def reset_launch_counts() -> None:
    """Set K3's and K6's launch counters to 0."""
    carry_sweep_project.launches = 0
    carry_sweep_project_pipelined.launches = 0
