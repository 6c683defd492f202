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
tensor it launches the kernel or raises. `carry_sweep_tiled_plain` runs
the kernels' own schedule in torch ops (tiles, chunks of d and of
operator rows, threads per pair, padded register tiles, the exchanges
between a pair's threads), a CPU check of their index arithmetic that no
path runs.
"""
from __future__ import annotations

import ctypes
import functools

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


def _as_rows(t: torch.Tensor, family: str, n: int, order: int):
    """A squeezed core (rows leading) as [rows][a][d][c]."""
    if family == "cp" or n == 0:
        return t[:, None]
    return t[..., None] if n == order - 1 else t


# What the emulation reads past a core's bonds: finite and not zero, as
# what a kernel thread reads there, so that only the carry's zero entries
# past the bonds can cancel it.
_PAST_BONDS = 7.0


def _padded(t: torch.Tensor, a: int, c: int) -> torch.Tensor:
    """[rows][a0][d][c0] grown to [rows][a][d][c], `_PAST_BONDS` past the
    bonds."""
    out = t.new_full((t.shape[0], max(a, t.shape[1]), t.shape[2],
                      max(c, t.shape[3])), _PAST_BONDS)
    out[:, :t.shape[1], :, :t.shape[3]] = t
    return out


def carry_sweep_tiled_plain(*cores: torch.Tensor, n_op: int,
                            plan: CarryPlan, scale: float) -> torch.Tensor:
    """K3's (serial plans) or K6's (double plans) schedule in torch ops.

    Block by block (tk k-rows x tb items; K6 walks the batch tiles inside
    a k tile), mode by mode, chunk by chunk (K3: dc values of d, and of an
    interior TT operator core uc bond rows; K6: the whole mode), each
    pair's tps tile threads x tpd d-parts accumulate their output tiles
    (ro x ri of the padded carry; a tile thread owns tiles tps apart) over
    the d values they own (a d-part owns every tpd-th value of a chunk),
    contracting the carry tiles the pairing reads, on cores padded to the
    carry with `_PAST_BONDS` past the bonds. At the end of a mode the
    partial tiles are summed in d-part order into the carry, the entries
    past the bonds set to zero (CP x CP's Hadamard applied), and the last
    mode's partial outputs summed in thread order. Ragged edges are
    clipped where the kernels mask them. A check of the kernels' index
    arithmetic on the CPU; no path runs it.
    """
    op_cores, in_cores = cores[:n_op], cores[n_op:]
    n, of, inf = plan.order, plan.op_family, plan.in_family
    rp, fp = plan.nv * plan.ro, plan.nf * plan.ri
    bonds = in_bonds(inf, in_cores, n)
    ops_, ins = [], []
    for m in range(n):
        first, last = m == 0, m == n - 1
        ops_.append(_padded(_as_rows(op_cores[m], of, m, n),
                            1 if of == "cp" or first else rp,
                            1 if of == "tt" and last else rp))
        ins.append(_padded(_as_rows(in_cores[m], inf, m, n),
                           1 if inf == "cp" or first else fp,
                           1 if inf == "tt" and last else fp))
    y = cores[0].new_zeros((plan.b, plan.k))
    for k0 in range(0, plan.k, plan.tk):
        ks = slice(k0, min(k0 + plan.tk, plan.k))
        for b0 in range(0, plan.b, plan.tb):
            bs = slice(b0, min(b0 + plan.tb, plan.b))
            y[bs, ks] = _tile(plan, [g[ks] for g in ops_],
                              [x[bs] for x in ins], bonds).T * scale
    return y


def _tile(plan, ops_, ins, bonds):
    """One block's pairs, as `carry_sweep_tiled_plain` describes: the
    (tk', tb') outputs of its k-rows `ops_` and items `ins`."""
    n, r, of, inf = plan.order, plan.r_op, plan.op_family, plan.in_family
    ro, ri, nv, nf = plan.ro, plan.ri, plan.nv, plan.nf
    tps, tpd = plan.tps, plan.tpd
    nk, nb = ops_[0].shape[0], ins[0].shape[0]
    c = ops_[0].new_zeros((nk, nb, nv * ro, nf * ri))
    rows = [slice(v * ro, (v + 1) * ro) for v in range(nv)]
    cols = [slice(f * ri, (f + 1) * ri) for f in range(nf)]
    for m in range(n):
        g_all, x_all, dm = ops_[m], ins[m], plan.dims[m]
        kind = "first" if m == 0 else "last" if m == n - 1 else "mix"
        length = dm if plan.pipeline == "double" else min(plan.dc, dm)
        uc = (plan.uc if plan.pipeline == "serial" and of == "tt"
              and kind == "mix" else nv * ro)
        part = {}                     # (tile, d-part) -> partial tile
        ys = [0.0] * plan.tpp         # thread -> partial output
        for d0 in range(0, dm, length):
            dlen = min(length, dm - d0)
            for u0 in range(0, r, uc):
                us = range(u0 // ro, min(nv, -(-min(u0 + uc, r) // ro)))
                for j in range(plan.tpp):
                    ot, p = divmod(j, tpd)
                    ds = torch.arange(d0 + p, d0 + dlen, tpd)
                    g, x = g_all[:, :, ds], x_all[:, :, ds]
                    for o in range(ot, plan.n_tiles, tps):
                        vr, fc = rows[o // nf], cols[o % nf]
                        if kind == "last":
                            ys[j] = ys[j] + _last(of, inf, c[:, :, vr, fc], g,
                                                  x, vr, fc)
                            continue
                        t = _mix(of, inf, kind, c, g, x, vr, fc,
                                 [rows[u] for u in us], cols)
                        part[o, p] = (t if (o, p) not in part
                                      else part[o, p] + t)
        if kind == "last":
            y = ys[0]
            for j in range(1, plan.tpp):
                y = y + ys[j]
            return y
        new = torch.zeros_like(c)
        for o in range(plan.n_tiles):
            s = part[o, 0]
            for p in range(1, tpd):
                s = s + part[o, p]
            new[:, :, rows[o // nf], cols[o % nf]] = s
        if kind == "mix" and (of, inf) == ("cp", "cp"):
            new = c * new
        keep = ((torch.arange(nv * ro) < r)[:, None]
                & (torch.arange(nf * ri) < bonds[m + 1])[None, :])
        c = torch.where(keep, new, 0.0)
    raise AssertionError("unreachable: the last mode returns")


def _mix(of, inf, kind, c, g, x, vr, fc, urows, cols):
    """A thread's partial output tile (rows vr, columns fc) over its d
    values in a first or interior mode, from the carry tiles it reads
    (urows: the operator rows staged in this chunk)."""
    if kind == "first" or (of, inf) == ("cp", "cp"):
        return torch.einsum("kdv,bdf->kbvf", g[:, 0, :, vr], x[:, 0, :, fc])
    t = 0.0
    if (of, inf) == ("tt", "tt"):
        for ur in urows:
            for ec in cols:
                t = t + torch.einsum("kbue,kudv,bedf->kbvf", c[:, :, ur, ec],
                                     g[:, ur, :, vr], x[:, ec, :, fc])
    elif of == "tt":
        for ur in urows:
            t = t + torch.einsum("kbup,kudv,bdp->kbvp", c[:, :, ur, fc],
                                 g[:, ur, :, vr], x[:, 0, :, fc])
    else:
        for ec in cols:
            t = t + torch.einsum("kbre,bedf,kdr->kbrf", c[:, :, vr, ec],
                                 x[:, ec, :, fc], g[:, 0, :, vr])
    return t


def _last(of, inf, c, g, x, vr, fc):
    """A thread's partial output over its d values in the last mode, from
    carry tile (vr, fc)."""
    if of == "tt":
        xe = (x[:, fc, :, 0] if inf == "tt"
              else x[:, 0, :, fc].transpose(1, 2))
        return torch.einsum("kbue,kud,bed->kb", c, g[:, vr, :, 0], xe)
    if inf == "tt":
        return torch.einsum("kbre,bed,kdr->kb", c, x[:, fc, :, 0],
                            g[:, 0, :, vr])
    return torch.einsum("kbrp,kdr,bdp->kb", c, g[:, 0, :, vr],
                        x[:, 0, :, fc])


_P, _I = ctypes.c_void_p, ctypes.c_int
# op, in, y, dims, codes, rin, tiles (tk, tb, tps, tpd, dc, uc, ro, ri,
# r_in, smem_bytes), order, B, K, R, op_tt, in_tt, scale, stream
_ARGTYPES = [ctypes.POINTER(_P), ctypes.POINTER(_P), _P, ctypes.POINTER(_I),
             ctypes.POINTER(_I), ctypes.POINTER(_I), ctypes.POINTER(_I),
             _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]


@functools.lru_cache(maxsize=256)
def _lowered(plan: CarryPlan, bonds: tuple[int, ...]):
    """The launch's constant arguments, built once per (plan, bonds): the
    ctypes arrays of dims, opcodes, input bonds and tiles, and the scalar
    ints."""
    def ints(vs, n):
        return (_I * n)(*[int(v) for v in vs])

    return (ints(plan.dims, MAX_ORDER), ints(carry_codes(plan), MAX_ORDER),
            ints(bonds, MAX_ORDER + 1),
            ints((plan.tk, plan.tb, plan.tps, plan.tpd, plan.dc, plan.uc,
                  plan.ro, plan.ri, plan.r_in, plan.smem_bytes), 10),
            (plan.order, plan.b, plan.k, plan.r_op,
             int(plan.op_family == "tt"), int(plan.in_family == "tt")))


def _launch(entry: str, cores, n_op: int, plan: CarryPlan, bonds,
            scale: float) -> torch.Tensor:
    x0 = cores[n_op]
    _cuda_only(x0, entry)
    dims, codes, rin, tiles, scalars = _lowered(plan, tuple(bonds))
    y = torch.empty((plan.b, plan.k), device=x0.device, dtype=torch.float32)

    def ptrs(ts):
        return (_P * MAX_ORDER)(*[t.data_ptr() for t in ts])

    with torch.cuda.device(x0.device):
        err = _launcher(entry, "carry_sweep", _ARGTYPES)(
            ptrs(cores[:n_op]), ptrs(cores[n_op:]), y.data_ptr(), dims,
            codes, rin, tiles, *scalars, float(scale),
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
