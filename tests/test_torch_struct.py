"""repro_torch's structured-input path against repro's, on the CPU.

* The carry programs are diffed string for string against
  `repro.kernels.struct.plan._carry_program`, and lowered to the CUDA
  kernels' opcodes.
* The plain version of K3 (`carry_sweep_project`; K6's is in
  tests/test_torch_pipeline.py) — what the wrapper runs on CPU tensors;
  the CUDA kernels run only on the card (tests/test_torch_gpu.py,
  chip_smoke.py) — are held against `repro.kernels.struct.struct_project`
  with its Pallas kernels in interpret mode, as is the kernels' tile
  schedule emulated in torch ops (`carry_sweep_tiled_plain`).
* The containers, rank padding and the rp layer (`project`,
  `project_many`, `group_signature`, dispatch counts) against `repro`.

Operators are sampled in JAX and carried across; structured inputs are
drawn with numpy and built on both sides from the same arrays.
Tolerance rtol=1e-5, atol=1e-5: float32 on both sides with the same
contraction program, summed in different orders. The tile schedule, which
splits each mode's sum over d between threads, is held at rtol=1e-5 and
atol=1e-5 of the largest output (its rank-5 operators give outputs up to
about 20).
"""
import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import rp as jrp
from repro.core import formats as jf
from repro.core import sample_cp_rp as j_sample_cp
from repro.core import sample_tt_rp as j_sample_tt
from repro.kernels import struct as jstruct
from repro.kernels.struct import plan as jplan
from repro_torch import rp
from repro_torch.core import (BatchedCPTensor, BatchedTTTensor, CPTensor,
                              TTTensor, from_numpy_cp, from_numpy_operator,
                              from_numpy_tt, pad_cp_rank, pad_tt_rank,
                              stack_ragged_cp, stack_ragged_tt)
from repro_torch.kernels import _sweep
from repro_torch.kernels import struct
from repro_torch.kernels.struct import carry, plan as splan

RTOL = ATOL = 1e-5
PAIRINGS = [("tt", "tt"), ("tt", "cp"), ("cp", "tt"), ("cp", "cp")]
ORDER_SHAPES = {2: (8, 8), 3: (4, 8, 8), 4: (4, 4, 4, 8), 5: (2, 3, 4, 3, 4)}


def _close(got, want):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _op_pair(family, dims, k=20, rank=3, seed=0):
    sampler = j_sample_tt if family == "tt" else j_sample_cp
    jop = sampler(jax.random.PRNGKey(seed), dims, k, rank)
    arrays = jop.cores if family == "tt" else jop.factors
    return jop, from_numpy_operator(family, [np.asarray(a) for a in arrays],
                                    "cpu")


def _np_tt(rng, dims, ranks):
    """Cores of a TT tensor with bond ranks `ranks` (r_0..r_N)."""
    return [rng.standard_normal((ranks[n], d, ranks[n + 1]),
                                dtype=np.float32) for n, d in enumerate(dims)]


def _items(family, dims, n, seed, weights=False, ranks=(2, 3, 4)):
    """n structured items of ragged ranks (`ranks` cycled) as
    (reference item, port item) pairs from the same numpy arrays."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        r = ranks[i % len(ranks)]
        if family == "tt":
            cores = _np_tt(rng, dims, [1] + [r] * (len(dims) - 1) + [1])
            out.append((jf.TTTensor(tuple(jnp.asarray(c) for c in cores)),
                        from_numpy_tt(cores, "cpu")))
        else:
            fs = [rng.standard_normal((d, r), dtype=np.float32)
                  for d in dims]
            w = (rng.uniform(0.5, 1.5, r).astype(np.float32) if weights
                 else None)
            out.append((jf.CPTensor(tuple(jnp.asarray(f) for f in fs),
                                    None if w is None else jnp.asarray(w)),
                        from_numpy_cp(fs, w, "cpu")))
    return out


def _stack(family, pairs):
    jst = jf.stack_ragged_tt if family == "tt" else jf.stack_ragged_cp
    st = stack_ragged_tt if family == "tt" else stack_ragged_cp
    return jst([p[0] for p in pairs]), st([p[1] for p in pairs])


# ---------------------------------------------------------------------------
# the carry program and its lowering
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pair", PAIRINGS, ids="x".join)
@pytest.mark.parametrize("order", range(2, 9))
def test_carry_program_matches_reference(pair, order):
    got = splan._carry_program(*pair, order)
    assert got == jplan._carry_program(*pair, order)
    plan = splan.plan_carry_sweep(*pair, 64, 5, (4,) * order, 3, 4)
    assert plan.program == got
    codes = carry.carry_codes(plan)
    assert len(codes) == order and codes[0] == carry.C_FIRST
    assert codes[-1] == codes[1] + 4 if order > 2 else codes[-1] >= 6


def test_carry_lowering_refuses_unknown_strings():
    plan = splan.plan_carry_sweep("tt", "tt", 8, 2, (4, 4, 4), 2, 2)
    bad = list(plan.program)
    bad[1] = ("t", "bkue,kudv->bkdev", "c", "g1")
    with pytest.raises(ValueError, match="no kernel opcode"):
        carry.carry_codes(dataclasses.replace(plan, program=tuple(bad)))
    with pytest.raises(ValueError, match="no kernel lowering"):
        carry.carry_codes(dataclasses.replace(plan, program=plan.program[:3]))


def test_carry_opcodes_agree_with_the_cuda_source():
    text = (pathlib.Path(_sweep.CSRC) / "carry_sweep.cu").read_text()
    enum = {n: int(v) for n, v in re.findall(r"(C_\w+) = (\d+)", text)}
    assert enum == {n: getattr(carry, n) for n in enum} and len(enum) == 9
    assert "carry_sweep" in _sweep.SOURCES
    # the register tiles compiled are the planner's, and so is the bound
    line = re.search(r"#define CARRY_TILES\(X\)(.*?)\n", text).group(1)
    got = tuple(tuple(int(v) for v in t.split(","))
                for t in re.findall(r"X\(([\d, ]+)\)", line))
    assert got == splan.CARRY_TILES
    assert f"#define CARRY_THREADS {splan.CARRY_THREADS}" in text


SHAPES = [(64, 64, 64), (8,) * 8, (128, 128), (16, 32, 24), (4, 6, 4, 8, 4),
          (256, 512)]


@pytest.mark.parametrize("pipeline", ["serial", "double"])
@pytest.mark.parametrize("dims", SHAPES, ids=lambda d: "x".join(map(str, d)))
def test_every_carry_plan_fits_shared_memory(pipeline, dims):
    """Every plan fits one block's shared memory and CARRY_THREADS, cuts
    the carry into compiled register tiles that cover both bonds, owns
    each tile by one tile thread, and sizes its layout by
    `carry_smem_bytes`."""
    for pair in PAIRINGS:
        for k, b, r_op, r_in in [(512, 8, 5, 4), (512, 64, 25, 4),
                                 (512, 64, 5, 10), (37, 3, 3, 4),
                                 (1000, 300, 8, 8), (64, 4, 16, 16),
                                 (37, 5, 5, 17)]:
            plan = splan.plan_carry_sweep(*pair, k, b, dims, r_op, r_in,
                                          pipeline=pipeline)
            assert plan.smem_bytes <= 232_448
            assert plan.smem_bytes == splan.carry_smem_bytes(plan)
            assert (plan.ro, plan.ri) in splan.CARRY_TILES
            assert plan.nv * plan.ro >= r_op and plan.nf * plan.ri >= r_in
            assert 1 <= plan.tps <= plan.n_tiles
            assert plan.single == (plan.tps == plan.n_tiles)
            assert plan.threads == plan.tk * plan.tb * plan.tpp <= 256
            assert 1 <= plan.warps <= 8 and plan.tpd <= splan.MAX_TPD
            assert len(plan.grid) == (1 if pipeline == "double" else 2)
            assert plan.dc in splan.DC_CHOICES
            assert plan.uc % plan.ro == 0 and plan.uc >= min(plan.ro, r_op)


def test_carry_planner_refuses_a_pair_too_big_for_shared_memory():
    """K3 stages a few values of d (and of an interior TT operator core a
    few bond rows) at a time and cuts a large carry into more register
    tiles, so what it refuses is a carry that outgrows a block's shared
    memory; K6 refuses operator cores that outgrow it."""
    # a 256 x 256 carry is 256 KB
    with pytest.raises(ValueError, match="shared memory"):
        splan.plan_carry_sweep("tt", "tt", 64, 4, (4, 4, 4), 256, 256)
    with pytest.raises(ValueError, match="shared memory"):
        splan.plan_carry_sweep("tt", "tt", 64, 4, (4096, 4096), 8, 8,
                               pipeline="double")
    assert splan.plan_carry_sweep("tt", "tt", 64, 4, (4096, 4096), 8,
                                  8).smem_bytes <= 232_448
    # TT(16) x TT(16): four (8, 8) tiles a pair
    plan = splan.plan_carry_sweep("tt", "tt", 64, 4, (8, 8), 16, 16)
    assert (plan.ro, plan.ri, plan.n_tiles, plan.tps) == (8, 8, 4, 4)
    plan = splan.plan_carry_sweep("cp", "tt", 64, 4, (8, 8), 5, 17)
    assert plan.nf * plan.ri >= 17 and plan.single
    assert splan.plan_carry_sweep("cp", "cp", 64, 4, (8, 8), 64,
                                  16).n_tiles == 16
    with pytest.raises(ValueError, match="order"):
        splan.plan_carry_sweep("tt", "tt", 64, 4, (4,) * 9, 2, 2)
    with pytest.raises(ValueError, match="pipeline"):
        splan.plan_carry_sweep("tt", "cp", 64, 4, (4, 4), 2, 2,
                               pipeline="triple")


def test_k6_plan_keeps_a_block_per_sm_at_k512():
    """K6 at the serving shape: about a block per SM (k / 4 = 128 of the
    132) and a full block of threads; its traffic counts the operator once
    and the inputs once per k tile, K3's the operator once per batch tile.
    K3 at a serve tick's B=8 splits each pair over threads to put 8 warps
    an SM on the card; at B=64 a thread runs a whole pair."""
    plan = splan.plan_carry_sweep("tt", "tt", 512, 64, (64, 64, 64), 5, 4,
                                  pipeline="double")
    assert plan.grid[0] >= 128 and plan.threads == 256
    serial = splan.plan_carry_sweep("tt", "tt", 512, 64, (64, 64, 64), 5, 4)
    op_floats, in_floats = 64 * 5 + 5 * 64 * 5 + 5 * 64, 64 * 4 * (1 + 4 + 1)
    assert struct.struct_hbm_bytes(plan) == 4 * (
        512 * op_floats + plan.grid[0] * 64 * in_floats + 64 * 512)
    assert struct.struct_hbm_bytes(serial) == 4 * (
        serial.grid[0] * 512 * op_floats + serial.grid[1] * 64 * in_floats
        + 64 * 512)
    assert serial.tpp == 1 and (serial.ro, serial.ri, serial.n_tiles) == (
        5, 4, 1)
    for of, r_op in (("tt", 5), ("cp", 25)):
        for inf in ("tt", "cp"):
            tick = splan.plan_carry_sweep(of, inf, 512, 8, (64, 64, 64),
                                          r_op, 4)
            assert tick.tpp > 1
            assert 512 * 8 * tick.tpp >= splan.CARRY_TARGET_THREADS
            assert tick.grid[0] * tick.grid[1] >= 128


def test_k6_planner_refuses_an_operator_row_too_big_for_shared_memory():
    # one k-row of the interior TT(25) core over a mode of 128 is 320 KB:
    # K3 stages it a few values of d at a time, K6 would hold it whole
    dims = (8, 128, 64)
    plan = splan.plan_carry_sweep("tt", "tt", 37, 3, dims, 25, 4)
    assert plan.dc < 128 and (plan.ro, plan.ri, plan.tps) == (5, 4, 5)
    with pytest.raises(ValueError, match="operator cores"):
        splan.plan_carry_sweep("tt", "tt", 37, 3, dims, 25, 4,
                               pipeline="double")


def _bonds(family, order, rank, ragged):
    """Bond ranks r_0..r_N: TT boundary 1s around the given interior
    ranks, CP its one rank at every bond."""
    if family == "cp":
        return (rank,) * (order + 1)
    return (1, *ragged[:order - 1], 1)


def _squeezed(family, lead, dims, bonds):
    n = len(dims)
    if family == "cp":
        return [(lead, d, bonds[0]) for d in dims]
    return ([(lead, dims[0], bonds[1])]
            + [(lead, bonds[i], d, bonds[i + 1])
               for i, d in enumerate(dims[1:-1], start=1)]
            + [(lead, bonds[n - 1], dims[-1])])


def _closed_form_flops(of, inf, dims, a, e):
    """Flops per (item, k-row) of each pairing's carry program, step by
    step with the true bonds: a the operator's, e the input's."""
    n = len(dims)
    total = 0
    for m, d in enumerate(dims):
        if of == "tt" and inf == "tt":
            total += (2 * d * a[1] * e[1] if m == 0 else
                      2 * a[m] * e[m] * d * a[m + 1]
                      + 2 * e[m] * d * a[m + 1] * e[m + 1])
        elif of == "tt":
            total += (2 * d * a[1] * e[0] if m == 0 else
                      2 * a[m] * e[0] * d * a[m + 1] + 2 * e[0] * d * a[m + 1])
        elif inf == "tt":
            total += (2 * d * a[0] * e[1] if m == 0 else
                      2 * a[0] * e[m] * d * e[m + 1] + 2 * a[0] * d * e[m + 1])
        else:
            hadamard = 0 if m == 0 else (
                2 * a[0] * e[0] if m == n - 1 else a[0] * e[0])
            total += 2 * d * a[0] * e[0] + hadamard
    return total


@pytest.mark.parametrize("pair", PAIRINGS, ids="x".join)
@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_carry_program_flops_count_the_true_bonds(pair, order):
    of, inf = pair
    dims = ORDER_SHAPES[order]
    k, b = 7, 3
    a = _bonds(of, order, 5, (5,) * 4)
    e = _bonds(inf, order, 4, (2, 4, 3, 2))
    got = splan.carry_program_flops(splan._carry_program(of, inf, order),
                                    _squeezed(of, k, dims, a),
                                    _squeezed(inf, b, dims, e))
    assert got == k * b * _closed_form_flops(of, inf, dims, a, e)


def test_carry_program_flops_at_the_serving_shape():
    # per (item, k-row) at k=512, dims 64^3, TT(5)/CP(25) operators and
    # rank-4 inputs; the boundary bonds of 1 make the TT pairings cost less
    # than the interior-cost figure `theory.flops_project_struct` charges
    want = {("tt", "tt"): 28_672, ("tt", "cp"): 20_992,
            ("cp", "tt"): 92_800, ("cp", "cp"): 38_700}
    dims = (64, 64, 64)
    for (of, inf), flops in want.items():
        r_op = 5 if of == "tt" else 25
        got = splan.carry_program_flops(
            splan._carry_program(of, inf, 3),
            _squeezed(of, 1, dims, _bonds(of, 3, r_op, (r_op,) * 2)),
            _squeezed(inf, 1, dims, _bonds(inf, 3, 4, (4, 4))))
        assert got == flops
    with pytest.raises(ValueError, match="index"):
        splan.carry_program_flops(splan._carry_program("cp", "cp", 2),
                                  [(4, 8, 3), (4, 8, 3)],
                                  [(2, 8, 5), (2, 9, 5)])

# ---------------------------------------------------------------------------
# K3 / K6 plain versions against the reference's Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pair", PAIRINGS, ids="x".join)
@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_carry_sweep_matches_reference_kernels(pair, order, pipeline="serial"):
    """Batched (B=5, rank-ragged, CP weights on even orders) and single.
    tests/test_torch_pipeline.py runs the same check for K6."""
    of, inf = pair
    dims = ORDER_SHAPES[order]
    jop, top = _op_pair(of, dims)
    jb, tb = _stack(inf, _items(inf, dims, 5, seed=order,
                                weights=order % 2 == 0))
    want = jstruct.struct_project(jop, jb, interpret=True, pipeline=pipeline)
    _close(struct.struct_project(top, tb, pipeline=pipeline), want)
    _close(struct.struct_project(top, tb[2], pipeline=pipeline), want[2])


def split_plan(plan):
    """`plan` re-tiled so that each pair runs on 2 d-parts of threads and,
    where its carry has more than one register tile, half as many tile
    threads as tiles (a thread owns two), an interior TT operator core
    staged one tile of bond rows a chunk, in ragged 5 x 2 tiles and
    4-value d chunks."""
    split = dataclasses.replace(plan, tps=max(1, plan.n_tiles // 2), tpd=2,
                                tk=5, tb=2, dc=4, uc=plan.ro)
    assert split.tpp >= 2 and (split.n_tiles == 1 or not split.single)
    return dataclasses.replace(split,
                               smem_bytes=splan.carry_smem_bytes(split))


def check_tiled_schedule(pair, order, pipeline, rank=5, ranks=(2, 3, 4),
                         dims=None, k=37, batches=(1, 3, 8)):
    """The kernels' schedule (`carry_sweep_tiled_plain`) against the
    reference's interpret-mode kernel: TT/CP operators of `rank` (5), `k`
    (37), B in `batches` ({1, 3, 8}: the first items of one batch of 8,
    inputs of the ranks `ranks` cycled, CP weights on even orders), dims
    `dims` (those of ORDER_SHAPES[order]), under the planner's plan and
    under `split_plan`."""
    from repro_torch.kernels.ops import tt_cores_squeezed
    from repro_torch.kernels.struct.ops import _in_operands
    of, inf = pair
    dims = dims or ORDER_SHAPES[order]
    jop, top = _op_pair(of, dims, k=k, rank=rank, seed=order)
    items = _items(inf, dims, 8, seed=order + 30, weights=order % 2 == 0,
                   ranks=ranks)
    want = np.asarray(jstruct.struct_project(jop, _stack(inf, items)[0],
                                             interpret=True,
                                             pipeline=pipeline))
    opc = tt_cores_squeezed(top) if of == "tt" else top.factors
    for b in batches:
        xb = _stack(inf, items[:b])[1]
        cores = [c.contiguous() for c in (*opc, *_in_operands(inf, xb))]
        plan = splan.plan_carry_sweep(of, inf, k, b, dims, rank,
                                      struct.struct_rank(xb),
                                      pipeline=pipeline)
        for p in (plan, split_plan(plan)):
            got = carry.carry_sweep_tiled_plain(*cores, n_op=len(opc),
                                                plan=p, scale=k ** -0.5)
            np.testing.assert_allclose(
                got.numpy(), want[:b], rtol=RTOL,
                atol=ATOL * float(np.abs(want[:b]).max()))


@pytest.mark.parametrize("pair", PAIRINGS, ids="x".join)
@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_carry_tiled_schedule_matches_reference_kernels(pair, order):
    """K3's schedule; tests/test_torch_pipeline.py runs K6's."""
    check_tiled_schedule(pair, order, "serial")


@pytest.mark.parametrize("pipeline", ["serial", "double"])
@pytest.mark.parametrize("pair", PAIRINGS, ids="x".join)
@pytest.mark.parametrize("rank,ranks", [(16, (16,)), (9, (17, 20, 24))],
                         ids=["bond16", "inputs17-24"])
def test_carry_tiled_schedule_takes_any_bond(pipeline, pair, rank, ranks):
    """A carry of several register tiles: operators of bond 16 on rank-16
    inputs, and of bond 9 on inputs of ranks 17-24, at order 3 (dims
    2 x 3 x 4), k = 7, B = 3, under the planner's plan and under
    `split_plan` (two tiles a tile thread, and a TT operator's interior
    core staged one tile of bond rows a chunk)."""
    check_tiled_schedule(pair, 3, pipeline, rank=rank, ranks=ranks,
                         dims=(2, 3, 4), k=7, batches=(3,))


def _warp_per_pair_bytes(of, inf, dims, r_op, r_in, pipeline):
    """Shared memory of a schedule that runs one warp a pair with its
    carry, successor (and TT x TT's temp) in shared memory: K3 with one
    item's whole input mode, K6 with a k-row's operator cores and two
    slots of one item's input cores."""
    def modes(family, rank):
        if family == "cp":
            return [d * rank for d in dims]
        n = len(dims)
        return [(1 if i == 0 else rank) * d * (1 if i == n - 1 else rank)
                for i, d in enumerate(dims)]

    cm = r_op * r_in
    carries = -(-(3 if (of, inf) == ("tt", "tt") else 2) * cm // 4) * 4
    up4 = lambda n: -(-n // 4) * 4  # noqa: E731
    if pipeline == "double":
        return 4 * (up4(sum(modes(of, r_op))) + 2 * up4(sum(modes(inf, r_in)))
                    + carries)
    return 4 * (up4(max(modes(inf, r_in))) + carries)


@pytest.mark.parametrize("pipeline", ["serial", "double"])
@pytest.mark.parametrize("pair", PAIRINGS, ids="x".join)
def test_carry_planner_takes_every_bond_a_warp_per_pair_fits(pipeline, pair):
    """No bond is refused for want of a register tile: wherever one warp a
    pair with its carry in shared memory would fit one block, the planner
    plans the launch (K3 cuts a large carry into more tiles and stages a
    large interior TT core a few bond rows a chunk)."""
    planned = 0
    for dims in [(8, 8), (64, 64, 64), (8, 128, 64), (2,) * 8, (16, 16, 16),
                 (300, 7), (3, 5, 7, 9)]:
        for r_op in (1, 5, 16, 17, 25, 33, 64, 100, 160, 200):
            for r_in in (1, 4, 10, 17, 24, 32, 64, 100):
                if _warp_per_pair_bytes(*pair, dims, r_op, r_in,
                                        pipeline) > 232_448:
                    continue
                plan = splan.plan_carry_sweep(*pair, 64, 4, dims, r_op, r_in,
                                              pipeline=pipeline)
                assert plan.smem_bytes <= 232_448
                planned += 1
    assert planned > 200


def test_carry_wrappers_refuse_what_the_kernels_do_not_take():
    _, top = _op_pair("tt", (4, 8, 8))
    _, xb = _stack("tt", _items("tt", (4, 8, 8), 3, seed=1))
    plan = splan.plan_carry_sweep("tt", "tt", 20, 3, (4, 8, 8), 3, 4)
    from repro_torch.kernels.ops import tt_cores_squeezed
    from repro_torch.kernels.struct.ops import _in_operands
    ops_, ins = tt_cores_squeezed(top), _in_operands("tt", xb)
    cores = [c.contiguous() for c in (*ops_, *ins)]
    with pytest.raises(ValueError, match="'double' plan"):
        carry.carry_sweep_project(*cores, n_op=3, plan=splan.plan_carry_sweep(
            "tt", "tt", 20, 3, (4, 8, 8), 3, 4, pipeline="double"),
            scale=1.0)
    with pytest.raises(ValueError, match="'double' plans"):
        carry.carry_sweep_project_pipelined(*cores, n_op=3, plan=plan,
                                            scale=1.0)
    with pytest.raises(TypeError, match="float32"):
        carry.carry_sweep_project(*[c.double() for c in cores], n_op=3,
                                  plan=plan, scale=1.0)
    with pytest.raises(ValueError, match="input cores"):
        carry.carry_sweep_project(*cores[:3], *[c[:2] for c in cores[3:]],
                                  n_op=3, plan=plan, scale=1.0)
    meta = [torch.empty(c.shape, device="meta") for c in cores]
    with pytest.raises(ValueError, match="CUDA"):
        carry.carry_sweep_project(*meta, n_op=3, plan=plan, scale=1.0)


def test_struct_project_typed_errors_and_fallbacks():
    _, top = _op_pair("cp", (4, 8, 8))
    with pytest.raises(TypeError, match="structured input"):
        struct.struct_project(top, torch.zeros(4, 8, 8))
    with pytest.raises(ValueError, match="in_dims"):
        struct.struct_project(top, _items("tt", (8, 8, 4), 1, 0)[0][1])
    with pytest.raises(TypeError, match="TT/CP operator"):
        struct.struct_project(object(), _items("tt", (4, 8, 8), 1, 0)[0][1])
    # order 1 projects the densified input; order 9 takes the einsum oracles
    jop1, top1 = _op_pair("tt", (12,), k=6)
    jx1, x1 = _items("tt", (12,), 1, 0)[0]
    _close(struct.struct_project(top1, x1), jop1.project(jx1.full()))
    jop9, top9 = _op_pair("cp", (2,) * 9, k=6, rank=2)
    jx9, x9 = _items("cp", (2,) * 9, 1, 0)[0]
    _close(struct.struct_project(top9, x9),
           jstruct.struct_project(jop9, jx9, use_kernel=False))


# ---------------------------------------------------------------------------
# containers and rank padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["tt", "cp"])
def test_containers_and_padding_match_reference(family):
    dims = (4, 6, 5)
    pairs = _items(family, dims, 4, seed=7, weights=True)
    jb, tb = _stack(family, pairs)
    _close(tb.full(), jb.full())
    assert (tb.batch, tb.dims, tb.order) == (jb.batch, jb.dims, jb.order)
    assert tb.num_params() == jb.num_params()
    for (jx, tx), row in zip(pairs, tb.unstack()):
        _close(tx.full(), jx.full())
        _close(row.full(), jx.full())
        _close(tx.norm_squared(), jx.norm_squared())
        assert tx.num_params() == jx.num_params()
    if family == "tt":
        assert tb.ranks == jb.ranks
        jx, tx = pairs[0]
        tgt = (1, 5, 6, 1)
        _close(pad_tt_rank(tx, tgt).full(), jf.pad_tt_rank(jx, tgt).full())
        assert pad_tt_rank(tx, tgt).ranks == tgt
    else:
        assert tb.rank == jb.rank
        _close(tb.weights, jb.weights)
        jx, tx = pairs[0]
        _close(pad_cp_rank(tx, 7).full(), jf.pad_cp_rank(jx, 7).full())
        _close(tx.to_tt().full(), jx.to_tt().full())
        assert tx.to_tt().ranks == jx.to_tt().ranks


def test_padding_refuses_what_the_reference_refuses():
    (jx, tx), = _items("tt", (4, 6, 5), 1, seed=1)
    for fn, t in ((jf.pad_tt_rank, jx), (pad_tt_rank, tx)):
        with pytest.raises(ValueError, match="boundary"):
            fn(t, (2, 4, 4, 1))
        with pytest.raises(ValueError, match="length"):
            fn(t, (1, 4, 1))
        with pytest.raises(ValueError, match="below"):
            fn(t, (1, 1, 4, 1))
    (_, other), = _items("tt", (4, 6, 6), 1, seed=2)
    with pytest.raises(ValueError, match="mismatched dims"):
        stack_ragged_tt([tx, other])
    (jc, tc), = _items("cp", (4, 6, 5), 1, seed=3)
    with pytest.raises(ValueError, match="below"):
        pad_cp_rank(tc, 1)
    with pytest.raises(ValueError, match="mismatched structure"):
        BatchedTTTensor.stack([tx, pad_tt_rank(tx, (1, 5, 5, 1))])
    with pytest.raises(ValueError, match="weighted"):
        BatchedCPTensor.stack([tc, CPTensor(tc.factors, torch.ones(tc.rank))])


def test_random_constructions_are_unit_norm_and_seeded():
    from repro_torch.core import random_cp, random_tt
    for mk in (random_tt, random_cp):
        a = mk(torch.Generator().manual_seed(5), (8,) * 4, 3, norm="unit")
        b = mk(torch.Generator().manual_seed(5), (8,) * 4, 3, norm="unit")
        assert abs(float(a.norm_squared()) - 1.0) < 1e-5
        assert abs(float((a.full() ** 2).sum()) - 1.0) < 1e-4
        parts = a.cores if mk is random_tt else a.factors
        assert all(torch.equal(x, y) for x, y in
                   zip(parts, b.cores if mk is random_tt else b.factors))


# ---------------------------------------------------------------------------
# the rp layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["tt", "cp"])
@pytest.mark.parametrize("backend", ["auto", "kernel", "torch"])
def test_rp_project_structured_matches_reference(family, backend):
    dims = (4, 8, 8)
    jop, top = _op_pair(family, dims)
    pairs = _items("tt", dims, 3, seed=11) + _items("cp", dims, 3, seed=12)
    jbackend = "pallas" if backend == "kernel" else "xla"
    with rp.dispatch_stats() as st, jrp.dispatch_stats() as jst:
        for inf in ("tt", "cp"):
            jb, tb = _stack(inf, pairs[:3] if inf == "tt" else pairs[3:])
            _close(rp.project(top, tb, backend=backend),
                   jrp.project(jop, jb, backend=jbackend))
        jx, tx = pairs[4]
        _close(rp.project(top, tx, backend=backend),
               jrp.project(jop, jx, backend=jbackend))
    assert st.kernel_calls == (3 if backend == "kernel" else 0)
    assert jst.kernel_calls == (3 if backend == "kernel" else 0)
    route = {"kernel": "kernel"}.get(backend, "torch")
    want = {(f, s, {"pallas": "kernel", "xla": "torch"}[r], n): c
            for (f, s, r, n), c in jst.breakdown.items()}
    assert st.breakdown == want
    assert all(key[2] == route for key in st.breakdown)


def test_project_many_mixed_matches_reference():
    dims = (4, 8, 8)
    jop, top = _op_pair("tt", dims)
    rng = np.random.default_rng(13)
    dense = [rng.standard_normal(dims, dtype=np.float32),
             rng.standard_normal(200, dtype=np.float32)]
    tts = _items("tt", dims, 3, seed=14)
    cps = _items("cp", dims, 2, seed=15, weights=True) + _items("cp", dims,
                                                               1, seed=16)
    order = [tts[0], (jnp.asarray(dense[0]), dense[0]), cps[0], tts[1],
             cps[1], (jnp.asarray(dense[1]), dense[1]), tts[2], cps[2]]
    with rp.dispatch_stats() as st, jrp.dispatch_stats() as jst:
        got = rp.project_many(top, [p[1] for p in order], backend="kernel")
        want = jrp.project_many(jop, [p[0] for p in order], backend="pallas")
    _close(got, want)
    assert st.kernel_calls == jst.kernel_calls == 3
    assert sum(st.breakdown.values()) == sum(jst.breakdown.values()) == 3
    # group signatures agree and match what the dispatch resolved
    for idx in ([0, 3, 6], [2, 4, 7], [1, 5]):
        jsig = jrp.group_signature(jop, [order[i][0] for i in idx])
        sig = rp.group_signature(top, [order[i][1] for i in idx])
        assert ((sig.structure, sig.batch, sig.in_rank)
                == (jsig.structure, jsig.batch, jsig.in_rank))
    with pytest.raises(rp.FormatMismatchError, match="batched"):
        rp.project_many(top, [_stack("tt", tts)[1]])


def test_structured_plans_explain_and_hit_the_cache():
    rp.clear_plan_cache()
    _, top = _op_pair("cp", (4, 8, 8))
    _, xb = _stack("tt", _items("tt", (4, 8, 8), 8, seed=17))
    plan = rp.explain(top, xb, backend="kernel", pipeline="double")
    assert plan.kernel == "carry_sweep_pipelined" and plan.in_rank == 4
    assert plan.structure == "tt" and len(plan.grid) == 1
    assert "carry_bytes" in plan.describe() and plan.cost.smem_bytes > 0
    rp.project(top, xb, backend="kernel", pipeline="double")
    stats = rp.plan_cache_stats()
    assert (stats.builds, stats.hits) == (1, 1)
    torch_plan = rp.explain(top, xb)                 # 'auto' on the CPU
    assert torch_plan.route == "torch" and torch_plan.tiles is None
    assert torch_plan.cost.flops == plan.cost.flops
    with pytest.raises(rp.FormatMismatchError, match="in_dims"):
        rp.project(top, _items("cp", (8, 8, 4), 1, 0)[0][1])

    class Foreign:
        k, in_dims = 8, (4, 4)

    with pytest.raises(ValueError, match="tt/cp operators"):
        rp.plan_execution(Foreign(), rp.StructureSig("cp", 8, in_rank=2))
