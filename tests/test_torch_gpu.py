"""Card-only tests of the CUDA kernels K1/K2/K3/K4/K5/K6 against their
plain versions, of the fused training step that runs K4, and of the LM
decode path on the card (the in-place cache, the slot server's CUDA
graph, the MoE dispatch on CUDA and inside that graph, the recurrent
families' graphed servers and whisper's graphed decode step).

Marked `gpu`; the `cuda` fixture skips them where no CUDA device is
present (decided inside the fixture, never at import or collection, so
every pytest-xdist worker collects the same tests). On the card run:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: max|kernel - plain| / max|plain| <= 1e-4 — both fp32, summed in
different orders.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch import kernels, rp
from repro_torch.core import random_cp, random_tt, stack_ragged_cp, \
    stack_ragged_tt
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels import _sweep, ops
from repro_torch.kernels import fused_update as fused
from repro_torch.kernels.struct import carry
from repro_torch.kernels.struct import plan as splan
from repro_torch.kernels.struct.ops import _in_operands, struct_rank
from repro_torch.serve import (ServeConfig, SketchServer, SketchStore,
                               replay, synth_trace)

pytestmark = pytest.mark.gpu
SHAPES = [(12, 20), (6, 10, 14), (4, 6, 5, 7), (3, 4, 5, 3, 6)]
HP = dict(alpha=0.9, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def _operands(family, dims, k, rank, device):
    op = rp.make_projector(rp.ProjectorSpec(family, k, dims, rank), 3,
                           device=device)
    cores = ops.tt_cores_squeezed(op) if family == "tt" else op.factors
    return op, tuple(c.contiguous() for c in cores)


@pytest.mark.parametrize("family", ["tt", "cp"])
@pytest.mark.parametrize("dims", SHAPES, ids=lambda d: "x".join(map(str, d)))
def test_kernels_match_plain_versions(cuda, family, dims):
    k, rank, b = 37, 3, 3
    _, cores = _operands(family, dims, k, rank, cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((b,) + dims, generator=g, device=cuda)
    y = torch.randn((b, k), generator=g, device=cuda)
    for kind, a, fn, plain in (
            ("project", x, _sweep.sweep_project, _sweep.sweep_project_plain),
            ("reconstruct", y, _sweep.sweep_reconstruct,
             _sweep.sweep_reconstruct_plain)):
        plan = ops.plan_contraction(family, kind, k, b, dims, rank)
        got = fn(a, *cores, plan=plan, scale=1 / math.sqrt(k))
        ref = plain(a, *cores, steps=plan.steps, scale=1 / math.sqrt(k))
        assert _rel(got, ref) <= 1e-4


def test_server_tick_launches_k1_once(cuda):
    spec = rp.ProjectorSpec("tt", 64, (8, 16, 16), rank=3)
    server = SketchServer(ServeConfig(max_batch=8), SketchStore(spec),
                          device=cuda)
    before = _sweep.sweep_project.launches
    with rp.dispatch_stats() as st:
        rep = replay(server, synth_trace(40, [(spec, 0)], mix=(1, 0, 0),
                                         seed=1))
    assert rep["ticks"] == st.kernel_calls
    assert _sweep.sweep_project.launches - before == rep["ticks"]


@pytest.mark.parametrize("family", ["tt", "cp"])
@pytest.mark.parametrize("dims", SHAPES, ids=lambda d: "x".join(map(str, d)))
def test_k5_matches_plain_version_and_k1(cuda, family, dims):
    k, rank, b = 37, 3, 3
    _, cores = _operands(family, dims, k, rank, cuda)
    x = torch.randn((b,) + dims, generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    p1 = ops.plan_contraction(family, "project", k, b, dims, rank)
    p5 = ops.plan_contraction(family, "project", k, b, dims, rank,
                              pipeline="double")
    got = _sweep.sweep_project_pipelined(x, *cores, plan=p5, scale=0.5)
    ref = _sweep.sweep_project_pipelined_plain(x, *cores, steps=p5.steps,
                                               ba=p5.ba, scale=0.5)
    assert _rel(got, ref) <= 1e-4
    assert _rel(got, _sweep.sweep_project(x, *cores, plan=p1,
                                          scale=0.5)) <= 1e-4


RAGGED = [((12, 20), 11), ((2, 3, 3, 3, 3, 3, 3, 3), 9), ((5, 7), 25)]


@pytest.mark.parametrize("family", ["tt", "cp"])
@pytest.mark.parametrize("case", RAGGED,
                         ids=lambda c: "x".join(map(str, c[0])) + f"-R{c[1]}")
@pytest.mark.parametrize("b", [1, 3, 64])
def test_k1_k5_ragged_shapes_match_plain_version(cuda, family, case, b):
    """Orders 2 and 8, k = 37 (a ragged k tile), T ragged against every
    chunk, ranks above 8, B in {1, 3, 64}: K1 and K5 against the plain
    program and each other."""
    dims, rank = case
    k = 37
    _, cores = _operands(family, dims, k, rank, cuda)
    x = torch.randn((b,) + dims, generator=torch.Generator(
        device=cuda).manual_seed(5), device=cuda)
    p1 = ops.plan_contraction(family, "project", k, b, dims, rank)
    p5 = ops.plan_contraction(family, "project", k, b, dims, rank,
                              pipeline="double")
    ref = _sweep.sweep_project_plain(x, *cores, steps=p1.steps, scale=0.5)
    y1 = _sweep.sweep_project(x, *cores, plan=p1, scale=0.5)
    y5 = _sweep.sweep_project_pipelined(x, *cores, plan=p5, scale=0.5)
    assert _rel(y1, ref) <= 1e-4 and _rel(y5, ref) <= 1e-4
    assert _rel(y5, y1) <= 1e-4


@pytest.mark.parametrize("family", ["tt", "cp"])
def test_k1_gives_the_same_bits_every_call(cuda, family):
    """No atomics: the partials of the T groups are summed in group order,
    so two calls on the same inputs agree bit for bit (serving shape)."""
    dims, k, rank = (64, 64, 64), 512, 5 if family == "tt" else 25
    _, cores = _operands(family, dims, k, rank, cuda)
    x = torch.randn((64,) + dims, generator=torch.Generator(
        device=cuda).manual_seed(6), device=cuda)
    plan = ops.plan_contraction(family, "project", k, 64, dims, rank)
    assert plan.groups > 1
    first = _sweep.sweep_project(x, *cores, plan=plan, scale=1.0)
    again = _sweep.sweep_project(x, *cores, plan=plan, scale=1.0)
    assert torch.equal(first, again)


@pytest.mark.parametrize("family", ["tt", "cp"])
@pytest.mark.parametrize("case", RAGGED,
                         ids=lambda c: "x".join(map(str, c[0])) + f"-R{c[1]}")
@pytest.mark.parametrize("b", [1, 3, 130])
def test_k2_k4_ragged_shapes_match_plain_version(cuda, family, case, b):
    """Orders 2 and 8, k = 37 (a ragged depth chunk), d1 ragged against
    the slab and T against the chunk (T not a multiple of 4 at (5, 7) and
    order 8), ranks above 8, B in {1, 3, 130} (130: two batch tiles, the
    second of 2 rows): K2 and K4 against their plain versions."""
    dims, rank = case
    k = 37
    op, cores = _operands(family, dims, k, rank, cuda)
    g = torch.Generator(device=cuda).manual_seed(7)
    y = torch.randn((b, k), generator=g, device=cuda)
    plan = ops.plan_contraction(family, "reconstruct", k, b, dims, rank)
    got = _sweep.sweep_reconstruct(y, *cores, plan=plan, scale=0.5)
    ref = _sweep.sweep_reconstruct_plain(y, *cores, steps=plan.steps,
                                         scale=0.5)
    assert _rel(got, ref) <= 1e-4
    p, w, m, v = (torch.randn((b,) + dims, generator=g, device=cuda)
                  for _ in range(4))
    v = v.abs() * 1e-2
    got = fused.fused_update_buckets(op, y, p, w, m, v, 1e-3, 0.3, 0.2,
                                     **HP)
    ref = fused.fused_update_buckets_plain(op, y, p, w, m, v, 1e-3, 0.3,
                                           0.2, **HP)
    for a, r in zip(got, ref):
        assert _rel(a, r) <= 1e-4


@pytest.mark.parametrize("family", ["tt", "cp"])
def test_k2_k4_give_the_same_bits_every_call(cuda, family):
    """Each output element is summed by one thread in one order: two
    calls on the same inputs agree bit for bit (K2 at the serving shape,
    K4 at a leaf of 48 buckets of 32^3)."""
    dims, k, rank = (64, 64, 64), 512, 5 if family == "tt" else 25
    _, cores = _operands(family, dims, k, rank, cuda)
    g = torch.Generator(device=cuda).manual_seed(8)
    y = torch.randn((64, k), generator=g, device=cuda)
    plan = ops.plan_contraction(family, "reconstruct", k, 64, dims, rank)
    first = _sweep.sweep_reconstruct(y, *cores, plan=plan, scale=1.0)
    assert torch.equal(first, _sweep.sweep_reconstruct(y, *cores, plan=plan,
                                                       scale=1.0))
    dims, k, nb = (32, 32, 32), 1024, 48
    op, _ = _operands(family, dims, k, 8, cuda)
    y = torch.randn((nb, k), generator=g, device=cuda)
    dense = [torch.randn((nb,) + dims, generator=g, device=cuda)
             for _ in range(4)]
    dense[3] = dense[3].abs()
    first = fused.fused_update_buckets(op, y, *dense, 1e-3, 0.3, 0.2, **HP)
    again = fused.fused_update_buckets(op, y, *dense, 1e-3, 0.3, 0.2, **HP)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


CARRY_SHAPES = SHAPES + [(2, 3, 2, 3, 2, 2, 3), (2,) * 8, (8, 128, 64)]


@pytest.mark.parametrize("pair", [("tt", "tt"), ("tt", "cp"), ("cp", "tt"),
                                  ("cp", "cp")], ids="x".join)
@pytest.mark.parametrize("dims", CARRY_SHAPES,
                         ids=lambda d: "x".join(map(str, d)))
def test_k3_k6_match_plain_version(cuda, pair, dims):
    """Ragged ranks (2, 3, 4), k not a multiple of the tile, B = 3; in the
    (8, 128, 64) TT(25) case one k-row of an operator core is 320 KB: K3
    stages it a few values of d at a time (five (5, 4) register tiles a
    pair) and K6's planner refuses it."""
    of, inf = pair
    k, b = 37, 3
    rank = 25 if dims == (8, 128, 64) else 3
    op = rp.make_projector(rp.ProjectorSpec(of, k, dims, rank), 3,
                           device=cuda)
    opc = ops.tt_cores_squeezed(op) if of == "tt" else op.factors
    g = torch.Generator(device=cuda).manual_seed(2)
    mk = random_tt if inf == "tt" else random_cp
    st = stack_ragged_tt if inf == "tt" else stack_ragged_cp
    xb = st([mk(g, dims, r) for r in (2, 3, 4)])
    cores = [c.contiguous() for c in (*opc, *_in_operands(inf, xb))]
    ref = carry.carry_sweep_project_plain(
        *cores, n_op=len(opc), program=splan._carry_program(of, inf,
                                                            len(dims)),
        scale=0.25)
    for pipeline, fn in (("serial", carry.carry_sweep_project),
                         ("double", carry.carry_sweep_project_pipelined)):
        if pipeline == "double" and of == "tt" and dims == (8, 128, 64):
            with pytest.raises(ValueError, match="shared memory"):
                splan.plan_carry_sweep(of, inf, k, b, dims, rank,
                                       struct_rank(xb), pipeline=pipeline)
            continue
        plan = splan.plan_carry_sweep(of, inf, k, b, dims, rank,
                                      struct_rank(xb), pipeline=pipeline)
        assert _rel(fn(*cores, n_op=len(opc), plan=plan, scale=0.25),
                    ref) <= 1e-4


def _carry_case(of, inf, dims, k, r_op, ranks, b, device, seed=2):
    """Operator cores then input cores (rank-ragged) and the count of
    operator cores."""
    op = rp.make_projector(rp.ProjectorSpec(of, k, dims, r_op), 3,
                           device=device)
    opc = ops.tt_cores_squeezed(op) if of == "tt" else op.factors
    g = torch.Generator(device=device).manual_seed(seed)
    mk = random_tt if inf == "tt" else random_cp
    st = stack_ragged_tt if inf == "tt" else stack_ragged_cp
    xb = st([mk(g, dims, ranks[i % len(ranks)]) for i in range(b)])
    cores = [c.contiguous() for c in (*opc, *_in_operands(inf, xb))]
    return cores, len(opc), struct_rank(xb)


def _split(plan):
    """`plan` with each pair on 2 d-parts of threads and, where its carry
    has more than one register tile, half as many tile threads as tiles
    (a thread owns two), an interior TT operator core staged one tile of
    bond rows a chunk, ragged 5 x 2 tiles and 4-value d chunks."""
    p = dataclasses.replace(plan, tps=max(1, plan.n_tiles // 2), tpd=2,
                            tk=5, tb=2, dc=4, uc=plan.ro)
    return dataclasses.replace(p, smem_bytes=splan.carry_smem_bytes(p))


@pytest.mark.parametrize("pair", [("tt", "tt"), ("tt", "cp"), ("cp", "tt"),
                                  ("cp", "cp")], ids="x".join)
@pytest.mark.parametrize("b", [1, 3, 8, 64, 130])
def test_k3_k6_ragged_batches_match_plain_version(cuda, pair, b):
    """k = 37 (ragged against every k tile), B in {1, 3, 8, 64, 130}
    (ragged against every batch tile), TT ranks 2-4 per item, rank-5
    operators: K3 and K6 under the planner's plans and under plans that
    split each pair over 2 d-parts of threads, against the plain
    version."""
    of, inf = pair
    dims = (4, 6, 5, 7)
    cores, n_op, r_in = _carry_case(of, inf, dims, 37, 5, (2, 3, 4), b, cuda)
    ref = carry.carry_sweep_project_plain(
        *cores, n_op=n_op, program=splan._carry_program(of, inf, 4),
        scale=0.25)
    for pipeline, fn in (("serial", carry.carry_sweep_project),
                         ("double", carry.carry_sweep_project_pipelined)):
        plan = splan.plan_carry_sweep(of, inf, 37, b, dims, 5, r_in,
                                      pipeline=pipeline)
        for p in (plan, _split(plan)):
            assert _rel(fn(*cores, n_op=n_op, plan=p, scale=0.25),
                        ref) <= 1e-4


@pytest.mark.parametrize("pair", [("tt", "tt"), ("cp", "tt")], ids="x".join)
@pytest.mark.parametrize("r_op", [3, 5])
def test_k3_k6_order8_rank10_inputs_match_plain_version(cuda, pair, r_op):
    """Order 8 with rank-10 TT inputs (the paper's regime at small k and
    B): three (5, 4) register tiles a pair."""
    of, inf = pair
    dims = (3, 2, 3, 2, 3, 2, 3, 2)
    cores, n_op, r_in = _carry_case(of, inf, dims, 37, r_op, (10,), 5, cuda)
    assert r_in == 10
    ref = carry.carry_sweep_project_plain(
        *cores, n_op=n_op, program=splan._carry_program(of, inf, 8),
        scale=0.5)
    for pipeline, fn in (("serial", carry.carry_sweep_project),
                         ("double", carry.carry_sweep_project_pipelined)):
        plan = splan.plan_carry_sweep(of, inf, 37, 5, dims, r_op, r_in,
                                      pipeline=pipeline)
        assert plan.nf * plan.ri >= 10 and plan.n_tiles > 1
        assert _rel(fn(*cores, n_op=n_op, plan=plan, scale=0.5),
                    ref) <= 1e-4


@pytest.mark.parametrize("pair", [("tt", "tt"), ("tt", "cp"), ("cp", "tt"),
                                  ("cp", "cp")], ids="x".join)
@pytest.mark.parametrize("r_op,ranks", [(16, (16,)), (9, (17, 20, 24))],
                         ids=["bond16", "inputs17-24"])
def test_k3_k6_take_any_bond(cuda, pair, r_op, ranks):
    """Carries of several register tiles (bond-16 operators on rank-16
    inputs; bond-9 operators on inputs of ranks 17-24), k = 37, B = 5,
    under the planner's plans and under `_split` (two tiles a tile
    thread, a TT operator's interior core one tile of bond rows a chunk),
    against the plain version, twice for the same bits."""
    of, inf = pair
    dims = (4, 6, 5)
    cores, n_op, r_in = _carry_case(of, inf, dims, 37, r_op, ranks, 5, cuda)
    ref = carry.carry_sweep_project_plain(
        *cores, n_op=n_op, program=splan._carry_program(of, inf, 3),
        scale=0.25)
    for pipeline, fn in (("serial", carry.carry_sweep_project),
                         ("double", carry.carry_sweep_project_pipelined)):
        plan = splan.plan_carry_sweep(of, inf, 37, 5, dims, r_op, r_in,
                                      pipeline=pipeline)
        assert plan.n_tiles > 1
        for p in (plan, _split(plan)):
            y = fn(*cores, n_op=n_op, plan=p, scale=0.25)
            assert _rel(y, ref) <= 1e-4
            assert torch.equal(y, fn(*cores, n_op=n_op, plan=p, scale=0.25))


@pytest.mark.parametrize("of", ["tt", "cp"])
def test_k3_stages_a_large_tt_core_in_row_chunks(cuda, of):
    """A bond-180 operator: one value of d of a TT operator's interior
    core row does not fit twice in a block, so K3 stages it a chunk of
    bond rows at a time (a CP operator of the same bond needs no
    chunks)."""
    dims = (3, 3, 3)
    cores, n_op, r_in = _carry_case(of, "tt", dims, 8, 180, (2, 3, 4), 3,
                                    cuda)
    plan = splan.plan_carry_sweep(of, "tt", 8, 3, dims, 180, r_in)
    assert (plan.uc < 180) == (of == "tt")
    ref = carry.carry_sweep_project_plain(
        *cores, n_op=n_op, program=plan.program, scale=0.5)
    assert _rel(carry.carry_sweep_project(*cores, n_op=n_op, plan=plan,
                                          scale=0.5), ref) <= 1e-4


@pytest.mark.parametrize("of,r_op", [("tt", 10), ("cp", 100)],
                         ids=["tt10", "cp100"])
@pytest.mark.parametrize("b", [1, 64])
def test_k3_fig1_small_case_shapes(cuda, of, r_op, b):
    """The paper's Fig. 1 small case on the card: modes of 15, k=1024,
    TT(10) / CP(100) operators on unit-norm rank-10 TT inputs, K3 against
    its plain version, twice for the same bits."""
    dims = (15, 15, 15)
    cores, n_op, r_in = _carry_case(of, "tt", dims, 1024, r_op, (10,), b,
                                    cuda, seed=13)
    plan = splan.plan_carry_sweep(of, "tt", 1024, b, dims, r_op, r_in)
    y = carry.carry_sweep_project(*cores, n_op=n_op, plan=plan, scale=1.0)
    ref = carry.carry_sweep_project_plain(*cores, n_op=n_op,
                                          program=plan.program, scale=1.0)
    assert _rel(y, ref) <= 1e-4
    assert torch.equal(y, carry.carry_sweep_project(*cores, n_op=n_op,
                                                    plan=plan, scale=1.0))


@pytest.mark.parametrize("family", ["gaussian", "sparse"])
def test_flat_baselines_stream_their_matrix_on_the_card(cuda, family):
    """The streamed baselines regenerate each block bitwise on the card:
    project and reconstruct against the materialized matrix, over three
    blocks with a ragged last one (fp32, TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = rp.ProjectorSpec(family, 64, (7, 9, 11))
    op = rp.make_projector(spec, 5, device=cuda)
    op = dataclasses.replace(op, block=300)
    a = op.materialize()
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((4, 693), generator=g, device=cuda)
    y = rp.project(op, x)
    assert _rel(y, x @ a.T) <= 1e-5
    assert _rel(rp.reconstruct(op, y), y @ a) <= 1e-5
    assert torch.equal(y, rp.project(op, x))


@pytest.mark.parametrize("pair", [("tt", "tt"), ("tt", "cp"), ("cp", "tt"),
                                  ("cp", "cp")], ids="x".join)
@pytest.mark.parametrize("b", [8, 64])
def test_k3_k6_give_the_same_bits_every_call(cuda, pair, b):
    """The serving shapes (TT(5) / CP(25), k=512, dims 64^3, rank-4
    inputs) at a serve tick's B=8 and at B=64: the partials of a pair's
    threads are summed in a fixed order, so two calls agree bit for bit."""
    of, inf = pair
    r_op = 5 if of == "tt" else 25
    cores, n_op, r_in = _carry_case(of, inf, (64, 64, 64), 512, r_op, (4,),
                                    b, cuda, seed=9)
    for pipeline, fn in (("serial", carry.carry_sweep_project),
                         ("double", carry.carry_sweep_project_pipelined)):
        plan = splan.plan_carry_sweep(of, inf, 512, b, (64, 64, 64), r_op,
                                      r_in, pipeline=pipeline)
        first = fn(*cores, n_op=n_op, plan=plan, scale=1.0)
        assert torch.equal(first, fn(*cores, n_op=n_op, plan=plan,
                                     scale=1.0))
        ref = carry.carry_sweep_project_plain(
            *cores, n_op=n_op, program=plan.program, scale=1.0)
        assert _rel(first, ref) <= 1e-4


def test_mixed_server_ticks_launch_k1_and_k3(cuda):
    spec = rp.ProjectorSpec("cp", 64, (8, 16, 16), rank=4)
    server = SketchServer(ServeConfig(max_batch=8), SketchStore(spec),
                          device=cuda)
    kernels.reset_launch_counts()
    with rp.dispatch_stats() as st:
        rep = replay(server, synth_trace(60, [(spec, 0)], seed=1))
    dense = sum(c for key, c in st.breakdown.items() if key[1] == "dense")
    assert rep["ticks"] == st.kernel_calls
    assert _sweep.sweep_project.launches == dense
    assert carry.carry_sweep_project.launches == rep["ticks"] - dense > 0



@pytest.mark.parametrize("family", ["tt", "cp"])
@pytest.mark.parametrize("dims", SHAPES + [(16, 16, 8)],
                         ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("k,rank", [(37, 3), (64, 11)],
                         ids=["k37-R3", "k64-R11"])
def test_k4_matches_plain_version(cuda, family, dims, k, rank):
    """Ragged B (3); k = 37 (a ragged depth chunk; the sketch and the
    leading core staged 4 bytes at a time) and k = 64 with rank 11 (16
    bytes at a time); m is staged 4 bytes at a time where T is not a
    multiple of 4 ((4, 6, 5, 7), (3, 4, 5, 3, 6)); lr, c1, c2 as device
    scalars, float arguments, or host 0-d tensors."""
    nb = 3
    op, _ = _operands(family, dims, k, rank, cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    y = torch.randn((nb, k), generator=g, device=cuda)
    p, w, m, v = (torch.randn((nb,) + dims, generator=g, device=cuda)
                  for _ in range(4))
    v = v.abs() * 1e-2
    for lr, c1, c2 in ((1e-3, 0.3, 0.2),
                       (torch.tensor(2e-3), torch.tensor(0.19),
                        torch.tensor(0.0975))):
        before = fused.fused_update_buckets.launches
        got = fused.fused_update_buckets(op, y, p, w, m, v, lr, c1, c2, **HP)
        ref = fused.fused_update_buckets_plain(
            op, y, p, w, m, v, torch.as_tensor(lr, device=cuda),
            torch.as_tensor(c1, device=cuda),
            torch.as_tensor(c2, device=cuda), **HP)
        torch.cuda.synchronize()
        assert fused.fused_update_buckets.launches == before + 1
        for a, b in zip(got, ref):
            assert _rel(a, b) <= 1e-4


def test_k4_refuses_what_it_does_not_take(cuda):
    op, _ = _operands("tt", (16, 16, 8), 32, 2, cuda)
    y = torch.zeros((2, 32), device=cuda)
    dense = [torch.zeros((2, 16, 16, 8), device=cuda) for _ in range(4)]
    with pytest.raises(ValueError, match="bucket operand"):
        fused.fused_update_buckets(op, y, dense[0][:1], *dense[1:], 1e-3,
                                   0.1, 0.1, **HP)
    with pytest.raises(ValueError, match="operands on"):
        fused.fused_update_buckets(op, y, dense[0].cpu(), *dense[1:], 1e-3,
                                   0.1, 0.1, **HP)


def test_fused_train_step_launches_k4_per_leaf(cuda):
    """Reduced llama3.2-3b, two fused steps on the card: one K1 and one K4
    launch per leaf (11 leaves) a step; equal to the unfused step."""
    import functools
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import schedule
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compress import SketchCompressor
    model = build_model(reduced(get_config("llama3.2-3b")))
    comp = SketchCompressor(SketchConfig(family="tt", k=1024, rank=8,
                                         bucket_elems=512, dims=(4, 8, 16)))
    kw = dict(compressor=comp, opt=AdamWConfig(clip_norm=None), device=cuda,
              lr_fn=functools.partial(schedule.constant, peak_lr=3e-3))
    shape = ShapeSpec("t", 32, 4, "train")
    fused_step = steps.build_train_step(model, shape, fused_update=True,
                                        **kw)
    unfused_step = steps.build_train_step(model, shape, **kw)
    state = steps.init_train_state(
        model, torch.Generator(device=cuda).manual_seed(0),
        opt=kw["opt"], compressor=comp)
    data = SyntheticLM(DataConfig(vocab=256, seq_len=32, global_batch=4))
    for i in range(2):
        kernels.reset_launch_counts()
        new, met = fused_step(state, data.batch(i))
        torch.cuda.synchronize()
        assert fused.fused_update_buckets.launches == 11
        assert _sweep.sweep_project.launches == 11
        assert _sweep.sweep_reconstruct.launches == 0
        ref, _ = unfused_step(state, data.batch(i))
        for a, b in zip(tree_leaves(new["ef"]["residual"]),
                        tree_leaves(ref["ef"]["residual"])):
            assert _rel(a, b) <= 1e-4
        assert math.isfinite(float(met["loss"]))
        state = new


def test_k2_at_a_training_leaf_matches_plain_version(cuda):
    """K2 at the training slice's leaf shape (TT(8), k=1024, 32^4), as the
    sketched checkpoint codec launches it on restore: 6 buckets against
    the plain version in chunks of 2, and the same bits twice."""
    dims, k, rank, b = (32, 32, 32, 32), 1024, 8, 6
    _, cores = _operands("tt", dims, k, rank, cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    y = torch.randn((b, k), generator=g, device=cuda)
    plan = ops.plan_contraction("tt", "reconstruct", k, b, dims, rank)
    scale = 1.0 / math.sqrt(k)
    got = _sweep.sweep_reconstruct(y, *cores, plan=plan, scale=scale)
    ref = torch.cat([_sweep.sweep_reconstruct_plain(
        y[i:i + 2], *cores, steps=plan.steps, scale=scale)
        for i in range(0, b, 2)])
    assert _rel(got, ref) <= 1e-4
    assert torch.equal(got, _sweep.sweep_reconstruct(y, *cores, plan=plan,
                                                     scale=scale))


def test_async_checkpointer_roundtrips_cuda_tensors(cuda, tmp_path):
    """CUDA leaves (fp32, bf16, int64) through the pinned side-stream
    snapshot and back onto the card bit for bit, and the sketched codec's
    record through K1 (encode) and K2 (decode)."""
    from repro_torch.ckpt import SketchedTreeCodec, checkpointer
    from repro_torch.core.sketch import SketchConfig
    g = torch.Generator(device=cuda).manual_seed(0)
    tree = {"w": torch.randn((300, 70), generator=g, device=cuda),
            "h": torch.randn((33,), generator=g, device=cuda).bfloat16(),
            "n": torch.arange(5, device=cuda),
            "c": torch.tensor(7, dtype=torch.int64)}
    ck = checkpointer.AsyncCheckpointer(tmp_path, keep=2)
    ck.save(1, tree)
    # the snapshot holds the saved tensors, so dropping the caller's
    # references cannot let the allocator reuse them mid-copy
    saved = {k: v.clone() for k, v in tree.items()}
    tree = {k: v + 1 if k != "h" else v for k, v in tree.items()}
    ck.save(2, tree)           # reuses the pinned buffers
    ck.close()
    for step, want_tree in ((1, saved), (2, tree)):
        got, _ = checkpointer.restore(tmp_path, tree, step=step)
        for key, want in want_tree.items():
            assert got[key].device == want.device
            assert torch.equal(got[key], want), (step, key)
    codec = SketchedTreeCodec(SketchConfig(family="tt", k=128, rank=2,
                                           dims=(4, 8, 16),
                                           bucket_elems=512),
                              {"w": tree["w"]})
    kernels.reset_launch_counts()
    rec = codec.encode({"w": tree["w"]}, step=3)
    dec = codec.decode(rec)
    torch.cuda.synchronize()
    assert _sweep.sweep_project.launches == 1
    assert _sweep.sweep_reconstruct.launches == 1
    assert dec["w"].device == tree["w"].device
    assert torch.equal(dec["w"], codec.decode(rec)["w"])


def test_compress_collective_on_one_nccl_pod_equals_compress(cuda):
    """A ("pod",) mesh of one over NCCL: compress_collective under both
    syncs and both wires launches K1 once and K2 once or twice a leaf,
    and at fp32 equals compress bit for bit; the ledger holds one
    all_reduce of the sketch under sketch-mean fp32."""
    import torch.distributed as dist
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compress import SketchCompressor
    from repro_torch.rp import shard
    cfg = SketchConfig(family="tt", k=128, rank=2, dims=(4, 8, 16),
                       bucket_elems=512)
    g = torch.Generator(device=cuda).manual_seed(5)
    grads = {"w": torch.randn((300, 70), generator=g, device=cuda),
             "b": torch.randn((33,), generator=g, device=cuda)}
    state = {"residual": {k: 0.1 * v for k, v in grads.items()}}
    mesh = make_mesh((1,), ("pod",), device=cuda)
    try:
        assert dist.get_backend() == "nccl"
        for sync in ("sketch-mean", "local-mean"):
            for wire in ("fp32", "int8"):
                comp = SketchCompressor(cfg, sync=sync, wire=wire)
                want = comp.compress(grads, state, step=2)
                comp.compress_collective(grads, state, step=2, mesh=mesh)
                shard.collective_ledger().reset()
                kernels.reset_launch_counts()
                got = comp.compress_collective(grads, state, step=2,
                                               mesh=mesh)
                torch.cuda.synchronize()
                assert _sweep.sweep_project.launches == 2
                assert _sweep.sweep_reconstruct.launches == (
                    4 if sync == "sketch-mean" else 2)
                if wire == "fp32":
                    for a, b in zip(tree_leaves(got[:2]),
                                    tree_leaves(want[:2])):
                        assert torch.equal(a, b)
                rows = shard.collective_ledger().table()
                assert sum(r["bytes"] for r in rows) == float(
                    got[2]["wire_bytes"])
                if (sync, wire) == ("sketch-mean", "fp32"):
                    sk = comp._sketcher(grads)
                    assert sk.n_buckets == 43
                    assert [(r["calls"], r["bytes"]) for r in rows] == [
                        (1, sk.sketch_bytes())]
    finally:
        dist.destroy_process_group()


def test_decode_on_the_card_matches_forward(cuda):
    """The reduced gemma2-9b (windows, softcaps, post-block norms, GeGLU)
    on the card: token-by-token decode through the in-place cache equals
    the full forward at fp32 within the reference's 2e-3, and the bf16
    cache holds each written position."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model, transformer
    model = build_model(reduced(get_config("gemma2-9b")))
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, model.cfg.vocab, (2, 24), generator=g,
                         device=cuda)
    cache = model.init_cache(2, 24, dtype=torch.float32, device=cuda)
    dec = []
    for t in range(24):
        lg, cache = model.decode_step(
            params, cache, toks[:, t],
            torch.full((2,), t, dtype=torch.int32, device=cuda),
            compute_dtype=torch.float32)
        dec.append(lg)
    h = transformer.forward_hidden(model.cfg, params, toks,
                                   compute_dtype=torch.float32, remat="none")
    full = transformer._logits(model.cfg, params, h)
    torch.testing.assert_close(torch.stack(dec, 1), full, rtol=2e-3,
                               atol=2e-3)
    assert cache["pos"][:, :, :24].tolist() == [[list(range(24))] * 2] * 2


def test_slot_server_on_the_card_prefill_matches_token_loop(cuda):
    """The batched whole-prompt prefill against the token-by-token loop
    on the card: the same greedy tokens, bit for bit."""
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import Request, SlotServer
    from repro_torch.models import build_model
    model = build_model(reduced(get_config("llama3.2-3b")))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, size=(6 + i % 3,)) for i in range(4)]

    def run(feed_loop):
        srv = SlotServer(model, slots=2, max_seq=32, eos=None, max_gen=5,
                         device=cuda)
        if feed_loop:
            def loop_feed(slot, req):
                logits = None
                for t in req.prompt:
                    tok = srv.cur_tok.copy()
                    tok[slot] = t
                    logits, srv.cache = srv._step(
                        srv.params, srv.cache, torch.tensor(tok, device=cuda),
                        torch.tensor(srv.pos, device=cuda))
                    srv.pos[slot] += 1
                srv.cur_tok[slot] = int(torch.argmax(logits[slot]))
            srv._feed_prompt = loop_feed
        done = srv.run([Request(i, p) for i, p in enumerate(prompts)])
        return {r.rid: r.generated for r in done}

    assert run(False) == run(True)


def test_slot_server_on_the_card_graph_equals_eager(cuda):
    """The server's decode step, captured as a CUDA graph, against the
    eager `decode_step` fed the same calls on a fresh cache of its own
    (the server starts from `init_cache`'s state): the same logits bit
    for bit at every call."""
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import Request, SlotServer
    from repro_torch.models import build_model
    model = build_model(reduced(get_config("gemma2-9b")))
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 256, size=(5 + i % 4,)) for i in range(5)]
    srv = SlotServer(model, slots=2, max_seq=32, eos=None, max_gen=6,
                     device=cuda, params=params)
    fresh = model.init_cache(2, 32, device=cuda)
    assert all(torch.equal(srv.cache[key], fresh[key]) for key in fresh)
    calls, step = [], srv._step

    def recorded(p, cache, tok, pos):
        logits, cache = step(p, cache, tok, pos)
        calls.append((tok.clone(), pos.clone(), logits.clone()))
        return logits, cache
    srv._step = recorded
    assert len(srv.run([Request(i, p) for i, p in enumerate(prompts)])) == 5
    cache = model.init_cache(2, 32, device=cuda)
    zero = torch.zeros((2,), dtype=torch.int32, device=cuda)
    for tok, pos, logits in calls:
        assert torch.equal(model.decode_step(params, cache, tok, pos)[0],
                           logits)
    with pytest.raises(ValueError, match="captured with"):
        step(params, cache, zero, zero)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
def test_moe_ffn_on_the_card_matches_the_cpu(cuda, dtype, tol):
    """`moe_ffn` on CUDA tensors (top-k, the cumulative-sum ranks, the
    scatter with its trash row, the batched experts, the gather) against
    the same call on the CPU, at the published capacity factor 1.25 where
    pairs drop, in 2 groups; within `tol` of the largest |output|."""
    from repro_torch.models import moe
    from repro_torch.models.config import MoESpec
    spec = MoESpec(num_experts=8, top_k=2, d_ff_expert=64)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((96, 32), generator=g)
    ws = [torch.randn(s, generator=g) * w for s, w in (
        ((32, 8), 1.0), ((8, 32, 64), 0.2), ((8, 32, 64), 0.2),
        ((8, 64, 32), 0.2))]
    args = [t.to(dtype) for t in [x] + ws]
    want = moe.moe_ffn(*args, spec, groups=2).float()
    got = moe.moe_ffn(*(t.to(cuda) for t in args), spec, groups=2)
    assert got.dtype == dtype and got.device.type == "cuda"
    assert float((got.float().cpu() - want).abs().max()) <= tol * float(
        want.abs().max())


def test_moe_slot_server_on_the_card_graph_equals_eager(cuda):
    """Reduced mixtral's decode step (the MoE dispatch at full capacity)
    captured as the server's CUDA graph against the eager `decode_step`
    fed the same calls on a fresh cache: the same logits bit for bit, so
    the dispatch captures (no host read inside it)."""
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import Request, SlotServer
    from repro_torch.models import build_model
    model = build_model(reduced(get_config("mixtral-8x22b")))
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 256, size=(5 + i % 4,)) for i in range(5)]
    srv = SlotServer(model, slots=2, max_seq=32, eos=None, max_gen=6,
                     device=cuda, params=params)
    calls, step = [], srv._step

    def recorded(p, cache, tok, pos):
        logits, cache = step(p, cache, tok, pos)
        calls.append((tok.clone(), pos.clone(), logits.clone()))
        return logits, cache
    srv._step = recorded
    assert len(srv.run([Request(i, p) for i, p in enumerate(prompts)])) == 5
    cache = model.init_cache(2, 32, device=cuda)
    for tok, pos, logits in calls:
        assert torch.equal(model.decode_step(params, cache, tok, pos)[0],
                           logits)


def _served_logits(model, params, prompts, cuda, eager: bool):
    """Every decode call's logits of a 2-slot server on the card over the
    prompts (the server's CUDA graph, or `eager` the plain
    `decode_step` on a server of its own)."""
    from repro_torch.launch.serve import Request, SlotServer
    srv = SlotServer(model, slots=2, max_seq=32, eos=None, max_gen=6,
                     device=cuda, params=params)
    step = model.decode_step if eager else srv._step
    calls = []

    def recorded(p, cache, tok, pos):
        logits, cache = step(p, cache, tok, pos)
        calls.append(logits.clone())
        return logits, cache
    srv._step = recorded
    assert len(srv.run([Request(i, p) for i, p in enumerate(prompts)])) == \
        len(prompts)
    return calls


@pytest.mark.parametrize("name", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_recurrent_slot_server_on_the_card_graph_equals_eager(cuda, name):
    """A recurrent model's server: its cache right after the capture
    equals `init_cache` bit for bit (every leaf, the ring buffer's
    EMPTY_POS included), and the graphed server's logits equal an eager
    server's at every call (the slot resets and restores between calls
    run on both)."""
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import SlotServer
    from repro_torch.models import build_model
    model = build_model(reduced(get_config(name)))
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    srv = SlotServer(model, slots=2, max_seq=32, eos=None, max_gen=6,
                     device=cuda, params=params)
    fresh = model.init_cache(2, 32, device=cuda)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(srv.cache),
                                                 tree_leaves(fresh)))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 256, size=(5 + i % 4,)) for i in range(5)]
    graphed = _served_logits(model, params, prompts, cuda, eager=False)
    eager = _served_logits(model, params, prompts, cuda, eager=True)
    assert len(graphed) == len(eager)
    assert all(torch.equal(a, b) for a, b in zip(graphed, eager))


def test_decoder_slot_server_cache_after_capture_equals_init_cache(cuda):
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import SlotServer
    from repro_torch.models import build_model
    model = build_model(reduced(get_config("llama3.2-3b")))
    srv = SlotServer(model, slots=2, max_seq=32, eos=None, max_gen=6,
                     device=cuda)
    fresh = model.init_cache(2, 32, device=cuda)
    assert all(torch.equal(srv.cache[k], fresh[k]) for k in fresh)


def test_whisper_decode_step_on_the_card_graph_equals_eager(cuda):
    """Whisper's decode step (self-attention cache written in place, the
    cross K/V from `build_cross_cache`) captured as a CUDA graph against
    the eager step on a copy of the cache: the same logits bit for bit at
    every step, and decode against `decode_hidden` at fp32 within the
    reference's 2e-3."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model, whisper
    model = build_model(reduced(get_config("whisper-medium")))
    cfg = model.cfg
    g = torch.Generator(device=cuda).manual_seed(0)
    params = model.init(g)
    frames = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=g,
                         device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 12), generator=g, device=cuda,
                         dtype=torch.int32)
    enc = whisper.encode(cfg, params, frames)
    cache = whisper.build_cross_cache(cfg, params, enc,
                                      model.init_cache(2, 12, device=cuda))
    twin = {k: v.clone() for k, v in cache.items()}
    tok = torch.zeros((2,), dtype=torch.int32, device=cuda)
    pos = torch.zeros((2,), dtype=torch.int32, device=cuda)
    model.decode_step(params, cache, tok, pos)          # warm-up
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits, _ = model.decode_step(params, cache, tok, pos)
    for k in ("k", "v"):
        cache[k].copy_(twin[k])
    for t in range(12):
        tok.copy_(toks[:, t])
        pos.fill_(t)
        graph.replay()
        want, _ = model.decode_step(params, twin, toks[:, t], pos.clone())
        assert torch.equal(logits, want), t
    enc32 = whisper.encode(cfg, params, frames, compute_dtype=torch.float32)
    h = whisper.decode_hidden(cfg, params, toks, enc32,
                              compute_dtype=torch.float32)
    full = h @ params["embed"].T
    c32 = whisper.build_cross_cache(
        cfg, params, enc32, model.init_cache(2, 12, dtype=torch.float32,
                                             device=cuda),
        compute_dtype=torch.float32)
    dec = torch.stack([model.decode_step(
        params, c32, toks[:, t], torch.full((2,), t, device=cuda),
        compute_dtype=torch.float32)[0] for t in range(12)], 1)
    torch.testing.assert_close(dec, full, rtol=2e-3, atol=2e-3)


def test_serve_cli_on_the_card_refuses_whisper(cuda, capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--arch", "whisper-medium"])
    assert "encoder-decoder" in capsys.readouterr().err
