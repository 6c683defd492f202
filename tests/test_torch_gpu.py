"""Card-only tests of the CUDA kernels K1/K2/K3/K5/K6 against their plain
versions.

Marked `gpu`; the `cuda` fixture skips them where no CUDA device is
present (decided inside the fixture, never at import or collection, so
every pytest-xdist worker collects the same tests). On the card run:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: max|kernel - plain| / max|plain| <= 1e-4 — both fp32, summed in
different orders.
"""
import math

import pytest
import torch

from repro_torch import kernels, rp
from repro_torch.core import random_cp, random_tt, stack_ragged_cp, \
    stack_ragged_tt
from repro_torch.kernels import _sweep, ops
from repro_torch.kernels.struct import carry
from repro_torch.kernels.struct import plan as splan
from repro_torch.kernels.struct.ops import _in_operands, struct_rank
from repro_torch.serve import (ServeConfig, SketchServer, SketchStore,
                               replay, synth_trace)

pytestmark = pytest.mark.gpu
SHAPES = [(12, 20), (6, 10, 14), (4, 6, 5, 7), (3, 4, 5, 3, 6)]


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
                                               tg=p5.tg, scale=0.5)
    assert _rel(got, ref) <= 1e-4
    assert _rel(got, _sweep.sweep_project(x, *cores, plan=p1,
                                          scale=0.5)) <= 1e-4


CARRY_SHAPES = SHAPES + [(2, 3, 2, 3, 2, 2, 3), (2,) * 8, (8, 128, 64)]


@pytest.mark.parametrize("pair", [("tt", "tt"), ("tt", "cp"), ("cp", "tt"),
                                  ("cp", "cp")], ids="x".join)
@pytest.mark.parametrize("dims", CARRY_SHAPES,
                         ids=lambda d: "x".join(map(str, d)))
def test_k3_k6_match_plain_version(cuda, pair, dims):
    """Ragged ranks (2, 3, 4), k not a multiple of the tile, B = 3; in the
    (8, 128, 64) TT(25) case one k-row of an operator core is 320 KB: K3
    reads it through the caches and K6's planner refuses it."""
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
