"""Card-only tests of the CUDA kernels K1/K2 against their plain versions.

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

from repro_torch import rp
from repro_torch.kernels import _sweep, ops
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
        rep = replay(server, synth_trace(40, [(spec, 0)], seed=1))
    assert rep["ticks"] == st.kernel_calls
    assert _sweep.sweep_project.launches - before == rep["ticks"]
