"""`pipeline='double'` in repro_torch against repro, on the CPU.

The double-buffered kernels K5 (`sweep_project_pipelined`, dense inputs)
and K6 (`carry_sweep_project_pipelined`, TT/CP-format inputs) run their
plain versions on CPU tensors — the CUDA kernels run only on the card
(tests/test_torch_gpu.py, chip_smoke.py) — and are held against the
reference's pipelined Pallas kernels in interpret mode, as is K6's tile
schedule emulated in torch ops (`carry_sweep_tiled_plain`). Also: the typed
`pipeline=` errors, the planners' charge for the second slot, and the
routing of `rp.project(..., pipeline='double')`.

Tolerance rtol=1e-5, atol=1e-5: float32 on both sides, the same
contraction program summed in different orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import rp as jrp
from repro.core import sample_cp_rp as j_sample_cp
from repro.core import sample_tt_rp as j_sample_tt
from repro.kernels import ops as jops
from repro.kernels import struct as jstruct
from repro_torch import rp
from repro_torch.core import from_numpy_operator
from repro_torch.kernels import _sweep, ops
from repro_torch.kernels import struct
from repro_torch.kernels.struct import plan as splan

from test_torch_struct import (PAIRINGS, _items, _stack,
                               check_tiled_schedule)

RTOL = ATOL = 1e-5
ORDER_SHAPES = {2: (8, 8), 3: (4, 8, 8), 4: (4, 4, 4, 8), 5: (2, 3, 4, 3, 4)}


def _close(got, want):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _pair(family, dims, k=20, rank=3, seed=0):
    sampler = j_sample_tt if family == "tt" else j_sample_cp
    jop = sampler(jax.random.PRNGKey(seed), dims, k, rank)
    arrays = jop.cores if family == "tt" else jop.factors
    return jop, from_numpy_operator(family, [np.asarray(a) for a in arrays],
                                    "cpu")


@pytest.mark.parametrize("family", ["tt", "cp"])
@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_k5_matches_reference_pipelined_kernel(family, order):
    dims = ORDER_SHAPES[order]
    jop, top = _pair(family, dims)
    x = np.random.default_rng(order).standard_normal((5,) + dims,
                                                     dtype=np.float32)
    jproj = jops.tt_project if family == "tt" else jops.cp_project
    proj = ops.tt_project if family == "tt" else ops.cp_project
    want = np.asarray(jproj(jop, jnp.asarray(x), pipeline="double"))
    _close(proj(top, torch.from_numpy(x), pipeline="double"), want)
    _close(proj(top, torch.from_numpy(x[3]), pipeline="double"), want[3])
    _close(proj(top, torch.from_numpy(x)), want)            # K1 agrees


@pytest.mark.parametrize("pair", PAIRINGS, ids="x".join)
@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_k6_matches_reference_pipelined_kernel(pair, order):
    """Batched (B=5, rank-ragged, CP weights on even orders) and single."""
    of, inf = pair
    dims = ORDER_SHAPES[order]
    jop, top = _pair(of, dims)
    jb, tb = _stack(inf, _items(inf, dims, 5, seed=order,
                                weights=order % 2 == 0))
    want = jstruct.struct_project(jop, jb, interpret=True, pipeline="double")
    _close(struct.struct_project(top, tb, pipeline="double"), want)
    _close(struct.struct_project(top, tb[1], pipeline="double"), want[1])


@pytest.mark.parametrize("pair", PAIRINGS, ids="x".join)
@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_k6_tiled_schedule_matches_reference_pipelined_kernel(pair, order):
    """K6's schedule (`carry_sweep_tiled_plain` on double plans: batch
    tiles inside a k tile, whole modes) against the reference's
    interpret-mode pipelined kernel, B in {1, 3, 8}, with the planner's
    plan and one that splits each pair over threads."""
    check_tiled_schedule(pair, order, "double")


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_pipeline_errors_match_reference():
    assert ops.PIPELINES == jops.PIPELINES
    assert ops.validate_pipeline("double") == "double"
    assert (_message(lambda: ops.validate_pipeline("triple"))
            == _message(lambda: jops.validate_pipeline("triple")))
    assert (_message(lambda: ops.plan_contraction(
        "tt", "reconstruct", 64, 4, (4, 8, 8), 3, pipeline="double"))
        .split(":")[0] == _message(lambda: jops.plan_contraction(
            "tt", "reconstruct", 64, 4, (4, 8, 8), 3, pipeline="double"))
        .split(":")[0])
    _, top = _pair("tt", (4, 8, 8))
    jop, _ = _pair("tt", (4, 8, 8))
    x = torch.zeros(4, 8, 8)
    assert (_message(lambda: rp.project(top, x, pipeline="dbl"))
            == _message(lambda: jrp.project(jop, jnp.zeros((4, 8, 8)),
                                            pipeline="dbl")))
    with pytest.raises(ValueError, match="unknown pipeline"):
        rp.plan_execution(top, pipeline="async")
    with pytest.raises(ValueError, match="unknown pipeline"):
        struct.struct_project(top, _items("tt", (4, 8, 8), 1, 0)[0][1],
                              pipeline="Double")
    with pytest.raises(ValueError, match="unknown pipeline"):
        ops.tt_project(top, x, pipeline="")


@pytest.mark.parametrize("family", ["tt", "cp"])
@pytest.mark.parametrize("dims", [(64, 64, 64), (8, 128, 64), (12, 20),
                                  (4, 4, 4, 4, 4, 4)],
                         ids=lambda d: "x".join(map(str, d)))
def test_double_plans_charge_the_second_slot(family, dims):
    for k, b, rank in [(512, 64, 5), (512, 8, 25), (37, 3, 3)]:
        p5 = ops.plan_contraction(family, "project", k, b, dims, rank,
                                  pipeline="double")
        assert p5.pipeline == "double" and p5.smem_bytes <= 232_448
        args = (p5.tb, p5.tk, p5.ba, p5.tc, rank)
        assert p5.smem_bytes == ops.project_smem_bytes(*args, "double",
                                                       p5.m_slots)
        assert p5.smem_bytes > ops.project_smem_bytes(*args)
        if p5.m_slots == 2:     # the second m chunk fits beside the rest
            assert p5.smem_bytes <= ops.SMEM_BUDGET_BYTES // 2 - 1024
        if (family, dims, rank) == ("tt", (8, 128, 64), 25):
            # one k-row of the interior TT(25) core is 320 KB: K6, which
            # holds a k-tile's operator cores in shared memory, refuses it
            with pytest.raises(ValueError, match="shared memory"):
                splan.plan_carry_sweep(family, "tt", k, b, dims, rank, 4,
                                       pipeline="double")
            continue
        # K6 holds every operator mode whole and two input slots of every
        # mode; K3 with the same tiles two slots of one chunk of one mode
        p6 = splan.plan_carry_sweep(family, "tt", k, b, dims, rank, 4,
                                    pipeline="double")
        same = splan.carry_smem_bytes(dataclasses.replace(p6,
                                                          pipeline="serial"))
        assert p6.smem_bytes > same and p6.smem_bytes <= 232_448


@pytest.mark.parametrize("family", ["tt", "cp"])
def test_rp_project_double_routes_k5_and_k6(family):
    dims = (4, 8, 8)
    jop, top = _pair(family, dims)
    x = np.random.default_rng(1).standard_normal((6,) + dims,
                                                 dtype=np.float32)
    _, xb = _stack("cp", _items("cp", dims, 4, seed=2))
    jxb, _ = _stack("cp", _items("cp", dims, 4, seed=2))
    dense = rp.explain(top, torch.from_numpy(x), backend="kernel",
                       pipeline="double")
    structured = rp.explain(top, xb, backend="kernel", pipeline="double")
    assert (dense.kernel, structured.kernel) == ("sweep_pipelined",
                                                 "carry_sweep_pipelined")
    assert dense.pipeline == structured.pipeline == "double"
    assert rp.explain(top, xb, backend="torch",
                      pipeline="double").kernel == "einsum"
    with rp.dispatch_stats() as st:
        _close(rp.project(top, torch.from_numpy(x), backend="kernel",
                          pipeline="double"),
               jrp.project(jop, jnp.asarray(x), backend="pallas",
                           pipeline="double"))
        _close(rp.project(top, xb, backend="kernel", pipeline="double"),
               jrp.project(jop, jxb, backend="pallas", pipeline="double"))
    assert st.kernel_calls == 2


def test_kernel_wrappers_refuse_the_other_schedule():
    _, top = _pair("tt", (4, 8, 8))
    cores = ops.tt_cores_squeezed(top)
    x = torch.zeros(2, 4, 8, 8)
    serial = ops.plan_contraction("tt", "project", 20, 2, (4, 8, 8), 3)
    double = ops.plan_contraction("tt", "project", 20, 2, (4, 8, 8), 3,
                                  pipeline="double")
    with pytest.raises(ValueError, match="sweep_project_pipelined"):
        _sweep.sweep_project(x, *cores, plan=double, scale=1.0)
    with pytest.raises(ValueError, match="'double' plans"):
        _sweep.sweep_project_pipelined(x, *cores, plan=serial, scale=1.0)
    meta = torch.empty((2, 4, 8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        _sweep.sweep_project_pipelined(
            meta, *[torch.empty(c.shape, device="meta") for c in cores],
            plan=double, scale=1.0)
