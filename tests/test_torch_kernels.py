"""repro_torch.kernels against repro.kernels, on the CPU.

* The port planner's einsum programs are diffed string for string against
  `repro.kernels.ops.plan_contraction(...).steps`.
* The port's kernel wrappers run their plain versions on CPU tensors (the
  CUDA kernels run only on the card: tests/test_torch_gpu.py and
  chip_smoke.py) and are held against the reference wrappers, whose Pallas
  kernels run in interpret mode. Operators are sampled in JAX and carried
  across; inputs come from numpy.

Tolerance rtol=1e-5, atol=1e-5: float32 on both sides with the same
contraction program; the sum order differs between torch and the Pallas
interpreter, which moves results by a few ulps of the partial sums.
"""
import json
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import rp as jrp
from repro.core import sample_cp_rp as j_sample_cp
from repro.core import sample_tt_rp as j_sample_tt
from repro.kernels import ops as jops
from repro_torch import rp
from repro_torch.core import from_numpy_operator
from repro_torch.kernels import _sweep, ops

RTOL = ATOL = 1e-5
ORDER_SHAPES = {2: (8, 8), 3: (4, 8, 8), 4: (4, 4, 4, 8), 5: (2, 3, 4, 3, 4)}


def _pair(family, dims, k=20, rank=3, seed=0):
    sampler = j_sample_tt if family == "tt" else j_sample_cp
    jop = sampler(jax.random.PRNGKey(seed), dims, k, rank)
    arrays = jop.cores if family == "tt" else jop.factors
    return jop, from_numpy_operator(family, [np.asarray(a) for a in arrays],
                                    "cpu")


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("family", ["tt", "cp"])
@pytest.mark.parametrize("kind", ["project", "reconstruct"])
@pytest.mark.parametrize("order", range(2, 9))
def test_planner_program_matches_reference(family, kind, order):
    dims = (4,) * order
    got = ops.plan_contraction(family, kind, 64, 5, dims, 3)
    want = jops.plan_contraction(family, kind, 64, 5, dims, 3)
    assert got.steps == want.steps
    # and both directions lower to the fold's opcodes, one per
    # transfer-block step of the reconstruct program
    codes = ops.program_codes(got)
    assert len(codes) == order - 1
    assert codes == ops.program_codes(ops.plan_contraction(
        family, "reconstruct", 64, 5, dims, 3))


@pytest.mark.parametrize("family", ["tt", "cp"])
@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_sweep_wrappers_match_reference_kernels(family, order):
    """tt_/cp_project and tt_/cp_reconstruct, batched and unbatched, against
    the reference's Pallas kernels in interpret mode."""
    dims = ORDER_SHAPES[order]
    jop, top = _pair(family, dims)
    rng = np.random.default_rng(order)
    x = rng.standard_normal((3,) + dims, dtype=np.float32)
    y = rng.standard_normal((3, 20), dtype=np.float32)
    jproj = jops.tt_project if family == "tt" else jops.cp_project
    jrec = jops.tt_reconstruct if family == "tt" else jops.cp_reconstruct
    proj = ops.tt_project if family == "tt" else ops.cp_project
    rec = ops.tt_reconstruct if family == "tt" else ops.cp_reconstruct
    want_p = np.asarray(jproj(jop, jnp.asarray(x)))
    _close(proj(top, torch.from_numpy(x)), want_p)
    _close(proj(top, torch.from_numpy(x[1])), want_p[1])
    want_r = np.asarray(jrec(jop, jnp.asarray(y)))
    _close(rec(top, torch.from_numpy(y)), want_r)
    _close(rec(top, torch.from_numpy(y[2])), want_r[2])


@pytest.mark.parametrize("family", ["tt", "cp"])
def test_order_one_takes_the_einsum_route(family):
    jop, top = _pair(family, (12,), k=8)
    x = np.random.default_rng(0).standard_normal((2, 12), dtype=np.float32)
    proj = ops.tt_project if family == "tt" else ops.cp_project
    _close(proj(top, torch.from_numpy(x)), jop.project(jnp.asarray(x)))
    plan = rp.explain(top, torch.from_numpy(x), backend="kernel")
    assert plan.route == "torch"
    assert "2 <= N <= MAX_ORDER" in plan.rejected[0][1]


SHAPES = [(64, 64, 64), (128, 128), (8, 128, 64), (4, 4, 4, 4, 4, 4, 4, 4),
          (32, 16, 16), (256, 1024)]


@pytest.mark.parametrize("family", ["tt", "cp"])
@pytest.mark.parametrize("dims", SHAPES, ids=lambda d: "x".join(map(str, d)))
def test_every_planned_tile_fits_shared_memory(family, dims):
    for kind in ("project", "reconstruct"):
        for b, k, rank in [(1, 512, 5), (8, 512, 25), (64, 512, 25),
                           (300, 100, 2), (64, 4096, 16)]:
            plan = ops.plan_contraction(family, kind, k, b, dims, rank)
            assert plan.smem_bytes <= ops.SMEM_BUDGET_BYTES
            if kind == "project":
                assert plan.tb in [16 * t for t in ops.PROJECT_TM]
                assert plan.tk in ops.PROJECT_TILE_K
                assert plan.tc in ops.PROJECT_TILE_T
                assert 1 <= plan.ba <= dims[0] and plan.m_slots == 1
                assert plan.smem_bytes == ops.project_smem_bytes(
                    plan.tb, plan.tk, plan.ba, plan.tc, rank)
                # every group holds a chunk of T; the grid fills the card
                # twice over unless T runs out of chunks first
                n_chunks = -(-plan.trail // plan.tc)
                per = -(-n_chunks // plan.groups)
                assert (plan.groups - 1) * per < n_chunks
                nk, nb, groups = plan.grid
                assert nk * nb * groups >= min(2 * ops.H100_SMS,
                                               nk * nb * n_chunks)
                # the batch tile is the smallest that holds the batch
                assert plan.tb >= min(b, 128) and (plan.tb == 16
                                                   or plan.tb - 16 < b)
            else:
                assert plan.tb in [16 * t for t in ops.RECON_TM]
                assert plan.tb >= min(b, 128) and (plan.tb == 16
                                                   or plan.tb - 16 < b)
                assert plan.tk in ops.RECON_TILE_K
                assert plan.tc in ops.RECON_TILE_T
                assert plan.ba * plan.tc == ops.RECON_TILE_N
                assert plan.smem_bytes == ops.recon_smem_bytes(
                    plan.tb, plan.tk, plan.ba, plan.tc, rank)
                # the grid covers the output once: slabs x batch tiles x
                # chunks, none of them empty
                n_slabs, n_b, n_chunks = plan.grid
                assert (n_slabs - 1) * plan.ba < dims[0] <= n_slabs * plan.ba
                assert (n_b - 1) * plan.tb < b <= n_b * plan.tb
                assert ((n_chunks - 1) * plan.tc < plan.trail
                        <= n_chunks * plan.tc)


@pytest.mark.parametrize("rank", [1, 5, 8, 25, 64])
@pytest.mark.parametrize("b", [1, 48, 376])
def test_reconstruct_plans_fit_and_prefer_two_blocks_an_sm(rank, b):
    """Every reconstruct plan up to MAX_RANK fits the block budget, two
    blocks an SM where any tiling does; the chunk and slab take the fewest
    blocks, then the squarest ba x tc."""
    for dims in [(32, 32, 32, 32), (64, 64, 64), (2, 3, 3, 3, 3, 3, 3, 3),
                 (12, 20), (256, 1024)]:
        plan = ops.plan_contraction("tt", "reconstruct", 1024, b, dims, rank)
        assert plan.smem_bytes <= ops.SMEM_BUDGET_BYTES
        def smem(tk, tc):
            return ops.recon_smem_bytes(plan.tb, tk, ops.RECON_TILE_N // tc,
                                        tc, rank)

        half = ops.SMEM_BUDGET_BYTES // 2 - 1024
        limit = ops.SMEM_BUDGET_BYTES
        if any(smem(tk, tc) <= half for tk in ops.RECON_TILE_K
               for tc in ops.RECON_TILE_T):
            limit = half
        assert plan.smem_bytes <= limit
        # no chunk width that fits the same limit at this depth takes
        # fewer blocks
        blocks = math.prod(plan.grid[::2])
        for tc in ops.RECON_TILE_T:
            if smem(plan.tk, tc) <= limit:
                ba = ops.RECON_TILE_N // tc
                assert blocks <= -(-dims[0] // ba) * -(-plan.trail // tc)
    w_gate = ops.plan_contraction("tt", "reconstruct", 1024, 48,
                                  (32, 32, 32, 32), 8)
    assert (w_gate.ba, w_gate.tc, w_gate.tb) == (8, 16, 48)


def test_planner_refuses_a_last_core_row_too_big_for_shared_memory():
    """The fold holds a rank-vector per thread: a rank above MAX_RANK is
    refused with a typed error; a shape whose smallest tiling outgrows the
    block budget raises too."""
    with pytest.raises(ops.RankLimitError, match="MAX_RANK"):
        ops.plan_contraction("cp", "project", 64, 4, (2, 8192),
                             ops.MAX_RANK + 1)
    assert issubclass(ops.RankLimitError, ValueError)
    ops.plan_contraction("cp", "project", 64, 4, (2, 8192), ops.MAX_RANK)
    with pytest.raises(ValueError, match="shared memory"):
        ops.plan_contraction("cp", "project", 64, 4, (2, 8192), 16,
                             budget=16 * 1024)


# (dims, B, k, rank): T = prod(d2..dN) ragged against every T-chunk, B
# against the batch tiles (1, 3, 17 in 32 rows, 70 in 96), k against the
# k tiles (130: two tiles, the second of 2 rows), ranks above 8
TILED_CASES = {2: ((12, 20), 3, 37, 3), 3: ((6, 10, 14), 1, 130, 12),
               4: ((4, 6, 5, 7), 70, 37, 3),
               8: ((2, 3, 3, 3, 3, 3, 3, 3), 17, 37, 9)}


# (dims, B, k, rank) for the reconstruct schedule: d1 ragged against the
# slabs and T against the chunks at every order, B against the batch tiles
# (3 in 16 rows, 130 in two tiles of 128, the second of 2 rows, 70 in 96,
# 17 in 32), k against the depth chunks (37: the second chunk of 5 rows;
# 130), ranks above 8
RECON_TILED_CASES = {2: ((12, 20), 3, 37, 3), 3: ((6, 10, 14), 130, 37, 12),
                     4: ((7, 6, 5, 7), 70, 130, 3),
                     8: ((5, 3, 3, 2, 2, 2, 2, 2), 17, 37, 9)}


@pytest.mark.parametrize("family", ["tt", "cp"])
@pytest.mark.parametrize("order", sorted(RECON_TILED_CASES))
def test_reconstruct_tiled_schedule_matches_reference_and_plain(family,
                                                               order):
    """K2's block schedule (fold, slabs x batch tiles x T-chunks, depth
    chunks, operator tiles built from the leading-core slab and the chunk
    of m, the product into each block's tile) emulated in torch ops,
    against the reference's interpret-mode kernel and the plain program:
    within 1e-5 of max|ref| (fp32, other summation order)."""
    dims, b, k, rank = RECON_TILED_CASES[order]
    jop, top = _pair(family, dims, k=k, rank=rank, seed=order)
    cores = [c.contiguous() for c in (ops.tt_cores_squeezed(top)
                                      if family == "tt" else top.factors)]
    y = np.random.default_rng(order).standard_normal((b, k),
                                                     dtype=np.float32)
    plan = ops.plan_contraction(family, "reconstruct", k, b, dims, rank)
    assert plan.trail % plan.tc and dims[0] % plan.ba and k % plan.tk
    assert math.prod(plan.grid) > 1
    got = _sweep.sweep_reconstruct_tiled_plain(
        torch.from_numpy(y), *cores, plan=plan, scale=1 / math.sqrt(k))
    jrec = jops.tt_reconstruct if family == "tt" else jops.cp_reconstruct
    want = np.asarray(jrec(jop, jnp.asarray(y)))
    plain = _sweep.sweep_reconstruct_plain(torch.from_numpy(y), *cores,
                                           steps=plan.steps,
                                           scale=1 / math.sqrt(k)).numpy()
    for ref in (want, plain):
        err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
        assert got.shape == ref.shape and err <= 1e-5


@pytest.mark.parametrize("family", ["tt", "cp"])
@pytest.mark.parametrize("order", sorted(TILED_CASES))
@pytest.mark.parametrize("pipeline", ["serial", "double"])
def test_tiled_schedule_matches_reference_and_plain(family, order, pipeline):
    """K1's / K5's block schedule (fold, k tiles, batch tiles, T groups and
    chunks, slabs of the leading index, operator tiles, partials reduced in
    group order) emulated in torch ops, against the reference's
    interpret-mode kernel and the plain program: within 1e-5 of max|ref|
    (fp32, other summation order)."""
    dims, b, k, rank = TILED_CASES[order]
    jop, top = _pair(family, dims, k=k, rank=rank, seed=order)
    cores = [c.contiguous() for c in (ops.tt_cores_squeezed(top)
                                      if family == "tt" else top.factors)]
    x = np.random.default_rng(order).standard_normal((b,) + dims,
                                                     dtype=np.float32)
    plan = ops.plan_contraction(family, "project", k, b, dims, rank,
                                pipeline=pipeline)
    assert plan.trail % plan.tc and plan.grid[2] > 1   # ragged, split
    got = _sweep.sweep_project_tiled_plain(torch.from_numpy(x), *cores,
                                           plan=plan, scale=1 / math.sqrt(k))
    jproj = jops.tt_project if family == "tt" else jops.cp_project
    want = np.asarray(jproj(jop, jnp.asarray(x)))
    plain = _sweep.sweep_project_plain(torch.from_numpy(x), *cores,
                                       steps=plan.steps,
                                       scale=1 / math.sqrt(k)).numpy()
    for ref in (want, plain):
        err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
        assert got.shape == ref.shape and err <= 1e-5


def test_opcodes_agree_with_the_cuda_header():
    header = (pathlib.Path(_sweep.CSRC) / "sweep_common.cuh").read_text()
    enum = dict((n, int(v)) for n, v in re.findall(r"(OP_\w+) = (\d+)",
                                                   header))
    assert enum == {n: getattr(ops, n) for n in enum}
    assert len(enum) == 4


def _defines(source: str) -> dict[str, int]:
    text = (pathlib.Path(_sweep.CSRC) / source).read_text()
    return {n: int(v) for n, v in re.findall(r"#define (\w+) (\d+)", text)}


def test_tile_constants_agree_with_the_cuda_sources():
    """The planner's tiling constants are the ones the kernels compile."""
    project = _defines("sweep_project.cu")
    assert project["PROJ_THREADS"] == ops.PROJECT_THREADS
    text = (pathlib.Path(_sweep.CSRC) / "sweep_project.cu").read_text()
    assert {int(v) for v in re.findall(r"tm == (\d+)", text)} == set(
        ops.PROJECT_TM)
    assert {16 * int(v) for v in re.findall(r"tn == (\d+)", text)} == set(
        ops.PROJECT_TILE_K)
    assert _defines("sweep_fold.cuh")["MAXR"] == ops.MAX_RANK  # the fold
    recon = _defines("sweep_reconstruct.cuh")  # K2's and K4's device code
    assert recon["RECON_THREADS"] == ops.RECON_THREADS
    assert recon["RECON_BN"] == ops.RECON_TILE_N
    assert recon["RECON_SS"] == ops.RECON_S_STRIDE
    text = (pathlib.Path(_sweep.CSRC) / "sweep_reconstruct.cuh").read_text()
    assert {int(v) for v in re.findall(r"tm == (\d+)", text)} == set(
        ops.RECON_TM)
    assert {int(v) for v in re.findall(r"case (\d+): return recon_gemm<",
                                       text)} == set(ops.RECON_TM) - {8}
    assert {int(v) for v in re.findall(r"tile_k == (\d+)", text)} == set(
        ops.RECON_TILE_K)
    assert {int(v) for v in re.findall(r"recon_tm<(\d+)>", text)} == set(
        ops.RECON_TILE_K)
    # the chunk widths: powers of 2 from 4 up to the tile's columns
    assert ops.RECON_TILE_T == tuple(4 << i for i in range(
        int(math.log2(ops.RECON_TILE_N // 4)) + 1))
    assert _defines("sweep_common.cuh")["SWEEP_MAX_ORDER"] == ops.MAX_ORDER


@pytest.mark.parametrize("rank", [1, 3, 5, 8, 12, 25, 64])
@pytest.mark.parametrize("tc", [4, 8, 16])
def test_m_row_stride_spreads_float4_reads_across_banks(rank, tc):
    """Eight consecutive k-rows of the staged m chunk start in eight
    distinct 16-byte bank groups, so a quarter-warp's float4 reads of the
    operator build do not conflict; the padding stays under 32 floats."""
    ms = ops.m_row_stride(rank, tc)
    assert ms % 32 == 4 and rank * tc <= ms < rank * tc + 32
    assert len({(i * ms // 4) % 8 for i in range(8)}) == 8


def test_wrappers_refuse_devices_without_a_kernel():
    """A non-CPU tensor that is not on CUDA cannot take the plain version
    and has no kernel: the wrapper raises."""
    plan = ops.plan_contraction("cp", "project", 4, 2, (3, 5), 2)
    x = torch.empty((2, 3, 5), device="meta")
    cores = [torch.empty((4, d, 2), device="meta") for d in (3, 5)]
    with pytest.raises(ValueError, match="CUDA"):
        _sweep.sweep_project(x, *cores, plan=plan, scale=1.0)


def test_wrappers_check_layouts():
    _, top = _pair("tt", (4, 8, 8))
    plan = ops.plan_contraction("tt", "project", 20, 2, (4, 8, 8), 3)
    from repro_torch.kernels.tt_sweep import tt_sweep_project
    with pytest.raises(ValueError, match="squeezed cores"):
        tt_sweep_project(torch.zeros(2, 4, 8, 8), *top.cores, plan=plan,
                         scale=1.0)
    with pytest.raises(TypeError, match="float32"):
        _sweep.sweep_project(torch.zeros(2, 4, 8, 8, dtype=torch.float64),
                             *ops.tt_cores_squeezed(top), plan=plan,
                             scale=1.0)


def test_hbm_ledger_counts_each_operand():
    p = ops.plan_contraction("tt", "project", 512, 64, (64, 64, 64), 5)
    nk, nb, _ = p.grid
    x = 4 * 64 * 64 ** 3
    assert ops.sweep_hbm_bytes(p) >= nk * x + 4 * 64 * 512
    r = ops.plan_contraction("tt", "reconstruct", 512, 64, (64, 64, 64), 5)
    assert ops.sweep_hbm_bytes(r) > 4 * 64 * 64 ** 3 + 4 * 512 * 5 * 64 ** 2


# ---------------------------------------------------------------------------
# the plan layer and dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["tt", "cp"])
@pytest.mark.parametrize("backend", ["auto", "kernel", "torch"])
def test_dispatch_matches_reference_project_and_reconstruct(family, backend):
    jop, top = _pair(family, (4, 8, 8))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 4, 8, 8), dtype=np.float32)
    flat = rng.standard_normal((3, 200), dtype=np.float32)   # short vectors
    y = rng.standard_normal((2, 20), dtype=np.float32)
    with rp.dispatch_stats() as st:
        _close(rp.project(top, torch.from_numpy(x), backend=backend),
               jrp.project(jop, jnp.asarray(x), backend="xla"))
        _close(rp.project(top, flat, backend=backend),
               jrp.project(jop, jnp.asarray(flat), backend="xla"))
        _close(rp.reconstruct(top, torch.from_numpy(y), backend=backend),
               jrp.reconstruct(jop, jnp.asarray(y), backend="xla"))
    assert st.kernel_calls == (3 if backend == "kernel" else 0)
    route = "kernel" if backend == "kernel" else "torch"
    assert sum(st.breakdown.values()) == 3
    assert all(key[2] == route for key in st.breakdown)


def test_auto_route_takes_the_kernel_on_cuda_and_torch_on_cpu():
    spec = rp.ProjectorSpec("tt", 512, (64, 64, 64), rank=5)
    on_card = rp.plan_execution(spec, rp.StructureSig("dense", 64),
                                device="cuda")
    assert on_card.route == "kernel" and on_card.kernel == "sweep_project"
    assert on_card.tiles is not None and on_card.cost.smem_bytes > 0
    back = rp.plan_execution(spec, rp.StructureSig("sketch", 64),
                             kind="reconstruct", device="cuda")
    assert back.route == "kernel" and back.chunk_policy == "folded"
    on_cpu = rp.plan_execution(spec, rp.StructureSig("dense", 64),
                               device="cpu")
    assert on_cpu.route == "torch" and on_cpu.tiles is None
    assert "CPU" in on_cpu.rejected[0][1]
    assert on_card.cost.flops == on_cpu.cost.flops


def test_structured_rows_raise_not_implemented():
    """The structured rows are ported: they plan the carry sweep. What they
    still refuse is an operator of no registered family (it has no
    `project` to densify into, so it raises AttributeError, as the
    reference does) and batched containers in project_many."""
    from repro_torch.core import BatchedTTTensor, TTTensor
    _, top = _pair("tt", (4, 8, 8))
    tt = TTTensor(tuple(torch.zeros(s) for s in [(1, 4, 2), (2, 8, 2),
                                                  (2, 8, 1)]))
    plan = rp.plan_execution(top, rp.StructureSig("tt", 8, in_rank=2),
                             backend="kernel")
    assert plan.kernel == "carry_sweep" and plan.carry_bytes > 0
    assert tuple(rp.project(top, tt).shape) == (20,)

    class Foreign:
        k, in_dims = 20, (4, 8, 8)

    with pytest.raises(AttributeError, match="project"):
        rp.project(Foreign(), tt)
    with pytest.raises(rp.FormatMismatchError, match="batched containers"):
        rp.project_many(top, [BatchedTTTensor.stack([tt])])


def test_structured_rows_plan_the_carry_and_flat_families_densify():
    """A flat family (gaussian) densifies a structured input on the torch
    route, as the reference does: the same sketch as the dense input's
    (exact: the same matrix and the same product)."""
    from repro_torch.core import TTTensor
    g = np.random.default_rng(3)
    tt = TTTensor(tuple(torch.from_numpy(g.standard_normal(s).astype(
        np.float32)) for s in [(1, 4, 2), (2, 8, 2), (2, 8, 1)]))
    gop = rp.make_projector(rp.ProjectorSpec("gaussian", 20, (4, 8, 8)), 0,
                            device="cpu")
    with rp.dispatch_stats() as st:
        y = rp.project(gop, tt)
    assert st.breakdown == {("gaussian", "dense", "torch", 1): 1}
    assert torch.equal(y, rp.project(gop, tt.full().reshape(-1)))


def test_plan_cache_hits_and_explain():
    rp.clear_plan_cache()
    _, top = _pair("cp", (4, 8, 8))
    x = torch.zeros(8, 4, 8, 8)
    first = rp.explain(top, x, backend="kernel")
    rp.project(top, x, backend="kernel")
    stats = rp.plan_cache_stats()
    assert (stats.builds, stats.hits) == (1, 1)
    assert "sweep_project" in first.describe()
    assert first.plan_id == rp.explain(top, x, backend="kernel").plan_id


def test_dispatch_rejects_bad_inputs():
    _, top = _pair("tt", (4, 8, 8))
    with pytest.raises(rp.FormatMismatchError, match="near-miss"):
        rp.project(top, torch.zeros(4, 8, 7))
    with pytest.raises(rp.FormatMismatchError):
        rp.reconstruct(top, torch.zeros(3, 21))
    with pytest.raises(ValueError, match="backend"):
        rp.project(top, torch.zeros(4, 8, 8), backend="pallas")


def test_dispatch_imports_no_kernel_module():
    src = pathlib.Path(rp.dispatch.__file__).read_text()
    imports = [ln for ln in src.splitlines()
               if ln.lstrip().startswith(("import ", "from "))]
    assert not [ln for ln in imports if "kernels" in ln]


def test_project_many_matches_reference():
    jop, top = _pair("tt", (4, 8, 8))
    rng = np.random.default_rng(9)
    payloads = [rng.standard_normal((4, 8, 8), dtype=np.float32),
                rng.standard_normal(200, dtype=np.float32),
                rng.standard_normal(256, dtype=np.float32)]
    with rp.dispatch_stats() as st:
        got = rp.project_many(top, payloads, backend="kernel")
    assert st.kernel_calls == 1 and got.shape == (3, 20)
    _close(got, jrp.project_many(jop, [jnp.asarray(p) for p in payloads],
                                 backend="xla"))
    sig = rp.group_signature(top, payloads)
    assert (sig.structure, sig.batch) == ("dense", 8)
    with pytest.raises(rp.FormatMismatchError):
        rp.project_many(top, [np.zeros((2, 256), np.float32)])


def test_projector_spec_roundtrip_and_for_flat():
    spec = rp.ProjectorSpec("cp", 64, (8, 16), rank=4, backend="kernel")
    assert rp.ProjectorSpec.from_dict(spec.to_dict()) == spec
    assert spec.to_dict()["dtype"] == "float32"
    flat = rp.ProjectorSpec.for_flat("tt", 1000, 32)
    assert flat.dims == jrp.ProjectorSpec.for_flat("tt", 1000, 32).dims
    assert math.prod(flat.dims) >= 1000
    assert rp.list_families() == jrp.list_families()
    assert rp.get_family("dense") is rp.get_family("gaussian")
    with pytest.raises(KeyError):
        rp.get_family("fourier")


def test_force_kernel_nests_and_restores():
    """force_kernel is depth-counted on the context-local stats, as the
    reference's force_pallas: nested scopes compose, the flag drops only
    when the last scope exits, and under it 'auto' on the CPU takes the
    kernel route (the plain versions), with the same numbers."""
    _, top = _pair("tt", (4, 8, 8))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 4, 8, 8), dtype=np.float32))
    with rp.dispatch_stats() as stats:
        assert not stats.force_kernel
        y_auto = rp.project(top, x)
        with rp.force_kernel():
            with rp.force_kernel():
                assert stats.force_depth == 2 and stats.force_kernel
            assert stats.force_kernel
            y_forced = rp.project(top, x)
            assert rp.explain(top, x).route == "kernel"
        assert not stats.force_kernel and stats.force_depth == 0
        assert rp.explain(top, x).route == "torch"
        assert stats.breakdown == {("tt", "dense", "torch", 3): 1,
                                   ("tt", "dense", "kernel", 3): 1}
        assert stats.kernel_calls == 1
    _close(y_forced, y_auto.numpy())


def test_dispatch_breakdown_table_matches_reference():
    """The same dispatches through both packages land the same
    breakdown rows (the port's 'kernel'/'torch' for 'pallas'/'xla'), a
    flat family under order 1."""
    dims = (4, 8, 8)
    jop, top = _pair("tt", dims)
    jg = jrp.make_projector(jrp.ProjectorSpec("gaussian", 20, dims),
                            jax.random.PRNGKey(1))
    tg = rp.make_projector(rp.ProjectorSpec("gaussian", 20, dims), 1,
                           device="cpu")
    x = np.random.default_rng(3).standard_normal(dims, dtype=np.float32)
    with jrp.dispatch_stats() as jst:
        y = jrp.project(jop, x, backend="pallas")
        jrp.project(jop, x, backend="xla")
        jrp.project(jg, x, backend="xla")
        jrp.reconstruct(jop, y, backend="xla")
    with rp.dispatch_stats() as st:
        y = rp.project(top, torch.from_numpy(x), backend="kernel")
        rp.project(top, torch.from_numpy(x), backend="torch")
        rp.project(tg, torch.from_numpy(x), backend="torch")
        rp.reconstruct(top, y, backend="torch")
    names = {"pallas": "kernel", "xla": "torch"}
    want = [dict(r, route=names[r["route"]])
            for r in jst.breakdown_table()]
    assert sorted(st.breakdown_table(), key=str) == sorted(want, key=str)
    assert st.kernel_calls == jst.kernel_calls == 1


def test_plan_views_match_reference():
    """PlanCacheStats.lookups / hit_rate / as_dict, CostLedger.as_dict and
    ExecutionPlan.as_dict carry the reference's fields (the port's ledger
    counts shared memory where the reference counts VMEM and wire bytes,
    and its plan names the device)."""
    rp.clear_plan_cache()
    _, top = _pair("cp", (4, 8, 8))
    x = torch.zeros(8, 4, 8, 8)
    plan = rp.explain(top, x, backend="kernel")
    rp.project(top, x, backend="kernel")
    stats = rp.plan_cache_stats()
    assert (stats.lookups, stats.hit_rate) == (2, 0.5)
    assert stats.as_dict() == {"builds": 1, "hits": 1, "evictions": 0,
                               "hit_rate": 0.5}
    jstats = jrp.plan_cache_stats()
    assert set(stats.as_dict()) == set(jstats.as_dict())
    d = plan.as_dict()
    jplan = jrp.plan_execution(jrp.ProjectorSpec("cp", 20, (4, 8, 8), 3),
                               jrp.StructureSig("dense", 8),
                               backend="pallas")
    jd = jplan.as_dict()
    assert set(d) == set(jd) | {"device"}
    assert set(d["cost"]) == set(jd["cost"]) - {"vmem_bytes"} | {"smem_bytes"}
    assert d["cost"]["wire_bytes"] == jd["cost"]["wire_bytes"] == 0
    assert d["cost"] == plan.cost.as_dict() and d["tiles"] == plan.tiles
    assert (d["cost"]["flops"], d["cost"]["params"]) == (
        jd["cost"]["flops"], jd["cost"]["params"])
    json.dumps(d)


@pytest.mark.parametrize("kind", ["project", "reconstruct"])
@pytest.mark.parametrize("family", ["tt", "cp"])
def test_pick_tiles_is_the_planner_tile_view(family, kind):
    """pick_tiles returns the Hopper planner's (tk, tb, ba, tc) under the
    shared-memory budget (not the reference's VMEM budget)."""
    dims, k, b, rank = (64, 64, 64), 512, 64, 5
    plan = ops.plan_contraction(family, kind, k, b, dims, rank)
    assert ops.pick_tiles(k, b, dims, rank, kind=kind, family=family) == (
        plan.tk, plan.tb, plan.ba, plan.tc)
    assert plan.smem_bytes <= ops.SMEM_BUDGET_BYTES
