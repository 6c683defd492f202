"""The paper's baselines (dense Gaussian JLT, very-sparse RP) in the port
against repro.core.baselines, and the flat families' dispatch.

Elementwise comparisons carry the reference's own blocks across
(`from_numpy_operator('gaussian' | 'sparse', [_block_mat(b)], dim=D)`),
so the port's streaming machinery (project, the streamed adjoint,
materialize, the densifying dispatch) is held against the reference's on
the same matrix. Tolerance: fp32 rtol=1e-5, atol=1e-5. Both packages get
a small `block` (the default 65,536 rows would make every CPU call stream
a 65,536 x k block).

Operators drawn by the port's own sampler (one `torch.Generator` a block,
seeded from the operator's base seed and the block index) are checked in
distribution only: entry mean and variance, very-sparse's nonzero rate
1/s, and E||Ax||^2/k = ||x||^2; and for bitwise regeneration.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import rp as jrp
from repro.core import random_cp as j_random_cp
from repro.core import random_tt as j_random_tt
from repro.core.baselines import GaussianRP as JGaussianRP
from repro.core.baselines import VerySparseRP as JVerySparseRP
from repro_torch import rp
from repro_torch.core import (BatchedTTTensor, GaussianRP, VerySparseRP,
                              from_numpy_cp, from_numpy_operator,
                              from_numpy_tt, theory)

RTOL = ATOL = 1e-5
K, D, BLOCK = 24, 120, 32
REF = {"gaussian": JGaussianRP, "sparse": JVerySparseRP}


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


def _pair(family, k=K, dim=D, block=BLOCK, seed=6):
    """The reference's operator and the port's on the reference's blocks."""
    jop = REF[family](jax.random.PRNGKey(seed), k, dim, block=block)
    blocks = [np.asarray(jop._block_mat(b, jnp.float32))
              for b in range(jop._n_blocks())]
    return jop, from_numpy_operator(family, blocks, "cpu", dim=dim)


def test_families_match_the_reference_registry():
    assert rp.list_families() == jrp.list_families()
    for alias, name in (("dense", "gaussian"), ("verysparse", "sparse")):
        assert rp.get_family(alias) is rp.get_family(name)


@pytest.mark.parametrize("family", ["gaussian", "sparse"])
def test_streaming_matches_reference_on_its_blocks(family):
    """project (single and batched), the streamed adjoint and the
    materialized matrix, on the reference's blocks (D=120 over blocks of
    32: a ragged last block)."""
    jop, op = _pair(family)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, D), dtype=np.float32)
    _close(op.project(torch.from_numpy(x)), jop.project(jnp.asarray(x)))
    _close(op.project(torch.from_numpy(x[0])),
           jop.project(jnp.asarray(x[0])))
    y = rng.standard_normal((K,), dtype=np.float32)
    _close(op.reconstruct(torch.from_numpy(y)),
           jop.reconstruct(jnp.asarray(y)))
    _close(op.materialize(), jop.materialize())
    _close(op.as_dense_matrix(), jop.as_dense_matrix())
    assert op.num_params() == jop.num_params()
    assert op.in_dims == jop.in_dims == (D,)


@pytest.mark.parametrize("family", ["gaussian", "sparse"])
def test_structured_inputs_densify_as_the_reference(family):
    """TT and CP inputs, single and batched, under a flat family densify
    (`(D,)` / `(B, D)`) and project as the reference's dispatch does."""
    dims = (4, 5, 6)
    jop, op = _pair(family)
    jt = j_random_tt(jax.random.PRNGKey(1), dims, 3)
    jc = j_random_cp(jax.random.PRNGKey(2), dims, 2)
    tt = from_numpy_tt([np.asarray(c) for c in jt.cores], "cpu")
    tc = from_numpy_cp([np.asarray(f) for f in jc.factors], None, "cpu")
    for jx, x in ((jt, tt), (jc, tc)):
        with rp.dispatch_stats() as st:
            got = rp.project(op, x)
        _close(got, jrp.project(jop, jx))
        assert st.breakdown == {(family, "dense", "torch", 1): 1}
    jb = [j_random_tt(jax.random.PRNGKey(10 + i), dims, 2) for i in range(3)]
    xb = BatchedTTTensor.stack(
        [from_numpy_tt([np.asarray(c) for c in t.cores], "cpu") for t in jb])
    want = np.stack([np.asarray(jrp.project(jop, t)) for t in jb])
    _close(rp.project(op, xb), want)
    plan = rp.explain(op, xb)
    assert (plan.structure, plan.batch, plan.route) == ("dense", 3, "torch")


@pytest.mark.parametrize("family", ["gaussian", "sparse"])
def test_batched_reconstruct_dispatch_matches_reference(family):
    jop, op = _pair(family)
    y = np.random.default_rng(1).standard_normal((2, 3, K),
                                                 dtype=np.float32)
    got = rp.reconstruct(op, torch.from_numpy(y))
    assert got.shape == (2, 3, D)
    _close(got, jrp.reconstruct(jop, jnp.asarray(y)))


@pytest.mark.parametrize("family", ["gaussian", "sparse"])
def test_port_sampler_regenerates_blocks_bitwise(family):
    """project, reconstruct and materialize regenerate the same blocks:
    the streamed maps equal the materialized matrix's, bit for bit a
    second time; another seed is another matrix."""
    spec = rp.ProjectorSpec(family, K, (4, 5, 6))

    def make(seed):
        return dataclasses.replace(rp.make_projector(spec, seed,
                                                     device="cpu"),
                                   block=BLOCK)

    op = make(3)
    a = op.materialize()
    assert torch.equal(a, op.materialize())
    x = torch.randn(4, D, generator=torch.Generator().manual_seed(0))
    y = op.project(x)
    assert torch.equal(y, op.project(x))
    _close(y, x @ a.T)
    _close(op.reconstruct(y), y @ a)
    assert torch.equal(make(3).materialize(), a)
    assert not torch.equal(make(4).materialize(), a)


def test_gaussian_entries_are_standard_normal():
    """A (256, 2000) matrix: entry mean 0 and variance 1 within 5 standard
    errors (materialize divides by sqrt(k))."""
    op = GaussianRP(seed=11, k=256, dim=2000, block=512)
    a = op.materialize().double() * math.sqrt(op.k)
    n = a.numel()
    assert abs(float(a.mean())) < 5.0 / math.sqrt(n)
    assert abs(float(a.var()) - 1.0) < 5.0 * math.sqrt(2.0 / n)


def test_very_sparse_entries_follow_li_et_al():
    """A (256, 2500) matrix, s = sqrt(D) = 50: the nonzero rate is 1/s
    within 5 standard errors, nonzeros are +-sqrt(s) with equal odds, and
    E[a^2] = 1."""
    op = VerySparseRP(seed=12, k=256, dim=2500, block=700)
    a = op.materialize().double() * math.sqrt(op.k)
    s, n = op.sparsity, a.numel()
    assert s == 50.0
    nz = a[a != 0]
    p = 1.0 / s
    assert abs(nz.numel() / n - p) < 5.0 * math.sqrt(p * (1 - p) / n)
    assert torch.allclose(nz.abs(), torch.full_like(nz, math.sqrt(s)))
    assert abs(float((nz > 0).double().mean()) - 0.5) < 5.0 * math.sqrt(
        0.25 / nz.numel())
    assert abs(float(a.square().mean()) - 1.0) < 0.1
    assert op.num_params() == theory.params_rp("sparse", 256, (2500,))


@pytest.mark.parametrize("family", ["gaussian", "sparse"])
def test_port_sampler_is_an_expected_isometry(family):
    """E||Ax||^2 / k = ||x||^2: the mean over 60 operators of a unit x's
    squared sketch norm is 1 within 5 standard errors of the Thm-1
    variance (2/k Gaussian, (2 + (s-3) sum x^4)/k very-sparse)."""
    k, dim = 64, 400
    x = torch.randn(dim, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    x = (x / x.norm()).float()
    spec = rp.ProjectorSpec(family, k, (dim,))
    vals = [float(rp.project(rp.make_projector(spec, s, device="cpu"),
                             x).square().sum()) for s in range(60)]
    c = 2.0 if family == "gaussian" else 2.0 + (math.sqrt(dim) - 3.0) * float(
        x.double().pow(4).sum())
    assert abs(np.mean(vals) - 1.0) < 5.0 * math.sqrt(c / k / len(vals))


def test_from_numpy_operator_checks_the_blocks():
    blocks = [np.zeros((32, K), np.float32)] * 4
    with pytest.raises(ValueError, match="dim"):
        from_numpy_operator("gaussian", blocks, "cpu", dim=200)
    with pytest.raises(ValueError, match="2-d"):
        from_numpy_operator("sparse", [np.zeros((3, 4, 5))], "cpu", dim=3)
    with pytest.raises(ValueError, match="unknown family"):
        from_numpy_operator("fourier", blocks, "cpu", dim=120)


def test_flat_plans_count_two_flops_a_parameter():
    """A flat family's plan: the torch route, 2 flops per stored parameter
    per item, the operator's parameter count and variance factor, as the
    reference's plan layer."""
    for family in ("gaussian", "sparse"):
        jop = REF[family](jax.random.PRNGKey(0), K, D, block=BLOCK)
        op = rp.make_projector(rp.ProjectorSpec(family, K, (D,)), 0,
                               device="cpu")
        plan = rp.explain(op, torch.zeros(5, D))
        jplan = jrp.explain(jop, jnp.zeros((5, D)))
        assert plan.route == "torch" and jplan.route == "xla"
        assert (plan.family, plan.batch, plan.cost.flops,
                plan.cost.params) == (jplan.family, jplan.batch,
                                      jplan.cost.flops, jplan.cost.params)
        assert plan.cost.var_factor == pytest.approx(jplan.cost.var_factor)
        assert plan.cost.flops == 5 * 2 * op.num_params()
