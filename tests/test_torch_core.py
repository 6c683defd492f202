"""repro_torch.core against repro.core on the same operators and inputs.

Operators are sampled in JAX and carried across with
`from_numpy_operator`; inputs are drawn with numpy. Tolerance rtol=1e-5,
atol=1e-5: both sides compute in float32 with the same contractions, but
torch and XLA sum in different orders, so results differ by a few ulps of
the partial sums (values here are O(1)-O(10)).

The port's own samplers draw from `torch.Generator`, which cannot replay
JAX's threefry streams, so they are checked in distribution only: the
Definition-1/2 variances and the Thm-1 expected isometry.
"""
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import sample_cp_rp as j_sample_cp
from repro.core import sample_tt_rp as j_sample_tt
from repro.core import theory as jtheory
from repro_torch.core import (from_numpy_operator, pad_to_tensorizable,
                              sample_cp_rp, sample_tt_rp, theory)
from repro_torch.core.formats import auto_dims

RTOL = ATOL = 1e-5
DIMS = [(8, 8), (4, 8, 8), (4, 4, 4, 8)]


def _pair(family, dims, k=24, rank=3, seed=0):
    sampler = j_sample_tt if family == "tt" else j_sample_cp
    jop = sampler(jax.random.PRNGKey(seed), dims, k, rank)
    arrays = jop.cores if family == "tt" else jop.factors
    return jop, from_numpy_operator(family, [np.asarray(a) for a in arrays],
                                    "cpu")


def _close(got, want):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("family", ["tt", "cp"])
@pytest.mark.parametrize("dims", DIMS)
def test_project_matches_reference(family, dims):
    jop, top = _pair(family, dims)
    x = np.random.default_rng(1).standard_normal((5,) + dims,
                                                 dtype=np.float32)
    _close(top.project(torch.from_numpy(x)), jop.project(jnp.asarray(x)))
    _close(top.project(torch.from_numpy(x[0])),
           jop.project(jnp.asarray(x[0])))


@pytest.mark.parametrize("family", ["tt", "cp"])
@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("chunk", [None, 7])
def test_reconstruct_matches_reference(family, dims, chunk):
    jop, top = _pair(family, dims)
    y = np.random.default_rng(2).standard_normal(24, dtype=np.float32)
    _close(top.reconstruct(torch.from_numpy(y), chunk=chunk),
           jop.reconstruct(jnp.asarray(y), chunk=chunk))


@pytest.mark.parametrize("family", ["tt", "cp"])
def test_dense_matrix_and_params_match_reference(family):
    jop, top = _pair(family, (4, 3, 5), k=6)
    _close(top.as_dense_matrix(), jop.as_dense_matrix())
    assert top.num_params() == jop.num_params()
    assert (top.k, top.dims, top.rank) == (jop.k, jop.dims, jop.rank)


def test_from_numpy_operator_rejects_bad_layouts():
    with pytest.raises(ValueError):
        from_numpy_operator("tt", [np.zeros((2, 3, 4))], "cpu")
    with pytest.raises(ValueError):
        from_numpy_operator("gaussian", [np.zeros((2, 3, 4))], "cpu")


def test_tt_sampler_variances_follow_definition_1():
    """Per-core entry variance: 1/sqrt(R) on the boundary cores, 1/R
    inside (Definition 1), pooled over many draws."""
    rank, dims = 4, (6, 5, 5, 6)
    g = torch.Generator().manual_seed(0)
    draws = [sample_tt_rp(g, dims, 64, rank) for _ in range(20)]
    for n in range(len(dims)):
        var = torch.cat([d.cores[n].reshape(-1) for d in draws]).var().item()
        want = 1 / math.sqrt(rank) if n in (0, len(dims) - 1) else 1 / rank
        assert abs(var - want) < 0.05 * want, (n, var, want)


def test_cp_sampler_variance_follows_definition_2():
    rank, dims = 5, (6, 5, 7)
    g = torch.Generator().manual_seed(1)
    draws = [sample_cp_rp(g, dims, 64, rank) for _ in range(20)]
    want = (1 / rank) ** (1 / len(dims))
    for n in range(len(dims)):
        var = torch.cat([d.factors[n].reshape(-1) for d in draws]).var().item()
        assert abs(var - want) < 0.05 * want, (n, var, want)


@pytest.mark.parametrize("family", ["tt", "cp"])
def test_sampled_maps_are_expected_isometries(family):
    """Thm 1: E ||f(x)||^2 = ||x||^2; the sample mean over 400 operators
    lies within 4 standard errors."""
    dims, k, rank = (4, 5, 6), 16, 3
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        dims).astype(np.float32))
    x = x / x.norm()
    g = torch.Generator().manual_seed(2)
    sampler = sample_tt_rp if family == "tt" else sample_cp_rp
    sq = torch.stack([sampler(g, dims, k, rank).project(x).pow(2).sum()
                      for _ in range(400)])
    se = sq.std().item() / math.sqrt(len(sq))
    assert abs(sq.mean().item() - 1.0) < 4 * se


def test_samplers_are_deterministic_per_seed():
    a = sample_tt_rp(torch.Generator().manual_seed(5), (4, 4), 8, 2)
    b = sample_tt_rp(torch.Generator().manual_seed(5), (4, 4), 8, 2)
    assert all(torch.equal(x, y) for x, y in zip(a.cores, b.cores))


_THEORY_CASES = [
    ("variance_factor_tt", (3, 4)), ("variance_factor_cp", (3, 4)),
    ("variance_ratio_cp_to_tt", (4, 2)),
    ("required_k_tt", (0.1, 100, 3, 5)), ("required_k_cp", (0.1, 100, 3, 5)),
    ("required_k_gaussian", (0.1, 100)),
    ("concentration_bound_tt", (512, 0.2, 3, 5)),
    ("params_tt_rp", (512, (64, 64, 64), 5)),
    ("params_cp_rp", (512, (64, 64, 64), 25)),
    ("flops_project_dense_tt", (512, (64, 64, 64), 5)),
    ("flops_project_dense_cp", (512, (64, 64, 64), 25)),
    ("flops_project_struct", ("tt", "cp", 64, (8, 8, 8), 3, 2)),
    ("mem_carry_struct", (64, 3, 2)),
    ("struct_speedup", ("cp", "tt", 64, (8, 8, 8), 3, 2)),
]


@pytest.mark.parametrize("name,args", _THEORY_CASES,
                         ids=[c[0] for c in _THEORY_CASES])
def test_theory_copy_matches_reference(name, args):
    assert getattr(theory, name)(*args) == getattr(jtheory, name)(*args)


def test_theory_copy_has_every_reference_function():
    ref = {n for n, f in inspect.getmembers(jtheory, inspect.isfunction)}
    port = {n for n, f in inspect.getmembers(theory, inspect.isfunction)}
    assert ref == port
    for fam in ("tt", "cp", "sparse", "gaussian"):
        assert (theory.variance_factor(fam, N=3, R=5, D=4096)
                == jtheory.variance_factor(fam, N=3, R=5, D=4096))


@pytest.mark.parametrize("size", [100, 128, 1000, 128 * 128 * 3, 2 ** 20])
def test_tensorization_matches_reference(size):
    assert auto_dims(size) == jformats.auto_dims(size)
    v = torch.arange(size, dtype=torch.float32)
    pv, dims, n = pad_to_tensorizable(v)
    jpv, jdims, jn = jformats.pad_to_tensorizable(jnp.arange(size,
                                                             dtype=jnp.float32))
    assert (dims, n) == (jdims, jn)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jpv))
