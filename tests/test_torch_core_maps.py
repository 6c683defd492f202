"""repro_torch.core's inner products, TT-SVD, operator rows, structured
projections and TRP helpers against repro.core on the same arrays.

Operators and TT/CP tensors are drawn in JAX and carried across as numpy
arrays (`from_numpy_operator`, `from_numpy_tt`, `from_numpy_cp`).
Tolerance: fp32 rtol=1e-5, atol=1e-5 (the same contractions, summed in
other orders), unless a test says otherwise. `tt_svd`'s cores are fixed
only up to the signs of the singular vectors, so its `full()` and ranks
are compared, never its cores.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (CPRP as JCPRP, CPTensor as JCPTensor, cp_inner as
                        j_cp_inner, dense_inner as j_dense_inner, random_cp
                        as j_random_cp, random_tt as j_random_tt,
                        sample_cp_rp as j_sample_cp, sample_tt_rp as
                        j_sample_tt, trp_average as j_trp_average,
                        trp_project as j_trp_project, tt_cp_inner as
                        j_tt_cp_inner, tt_inner as j_tt_inner, tt_svd as
                        j_tt_svd)
from repro_torch.core import (CPRP, cp_inner, dense_inner,
                              from_numpy_operator, from_numpy_cp,
                              from_numpy_tt, trp_average, trp_project,
                              tt_cp_inner, tt_inner, tt_svd)

RTOL = ATOL = 1e-5
DIMS = (4, 5, 6)
KEY = jax.random.PRNGKey(0)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


def _tt(key, dims, rank):
    jt = j_random_tt(key, dims, rank)
    return jt, from_numpy_tt([np.asarray(c) for c in jt.cores], "cpu")


def _cp(key, dims, rank, weighted=False):
    jc = j_random_cp(key, dims, rank)
    if weighted:
        w = jnp.linspace(0.5, 1.5, rank)
        jc = JCPTensor(jc.factors, w)
    return jc, from_numpy_cp([np.asarray(f) for f in jc.factors],
                             None if jc.weights is None
                             else np.asarray(jc.weights), "cpu")


def _op(family, dims, k, rank, seed):
    sampler = j_sample_tt if family == "tt" else j_sample_cp
    jop = sampler(jax.random.PRNGKey(seed), dims, k, rank)
    arrays = jop.cores if family == "tt" else jop.factors
    return jop, from_numpy_operator(family, [np.asarray(a) for a in arrays],
                                    "cpu")


@pytest.mark.parametrize("dims", [(4, 5, 6), (3, 2, 4, 3)],
                         ids=["order3", "order4"])
def test_inner_products_match_reference(dims):
    ja, ta = _tt(KEY, dims, 3)
    jb, tb = _tt(jax.random.PRNGKey(1), dims, 2)
    jc, tc = _cp(jax.random.PRNGKey(2), dims, 3)
    jd, td = _cp(jax.random.PRNGKey(3), dims, 4, weighted=True)
    _close(tt_inner(ta, tb), j_tt_inner(ja, jb))
    _close(cp_inner(tc, td), j_cp_inner(jc, jd))
    _close(cp_inner(td, td), j_cp_inner(jd, jd))
    _close(tt_cp_inner(ta, tc), j_tt_cp_inner(ja, jc))
    _close(tt_cp_inner(ta, td), j_tt_cp_inner(ja, jd))
    _close(dense_inner(ta.full(), td.full()),
           j_dense_inner(ja.full(), jd.full()))
    # and each against the densified inner product
    _close(tt_inner(ta, tb), torch.vdot(ta.full().reshape(-1),
                                        tb.full().reshape(-1)), rtol=1e-4)


def test_inner_products_refuse_mismatched_dims():
    _, ta = _tt(KEY, (4, 5, 6), 2)
    _, tb = _tt(KEY, (4, 5, 7), 2)
    _, tc = _cp(KEY, (4, 5, 7), 2)
    for fn, a, b in ((tt_inner, ta, tb), (tt_cp_inner, ta, tc)):
        with pytest.raises(ValueError, match="dims differ"):
            fn(a, b)


@pytest.mark.parametrize("max_rank", [2, 3, 30], ids=["r2", "r3", "full"])
def test_tt_svd_matches_reference(max_rank):
    """Truncated and full-rank TT-SVD: the same ranks and the same dense
    tensor as the reference (fp32 SVDs of two libraries: rtol=1e-4,
    atol=1e-5 of entries O(1)); full rank reproduces the input."""
    x = np.random.default_rng(0).standard_normal(DIMS, dtype=np.float32)
    jt = j_tt_svd(jnp.asarray(x), max_rank)
    tt = tt_svd(torch.from_numpy(x), max_rank)
    assert tt.ranks == jt.ranks
    _close(tt.full(), jt.full(), rtol=1e-4, atol=1e-5)
    if max_rank == 30:
        _close(tt.full(), x, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("family", ["tt", "cp"])
def test_operator_rows_match_reference(family):
    jop, op = _op(family, DIMS, 9, 3, seed=5)
    dense = op.as_dense_matrix() * np.sqrt(op.k)
    for i in (0, 4, 8):
        row = op.row(i)
        _close(row.full(), jop.row(i).full())
        _close(row.full().reshape(-1), dense[i])


@pytest.mark.parametrize("family", ["tt", "cp"])
@pytest.mark.parametrize("dims", [(4, 5, 6), (3, 4), (2, 3, 2, 3)],
                         ids=["order3", "order2", "order4"])
def test_structured_projections_match_reference(family, dims):
    """`project_tt` / `project_cp` (the einsum carry projections) on TT
    and CP inputs, weighted or not, against the reference's and against
    the dense projection of the densified input."""
    jop, op = _op(family, dims, 16, 3, seed=6)
    jt, tt = _tt(KEY, dims, 4)
    jc, tc = _cp(jax.random.PRNGKey(1), dims, 3)
    jw, tw = _cp(jax.random.PRNGKey(2), dims, 2, weighted=True)
    _close(op.project_tt(tt), jop.project_tt(jt))
    _close(op.project_cp(tc), jop.project_cp(jc))
    _close(op.project_cp(tw), jop.project_cp(jw))
    for x in (tt, tc, tw):
        proj = op.project_tt if hasattr(x, "cores") else op.project_cp
        _close(proj(x), op.project(x.full()), rtol=1e-4)


def test_structured_projections_refuse_mismatched_dims():
    _, op = _op("tt", DIMS, 8, 2, seed=1)
    _, tt = _tt(KEY, (4, 5, 7), 2)
    with pytest.raises(ValueError, match="dims"):
        op.project_tt(tt)


def test_trp_equals_cp1_and_the_reference():
    """Sun et al.'s TRP is exactly f_CP(1) (paper Sec. 3), and matches
    the reference's `trp_project` on the same factor matrices."""
    k = 32
    rng = np.random.default_rng(3)
    fm = [rng.standard_normal((d, k), dtype=np.float32) for d in DIMS]
    x = rng.standard_normal(DIMS, dtype=np.float32)
    y = trp_project([torch.from_numpy(f) for f in fm],
                    torch.from_numpy(x.reshape(-1)))
    _close(y, j_trp_project([jnp.asarray(f) for f in fm],
                            jnp.asarray(x.reshape(-1))))
    op = CPRP(tuple(torch.from_numpy(f).T[:, :, None] for f in fm))
    _close(op.project(torch.from_numpy(x)), y, rtol=1e-4)


def test_trp_T_equals_cp_R_and_the_reference():
    """TRP(T), the scaled average of T TRPs, == f_CP(R=T) (paper Sec. 3);
    `trp_average` matches the reference's."""
    n, k, t_count = len(DIMS), 16, 3
    rng = np.random.default_rng(4)
    x = rng.standard_normal(DIMS, dtype=np.float32)
    fms = [[rng.standard_normal((DIMS[i], k), dtype=np.float32)
            for i in range(n)] for _ in range(t_count)]
    parts = [trp_project([torch.from_numpy(f) for f in fm],
                         torch.from_numpy(x.reshape(-1))) for fm in fms]
    y = trp_average(parts)
    _close(y, j_trp_average([jnp.asarray(p.numpy()) for p in parts]))
    scale = (1.0 / t_count) ** (1.0 / (2 * n))
    factors = tuple(
        scale * torch.stack([torch.from_numpy(fms[t][i]).T
                             for t in range(t_count)], dim=-1)
        for i in range(n))
    _close(CPRP(factors).project(torch.from_numpy(x)), y, rtol=1e-4)
    jfactors = tuple(jnp.asarray(f.numpy()) for f in factors)
    _close(CPRP(factors).project(torch.from_numpy(x)),
           JCPRP(jfactors).project(jnp.asarray(x)))
