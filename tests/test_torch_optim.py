"""repro_torch.optim, core.sketch and K4's plain version against the
reference, on the CPU.

Inputs come from numpy; operators are sampled by the reference and carried
across with `from_numpy_operator` (the port's operator factory is
monkeypatched in these tests only: torch cannot replay
`fold_in(PRNGKey(0x5EED), step)`). K4 and the optimizer are held at the
reference's own tolerance, 3e-5 (float32 on both sides, different
summation order); two chained steps at 2e-4, as the reference's
`test_update_sketched_chained_steps`.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import rp as jrp
from repro.core import sketch as jsketch
from repro.kernels import fused_update as jfused
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.optim import schedule as jschedule
from repro_torch import kernels, rp
from repro_torch.core import from_numpy_operator, random_tt
from repro_torch.core.sketch import PytreeSketcher, SketchConfig, \
    SketchMonitor
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import _sweep, ops
from repro_torch.kernels import fused_update as fused
from repro_torch.optim import adamw, schedule
from repro_torch.optim.compress import (SketchCompressor,
                                        _balanced_pow2_dims,
                                        parse_compress_flag)

TOL = 3e-5
HP = dict(alpha=0.9, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach().float().numpy()),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _tree_close(got, want, tol=TOL):
    jleaves = jax.tree.leaves(want)
    leaves = tree_leaves(got)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, tol)


def _jop(spec, key):
    return jrp.make_projector(jrp.ProjectorSpec(
        family=spec.family, k=spec.k, dims=spec.dims, rank=spec.rank), key)


def _carry(family, jop):
    arrays = jop.cores if family == "tt" else jop.factors
    return from_numpy_operator(family, [np.asarray(a) for a in arrays], "cpu")


@pytest.fixture
def carried_ops(monkeypatch):
    """The port's operator for seed `_key(step)` is the reference's
    operator for `fold_in(PRNGKey(0x5EED), step)`."""
    cache = {}

    def make(spec, seed=0, *, device=None):
        step = seed - 0x5EED * 1_000_003
        if (spec, step) not in cache:
            key = jax.random.fold_in(jax.random.PRNGKey(0x5EED), step)
            cache[spec, step] = _carry(spec.family, _jop(spec, key))
        return cache[spec, step]

    monkeypatch.setattr(rp, "make_projector", make)
    return cache


def _np_tree(seed, shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


def _to_torch(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _to_jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# schedule and plain AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 7, 20, 55, 100, 140])
def test_schedule_matches_reference(step):
    kw = dict(peak_lr=3e-3, warmup_steps=20, total_steps=120)
    want = float(jschedule.cosine_with_warmup(jnp.asarray(step), **kw))
    assert schedule.cosine_with_warmup(step, **kw) == pytest.approx(
        want, rel=1e-6, abs=1e-12)
    got = schedule.cosine_with_warmup(torch.tensor(step), **kw)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12)
    assert schedule.constant(torch.tensor(step), peak_lr=0.5) == 0.5


SHAPES = {"w": (3000,), "b": (100, 7), "n": (16,)}


@pytest.mark.parametrize("clip", [None, 1.0, 1e3])
def test_adamw_update_matches_reference(clip):
    params = _np_tree(0, SHAPES)
    grads = _np_tree(1, SHAPES)
    m = _np_tree(2, SHAPES, 0.05)
    v = {k: np.abs(a) * 0.01 for k, a in _np_tree(3, SHAPES).items()}
    cfg = adamw.AdamWConfig(clip_norm=clip)
    jcfg = jadamw.AdamWConfig(clip_norm=clip)
    lr = 1e-3
    jp, jst, jmet = jadamw.update(
        _to_jax(params), _to_jax(grads),
        {"m": _to_jax(m), "v": _to_jax(v), "count": jnp.asarray(4)}, lr,
        jcfg)
    p, st, met = adamw.update(
        _to_torch(params), _to_torch(grads),
        {"m": _to_torch(m), "v": _to_torch(v), "count": torch.tensor(4)}, lr,
        cfg)
    _tree_close(p, jp)
    _tree_close(st["m"], jst["m"])
    _tree_close(st["v"], jst["v"])
    assert int(st["count"]) == int(jst["count"]) == 5
    assert set(met) == set(jmet)
    if clip is not None:
        _close(met["grad_norm"], jmet["grad_norm"])


def test_adamw_state_and_norms():
    params = _to_torch(_np_tree(0, SHAPES))
    st = adamw.init_state(params, adamw.AdamWConfig(
        moment_dtype=torch.bfloat16))
    assert st["m"]["b"].dtype == torch.bfloat16 and int(st["count"]) == 0
    assert all(float(t.abs().sum()) == 0 for t in tree_leaves(st["v"]))
    jparams = _to_jax(_np_tree(0, SHAPES))
    _close(adamw.global_norm(params), jadamw.global_norm(jparams))
    clipped, n = adamw.clip_by_global_norm(params, 1.0)
    _tree_close(clipped, jadamw.clip_by_global_norm(jparams, 1.0)[0])
    assert float(adamw.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


# ---------------------------------------------------------------------------
# K4's plain version, its planner and its ledgers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(16, 32, 24), (8, 6, 4, 10)],
                         ids=["order3", "order4"])
@pytest.mark.parametrize("family", ["tt", "cp"])
def test_fused_plain_matches_reference_kernel(family, dims):
    k, rank, nb = 96, 2, 3
    jspec = jrp.ProjectorSpec(family=family, k=k, dims=dims, rank=rank)
    jop = jrp.make_projector(jspec, jax.random.PRNGKey(0))
    op = _carry(family, jop)
    rng = np.random.default_rng(1)
    y = rng.standard_normal((nb, k)).astype(np.float32)
    p, w, m, v = (rng.standard_normal((nb,) + dims).astype(np.float32)
                  for _ in range(4))
    v = np.abs(v)
    lr, c1, c2 = 1e-3, 0.1, 0.05
    want = jfused.fused_update_buckets(
        jop, jnp.asarray(y), *(jnp.asarray(a) for a in (p, w, m, v)),
        jnp.float32(lr), jnp.float32(c1), jnp.float32(c2), **HP,
        interpret=True)
    before = fused.fused_update_buckets.launches
    got = fused.fused_update_buckets(
        op, torch.tensor(y), *(torch.tensor(a) for a in (p, w, m, v)),
        torch.tensor(lr), torch.tensor(c1), torch.tensor(c2), **HP)
    assert fused.fused_update_buckets.launches == before  # CPU: plain
    for g, r in zip(got, want):
        assert tuple(g.shape) == (nb,) + dims and g.dtype == torch.float32
        _close(g, r)
    plain = fused.fused_update_buckets_plain(
        op, torch.tensor(y), *(torch.tensor(a) for a in (p, w, m, v)),
        lr, c1, c2, **HP)
    for g, r in zip(plain, want):
        _close(g, r)


# (dims, nb, k, rank): ragged as tests/test_torch_kernels.py's
# RECON_TILED_CASES (d1 against the slabs, T against the chunks, nb
# against the batch tiles, 130 in two, k against the depth chunks, ranks
# above 8)
FUSED_TILED_CASES = {2: ((12, 20), 3, 37, 3), 3: ((6, 10, 14), 130, 37, 12),
                     4: ((7, 6, 5, 7), 17, 130, 3),
                     8: ((5, 3, 3, 2, 2, 2, 2, 2), 17, 37, 9)}


@pytest.mark.parametrize("family", ["tt", "cp"])
@pytest.mark.parametrize("order", sorted(FUSED_TILED_CASES))
def test_fused_tiled_schedule_matches_reference_and_plain(family, order):
    """K4's block schedule: K2's (`sweep_reconstruct_tiled_plain`) with
    the EF + AdamW epilogue applied to each finished tile at its elements,
    against the reference's interpret-mode kernel and the plain version:
    every output within 1e-5 of its max|ref| (fp32, other summation
    order)."""
    dims, nb, k, rank = FUSED_TILED_CASES[order]
    jop = jrp.make_projector(jrp.ProjectorSpec(
        family=family, k=k, dims=dims, rank=rank), jax.random.PRNGKey(order))
    op = _carry(family, jop)
    rng = np.random.default_rng(order)
    y = rng.standard_normal((nb, k)).astype(np.float32)
    p, w, m, v = (rng.standard_normal((nb,) + dims).astype(np.float32)
                  for _ in range(4))
    v = np.abs(v)
    lr, c1, c2 = 1e-3, 0.1, 0.05
    want = jfused.fused_update_buckets(
        jop, jnp.asarray(y), *(jnp.asarray(a) for a in (p, w, m, v)),
        jnp.float32(lr), jnp.float32(c1), jnp.float32(c2), **HP,
        interpret=True)
    plain = fused.fused_update_buckets_plain(
        op, torch.tensor(y), *(torch.tensor(a) for a in (p, w, m, v)),
        lr, c1, c2, **HP)
    plan = fused.plan_fused_update(family, k, nb, dims, rank)
    dense = [torch.tensor(a).reshape(nb, dims[0], -1) for a in (p, w, m, v)]
    outs = [torch.full_like(dense[0], float("nan")) for _ in range(4)]
    hp = {key: HP[key] for key in ("b1", "b2", "eps", "weight_decay")}

    def epilogue(index, g):
        vals = fused.update_epilogue(g, *(d[index] for d in dense), lr, c1,
                                     c2, **hp)
        for out, val in zip(outs, vals):
            out[index] = val

    cores = ops.tt_cores_squeezed(op) if family == "tt" else op.factors
    assert _sweep.sweep_reconstruct_tiled_plain(
        torch.tensor(y), *(c.contiguous() for c in cores), plan=plan,
        scale=HP["alpha"] / math.sqrt(k), epilogue=epilogue) is None
    for got, ref_j, ref_p in zip(outs, want, plain):
        got = got.reshape((nb,) + dims).numpy()
        for ref in (np.asarray(ref_j), ref_p.numpy()):
            assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("family", ["tt", "cp"])
def test_plan_fused_update_and_ledgers(family):
    dims, k, b, rank = (64, 16, 16), 128, 8, 2
    plan = fused.plan_fused_update(family, k, b, dims, rank)
    # no surcharge: the epilogue reads its operands from device memory
    assert plan == ops.plan_contraction(family, "reconstruct", k, b, dims,
                                        rank)
    assert plan.smem_bytes <= ops.SMEM_BUDGET_BYTES
    dense = 4 * b * 64 * 16 * 16
    sweep = ops.sweep_hbm_bytes(plan)
    assert fused.fused_hbm_bytes(plan) == sweep - dense + 8 * dense
    assert fused.unfused_hbm_bytes(plan) == sweep + 9 * dense
    assert fused.unfused_hbm_bytes(plan) - fused.fused_hbm_bytes(plan) \
        == 2 * dense
    spec = rp.ProjectorSpec(family, k, dims, rank)
    rp.clear_plan_cache()
    up = rp.plan_update(spec, b)
    un = rp.plan_update(spec, b, fused=False)
    assert (up.kind, up.kernel, up.route) == ("update", "fused_update",
                                              "kernel")
    assert (un.kind, un.kernel, un.route) == ("update-unfused",
                                              "unfused_chain", "torch")
    assert up.cost.hbm_bytes == fused.fused_hbm_bytes(plan)
    assert un.cost.hbm_bytes == fused.unfused_hbm_bytes(plan)
    assert up.tiles == (plan.tk, plan.tb, plan.ba, plan.tc)
    assert up.grid == plan.grid
    assert rp.plan_update(spec, b) is up
    assert rp.plan_cache_stats().hits == 1
    jplan = jrp.plan_update(jrp.ProjectorSpec(family=family, k=k, dims=dims,
                                              rank=rank), b)
    assert up.cost.flops == jplan.cost.flops
    assert up.cost.params == jplan.cost.params
    with pytest.raises(ValueError, match="tt/cp operator"):
        rp.plan_update(rp.ProjectorSpec("gauss", k, dims, rank), b)


def test_fused_typed_errors():
    dims, k = (8, 16, 16), 64
    args = [torch.zeros((2, k))] + [torch.zeros((2,) + dims)] * 4
    scal = [1e-3, 0.1, 0.05]
    with pytest.raises(TypeError, match="TT/CP operator"):
        fused.fused_update_buckets(object(), *args, *scal, **HP)
    big = (2,) * (ops.MAX_ORDER + 1)
    top = rp.make_projector(rp.ProjectorSpec("tt", k, big, 2), 3,
                            device="cpu")
    args9 = [torch.zeros((2, k))] + [torch.zeros((2,) + big)] * 4
    with pytest.raises(ValueError, match="order"):
        fused.fused_update_buckets(top, *args9, *scal, **HP)
    op = rp.make_projector(rp.ProjectorSpec("tt", k, dims, 2), 3,
                           device="cpu")
    with pytest.raises(ValueError, match="bucket operand"):
        fused.fused_update_buckets(op, args[0], torch.zeros((3,) + dims),
                                   *args[2:], *scal, **HP)
    with pytest.raises(TypeError, match="float32"):
        fused.fused_update_buckets(op, args[0], args[1].double(), *args[2:],
                                   *scal, **HP)
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_update_buckets(
            op, args[0], torch.zeros((2, 16, 8, 16)).transpose(1, 2),
            *args[2:], *scal, **HP)
    # a tensor neither on the CPU nor on CUDA has no plain version and no
    # kernel: the wrapper raises
    meta = [torch.empty(a.shape, device="meta") for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        fused.fused_update_buckets(op, *meta, *scal, **HP)


def test_reset_launch_counts_covers_k4():
    fused.fused_update_buckets.launches = 5
    kernels.reset_launch_counts()
    assert fused.fused_update_buckets.launches == 0


# ---------------------------------------------------------------------------
# the sketcher, the compressor and the fused step against the reference
# ---------------------------------------------------------------------------

def _setup(sketch_k=128):
    """The reference's `_setup_tree` (tests/test_fused_update.py) with
    numpy inputs: a TT(2) k=128 (16, 16, 8) compressor, a nonzero EF
    residual and mid-trajectory moments at count 4."""
    shapes = {"w": (3000,), "b": (100, 7)}
    params = _np_tree(10, shapes)
    grads = _np_tree(11, shapes)
    ef = {k: np.full(s, 0.01, np.float32) for k, s in shapes.items()}
    m = {k: a * 0.05 for k, a in params.items()}
    v = {k: np.abs(a) * 0.01 for k, a in params.items()}
    kw = dict(family="tt", k=sketch_k, rank=2, dims=(16, 16, 8),
              bucket_elems=2048)
    jcomp = jcompress.SketchCompressor(jsketch.SketchConfig(**kw))
    comp = SketchCompressor(SketchConfig(**kw))
    jstate = (_to_jax(params), _to_jax(grads), {"residual": _to_jax(ef)},
              {"m": _to_jax(m), "v": _to_jax(v),
               "count": jnp.asarray(4, jnp.int32)})
    state = (_to_torch(params), _to_torch(grads), {"residual": _to_torch(ef)},
             {"m": _to_torch(m), "v": _to_torch(v),
              "count": torch.tensor(4)})
    return comp, jcomp, state, jstate


def test_sketch_config_matches_reference():
    for kw in (dict(), dict(family="cp", k=64, rank=5, dims=(16, 16, 8),
                            bucket_elems=2048)):
        got, want = SketchConfig(**kw), jsketch.SketchConfig(**kw)
        assert got.shrinkage() == pytest.approx(want.shrinkage(), rel=1e-12)
    with pytest.raises(ValueError, match="bucket_elems"):
        SketchConfig(dims=(4, 4), bucket_elems=17)
    with pytest.raises(KeyError, match="unknown RP family"):
        SketchConfig(family="nope")


def test_compress_matches_reference(carried_ops):
    comp, jcomp, (params, grads, ef, opt), (jp, jg, jef, jopt) = _setup()
    g_hat, new_ef, met = comp.compress(grads, ef, step=opt["count"])
    jg_hat, jnew_ef, jmet = jcomp.compress(jg, jef, step=jopt["count"])
    _tree_close(g_hat, jg_hat)
    _tree_close(new_ef["residual"], jnew_ef["residual"])
    assert set(met) == set(jmet)
    for key in met:
        _close(met[key], jmet[key], 1e-5)
    sk = comp._sketcher(grads)
    assert comp._sketcher(grads) is sk  # memoized
    # the default sync is the reference's 'local-mean': dense bytes
    assert comp.wire_bytes(sk) == jcomp.wire_bytes(
        jcomp._sketcher(jg)) == sk.dense_bytes()
    assert comp.compression_ratio(params) == pytest.approx(
        jcomp.compression_ratio(jp))


@pytest.mark.parametrize("family,rank", [("tt", 2), ("cp", 5)])
def test_compressor_wire_bytes_match_reference(family, rank):
    """Under sketch-mean fp32 the payload a worker sends is the fp32
    sketch, as in the reference's ledger."""
    kw = dict(family=family, k=128, rank=rank, dims=(16, 16, 8),
              bucket_elems=2048)
    shapes = {"w": (3000,), "b": (100, 7)}
    comp = SketchCompressor(SketchConfig(**kw), sync="sketch-mean",
                            wire="fp32")
    jcomp = jcompress.SketchCompressor(jsketch.SketchConfig(**kw),
                                       sync="sketch-mean", wire="fp32")
    sk = comp._sketcher(_to_torch(_np_tree(0, shapes)))
    assert comp.wire_bytes(sk) == jcomp.wire_bytes(
        jcomp._sketcher(_to_jax(_np_tree(0, shapes)))) == 3 * 128 * 4


def test_update_sketched_matches_reference(carried_ops):
    comp, jcomp, (params, grads, ef, opt), (jp, jg, jef, jopt) = _setup()
    acfg = adamw.AdamWConfig(clip_norm=None)
    jacfg = jadamw.AdamWConfig(clip_norm=None)
    lr = 1e-3
    with rp.dispatch_stats() as st:
        p, o, e, met = adamw.update_sketched(params, grads, ef, opt, lr,
                                             acfg, compressor=comp)
    jp2, jo2, je2, jmet = jadamw.update_sketched(jp, jg, jef, jopt,
                                                 jnp.float32(lr), jacfg,
                                                 compressor=jcomp)
    _tree_close(p, jp2)
    _tree_close(o["m"], jo2["m"])
    _tree_close(o["v"], jo2["v"])
    _tree_close(e["residual"], je2["residual"])
    assert int(o["count"]) == int(jo2["count"]) == 5
    assert set(met) == set(jmet)
    # the port's ledger over its own tiles: leaves 'b' (1 bucket), 'w' (2)
    assert float(met["fused_hbm_bytes"]) == sum(
        fused.fused_hbm_bytes(fused.plan_fused_update("tt", 128, nb,
                                                      (16, 16, 8), 2))
        for nb in (1, 2))
    # one fused-update dispatch per leaf on the context stats
    assert st.breakdown[("tt", "fused-update", "kernel", 3)] == 2


def test_update_sketched_matches_compress_then_update(carried_ops):
    comp, _, (params, grads, ef, opt), _ = _setup()
    acfg = adamw.AdamWConfig(clip_norm=None)
    g_ref, ef_ref, _ = comp.compress(grads, ef, step=opt["count"])
    p_ref, opt_ref, _ = adamw.update(params, g_ref, opt, 1e-3, acfg)
    p_f, opt_f, ef_f, _ = adamw.update_sketched(params, grads, ef, opt,
                                                1e-3, acfg, compressor=comp)
    for a, b in [(p_ref, p_f), (opt_ref["m"], opt_f["m"]),
                 (opt_ref["v"], opt_f["v"]),
                 (ef_ref["residual"], ef_f["residual"])]:
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            torch.testing.assert_close(x, y, rtol=TOL, atol=TOL)


def test_update_sketched_chained_steps(carried_ops):
    """Two fused steps stay glued to the unfused chain in the port and to
    the reference's two fused steps."""
    comp, jcomp, (params, grads, ef, opt), (jp, jg, jef, jopt) = _setup()
    acfg = adamw.AdamWConfig(clip_norm=None)
    jacfg = jadamw.AdamWConfig(clip_norm=None)
    p_u, opt_u, ef_u = params, opt, ef
    p_f, opt_f, ef_f = params, opt, ef
    for _ in range(2):
        g_hat, ef_u, _ = comp.compress(grads, ef_u, step=opt_u["count"])
        p_u, opt_u, _ = adamw.update(p_u, g_hat, opt_u, 1e-3, acfg)
        p_f, opt_f, ef_f, _ = adamw.update_sketched(
            p_f, grads, ef_f, opt_f, 1e-3, acfg, compressor=comp)
        jp, jopt, jef, _ = jadamw.update_sketched(
            jp, jg, jef, jopt, jnp.float32(1e-3), jacfg, compressor=jcomp)
    for x, y in zip(tree_leaves(p_u), tree_leaves(p_f)):
        torch.testing.assert_close(x, y, rtol=2e-4, atol=2e-4)
    _tree_close(p_f, jp, 2e-4)
    _tree_close(ef_f["residual"], jef["residual"], 2e-4)


def test_update_sketched_typed_errors(carried_ops):
    comp, _, (params, grads, ef, opt), _ = _setup()
    with pytest.raises(ValueError, match="clip_norm=None"):
        adamw.update_sketched(params, grads, ef, opt, 1e-3,
                              adamw.AdamWConfig(), compressor=comp)
    gen = torch.Generator().manual_seed(0)
    struct_g = {"w": random_tt(gen, (16, 16, 8), 2)}
    struct_p = {"w": torch.zeros((2048,))}
    with pytest.raises(ValueError, match="dense gradient leaves only"):
        adamw.update_sketched(
            struct_p, struct_g, {"residual": {"w": torch.zeros((2048,))}},
            adamw.init_state(struct_p, adamw.AdamWConfig(clip_norm=None)),
            1e-3, adamw.AdamWConfig(clip_norm=None), compressor=comp)


def test_sketcher_offsets_match_reference_on_model_tree(carried_ops):
    """Per-leaf bucket offsets in the (n_buckets, k) sketch agree with the
    reference leaf for leaf on the reduced llama3.2-3b parameter tree
    (dicts flattened in sorted-key order); unsketch too."""
    from repro.configs import get_config as jget, reduced as jreduced
    from repro.models import build_model as jbuild
    jmodel = jbuild(jreduced(jget("llama3.2-3b")))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = tree_map(lambda a: torch.tensor(np.asarray(a)),
                       jax.tree.map(np.asarray, jparams))
    kw = dict(family="tt", k=64, rank=2, dims=(4, 8, 16), bucket_elems=512)
    sk, jsk = PytreeSketcher(SketchConfig(**kw), tparams), \
        jsketch.PytreeSketcher(jsketch.SketchConfig(**kw), jparams)
    assert sk._nb == jsk._nb and sk.n_buckets == jsk.n_buckets
    assert [tuple(s) for s in sk._shapes] == [tuple(s) for s in jsk._shapes]
    seed = SketchCompressor(SketchConfig(**kw))._key(3)
    key = jax.random.fold_in(jax.random.PRNGKey(0x5EED), 3)
    y = sk.sketch(tparams, seed)
    jy = jsk.sketch(jparams, key)
    _close(y, jy, 1e-5)
    back = sk.unsketch(y, seed)
    _tree_close(back, jsk.unsketch(jy, key), 1e-5)
    mon = SketchMonitor(sk, seed)
    first = mon.update(tparams)
    assert float(first["sketch_drift"]) == 0.0
    assert float(first["sketch_norm"]) == pytest.approx(
        float(jnp.sqrt(jnp.sum(jy * jy))), rel=1e-5)
    assert float(mon.update(tree_map(lambda t: t * 2, tparams))
                 ["sketch_drift"]) == pytest.approx(
        float(first["sketch_norm"]), rel=1e-5)


# ---------------------------------------------------------------------------
# the compress flag
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag", [
    "tt", "cp:k=64", "tt:k=4096,rank=2", "tt:k=1024,rank=8,dims=4x8x16",
    "tt:k=1024,rank=8,order=4", "cp:k=512,rank=4,dims=16x16x8,order=3",
    "tt:order=5"])
def test_parse_compress_flag_matches_reference(flag):
    got, want = parse_compress_flag(flag), jcompress.parse_compress_flag(flag)
    for f in ("family", "k", "rank", "bucket_elems", "dims",
              "fresh_per_step", "backend"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("flag,match", [
    ("tt:rnak=4", "unknown key 'rnak'"), ("tt:k", "malformed part"),
    ("tt:dims=4x8x16,order=4", "contradicts"),
    ("tt:order=21", "too high"), ("tt:order=0", "positive")])
def test_parse_compress_flag_typed_errors(flag, match):
    with pytest.raises(ValueError, match=match):
        jcompress.parse_compress_flag(flag)
    with pytest.raises(ValueError, match=match):
        parse_compress_flag(flag)


@pytest.mark.parametrize("elems", [2, 512, 2048, 1 << 20])
@pytest.mark.parametrize("order", [1, 2, 3, 4, 5])
def test_balanced_pow2_dims_matches_reference(elems, order):
    try:
        want = jcompress._balanced_pow2_dims(elems, order)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            _balanced_pow2_dims(elems, order)
    else:
        assert _balanced_pow2_dims(elems, order) == want
    with pytest.raises(ValueError, match="power-of-two"):
        _balanced_pow2_dims(elems + 3 if elems > 2 else 6, order)


@pytest.mark.parametrize("family", ["tt", "cp", "gaussian", "sparse"])
def test_sketcher_roundtrip_every_family(family, monkeypatch):
    """The reference's `test_sketcher_roundtrip_every_family` on the port:
    every registered family sketches and unsketches a two-leaf tree
    (gaussian/sparse contract each bucket flat), shapes and dtypes come
    back, and the roundtrip correlates with the tree; then, on the
    reference's operator carried across, the sketch and the roundtrip
    equal the reference's (rtol 3e-5)."""
    kw = dict(family=family, k=256, rank=2, bucket_elems=128,
              dims=(4, 4, 8), backend="torch")
    cfg = SketchConfig(**kw)
    rng = np.random.default_rng(7)
    tree = {"w": rng.standard_normal((24, 24), dtype=np.float32),
            "b": rng.standard_normal((17,), dtype=np.float32)}
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    sk = PytreeSketcher(cfg, ttree)
    recon, y = sk.roundtrip(ttree, 9)
    assert y.shape == (sk.n_buckets, cfg.k)
    for a, b in zip(tree_leaves(recon), tree_leaves(ttree)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert bool(torch.isfinite(a).all())
    flat_r = torch.cat([a.reshape(-1) for a in tree_leaves(recon)])
    flat_t = torch.cat([a.reshape(-1) for a in tree_leaves(ttree)])
    assert float(flat_r @ flat_t / (flat_r.norm() * flat_t.norm())) > 0.2
    # the reference's operator, carried across
    jcfg = jsketch.SketchConfig(**dict(kw, backend="xla"))
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    jsk = jsketch.PytreeSketcher(jcfg, jtree)
    jop = jcfg.operator(jax.random.PRNGKey(9))
    if family in ("tt", "cp"):
        arrays = jop.cores if family == "tt" else jop.factors
        op = from_numpy_operator(family, [np.asarray(a) for a in arrays],
                                 "cpu")
    else:
        op = from_numpy_operator(
            family, [np.asarray(jop._block_mat(b, jnp.float32))
                     for b in range(jop._n_blocks())], "cpu", dim=jop.dim)
    monkeypatch.setattr(SketchConfig, "operator",
                        lambda self, seed, device=None: op)
    recon, y = sk.roundtrip(ttree, 9)
    jrecon, jy = jsk.roundtrip(jtree, jax.random.PRNGKey(9))
    _close(y, jy)
    _tree_close(recon, jrecon)
    assert cfg.operator_params() == jcfg.operator_params()
