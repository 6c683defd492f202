"""The port's MoE FFN (`repro_torch.models.moe`) against repro's.

The same numpy inputs go through the reference's `moe_ffn` and the
port's: at fp32 within 1e-5 of the largest |output| (float32 on both
sides, other summation orders), at bf16 within BF16_TOL of it. Cases:
the reference's three MoE tests (`tests/test_models_correctness.py`:
dispatch against the dense per-token evaluation, groups 1 against 4,
capacity drops), random routing at the published capacity factor 1.25
where pairs drop (groups 1, 2 and 4), `moe_capacity`, `moe_aux_loss`,
a router softcap, arctic's 128 experts at fp32 and bf16, a reduced
arctic layer's FFN with its dense residual,
and one compressed train step of reduced mixtral against the reference's
mesh-free composition.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import sketch as jsketch
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch.configs import get_config, reduced
from repro_torch.core.sketch import SketchConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import steps
from repro_torch.models import build_model, moe, transformer
from repro_torch.models.config import MoESpec, ShapeSpec
from repro_torch.models.transformer import from_numpy_params
from repro_torch.optim import schedule
from repro_torch.optim.compress import SketchCompressor

TOL = 1e-5
BF16_TOL = 3e-2


def _weights(seed, T, D, E, F, scale=0.2):
    r = np.random.default_rng(seed)
    x = r.standard_normal((T, D)).astype(np.float32)
    ws = [r.standard_normal(s).astype(np.float32) * w for s, w in (
        ((D, E), 1.0), ((E, D, F), scale), ((E, D, F), scale),
        ((E, F, D), scale))]
    return x, ws


# one compile a (spec, capacity, groups), not one an op
_jmoe_ffn = jax.jit(jmoe.moe_ffn, static_argnames=("spec", "capacity",
                                                   "groups"))


def _both(x, ws, spec, **kw):
    """(port, reference) outputs as numpy float32 on the same inputs."""
    got = moe.moe_ffn(torch.tensor(x), *map(torch.tensor, ws), spec, **kw)
    want = _jmoe_ffn(jnp.asarray(x), *map(jnp.asarray, ws), spec=spec, **kw)
    return (got.to(torch.float32).numpy(),
            np.asarray(want.astype(jnp.float32)))


def _close(got, want, tol):
    top = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * top)


def _kept_pairs(x, router, spec, groups):
    """How many (token, k) pairs fit their expert's capacity, counted in
    numpy from the router's choices (the reference's rule)."""
    T = x.shape[0]
    Tg = T // groups
    C = jmoe.moe_capacity(spec, Tg)
    ids = np.argsort(-(x @ router), axis=-1, kind="stable")[:, :spec.top_k]
    kept = 0
    for g in range(groups):
        counts = np.bincount(ids[g * Tg:(g + 1) * Tg].reshape(-1),
                             minlength=spec.num_experts)
        kept += np.minimum(counts, C).sum()
    return kept


def test_moe_dispatch_matches_dense_reference():
    """With ample capacity the dispatch equals the explicit per-token
    top-k expert evaluation, and the reference's output."""
    spec = MoESpec(num_experts=4, top_k=2, d_ff_expert=16,
                   capacity_factor=8.0)
    x, ws = _weights(0, 24, 8, 4, 16)
    got, want = _both(x, ws, spec)
    _close(got, want, TOL)
    rw, wg, wu, wd = map(torch.tensor, ws)
    xt = torch.tensor(x)
    vals, ids = torch.topk(xt @ rw, 2, dim=-1)
    gates = torch.softmax(vals, -1)
    dense = torch.zeros_like(xt)
    for t in range(24):
        for j in range(2):
            e = int(ids[t, j])
            h = torch.nn.functional.silu(xt[t] @ wg[e]) * (xt[t] @ wu[e])
            dense[t] += gates[t, j] * (h @ wd[e])
    _close(got, dense.numpy(), 1e-4)


def test_moe_groups_consistency():
    """groups=1 and groups=4 agree when capacity is ample per group."""
    spec = MoESpec(num_experts=4, top_k=2, d_ff_expert=16,
                   capacity_factor=8.0)
    x, ws = _weights(1, 32, 8, 4, 16)
    o1, want1 = _both(x, ws, spec, groups=1)
    o4, want4 = _both(x, ws, spec, groups=4)
    _close(o1, want1, TOL)
    _close(o4, want4, TOL)
    _close(o4, o1, 1e-4)


def test_moe_capacity_drops_tokens():
    """Over capacity, later tokens drop (outputs zero for the dropped):
    every token routes to expert 0, the last expert stays empty."""
    spec = MoESpec(num_experts=2, top_k=1, d_ff_expert=8,
                   capacity_factor=0.25)
    T, D = 16, 4
    x = np.ones((T, D), np.float32)
    rw = np.zeros((D, 2), np.float32)
    rw[:, 0] = 1.0
    ws = [rw, np.full((2, D, 8), 0.1, np.float32),
          np.full((2, D, 8), 0.1, np.float32),
          np.full((2, 8, D), 0.1, np.float32)]
    got, want = _both(x, ws, spec)
    _close(got, want, TOL)
    nonzero = int((np.abs(got) > 1e-8).any(-1).sum())
    assert nonzero == moe.moe_capacity(spec, T) == jmoe.moe_capacity(spec, T)
    # and everything routed to the last expert: its drops hit index E*C,
    # which the reference's scatter drops and the port's trash row takes
    rw2 = rw[:, ::-1].copy()
    got, want = _both(x, [rw2] + ws[1:], spec)
    _close(got, want, TOL)
    assert int((np.abs(got) > 1e-8).any(-1).sum()) == moe.moe_capacity(
        spec, T)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_moe_random_routing_drops_like_reference(groups):
    """Random routing at the published capacity factor 1.25: some
    (token, k) pairs drop, the same ones as the reference's."""
    spec = MoESpec(num_experts=8, top_k=2, d_ff_expert=32)
    x, ws = _weights(10 + groups, 64, 16, 8, 32)
    assert _kept_pairs(x, ws[0], spec, groups) < 64 * 2   # pairs drop
    got, want = _both(x, ws, spec, groups=groups)
    _close(got, want, TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("capacity", [None, 64])
def test_moe_many_experts_match_reference(capacity, groups, dtype):
    """arctic's 128 experts top-2: at the published capacity factor most
    experts hold at most one slot and pairs drop, also from the last
    expert (the trash row); at the full capacity of a group's tokens
    (decode's) none drop."""
    spec = MoESpec(num_experts=128, top_k=2, d_ff_expert=8)
    x, ws = _weights(20 + groups, 128, 16, 128, 8)
    if capacity is None:
        assert _kept_pairs(x, ws[0], spec, groups) < 128 * 2
    cap = None if capacity is None else capacity // groups
    if dtype == "float32":
        got, want = _both(x, ws, spec, groups=groups, capacity=cap)
        _close(got, want, TOL)
        return
    got = moe.moe_ffn(*(torch.tensor(a).to(torch.bfloat16)
                        for a in [x] + ws), spec, groups=groups,
                      capacity=cap)
    want = _jmoe_ffn(*(jnp.asarray(a).astype(jnp.bfloat16)
                       for a in [x] + ws), spec=spec, groups=groups,
                     capacity=cap)
    _close(got.to(torch.float32).numpy(),
           np.asarray(want.astype(jnp.float32)), BF16_TOL)


def test_moe_bf16_matches_reference():
    spec = MoESpec(num_experts=8, top_k=2, d_ff_expert=32)
    x, ws = _weights(5, 48, 16, 8, 32)
    got = moe.moe_ffn(*(torch.tensor(a).to(torch.bfloat16)
                        for a in [x] + ws), spec, groups=2)
    want = _jmoe_ffn(*(jnp.asarray(a).astype(jnp.bfloat16)
                       for a in [x] + ws), spec=spec, groups=2)
    assert got.dtype == torch.bfloat16
    _close(got.to(torch.float32).numpy(),
           np.asarray(want.astype(jnp.float32)), BF16_TOL)


def test_moe_router_softcap_and_full_capacity():
    spec = MoESpec(num_experts=4, top_k=2, d_ff_expert=16,
                   router_softcap=2.0)
    x, ws = _weights(7, 12, 8, 4, 16)
    got, want = _both(x, ws, spec, capacity=12)
    _close(got, want, TOL)
    with pytest.raises(ValueError, match="groups"):
        moe.moe_ffn(torch.tensor(x), *map(torch.tensor, ws), spec, groups=5)


@pytest.mark.parametrize("E,K,cf", [(8, 2, 1.25), (128, 2, 1.25),
                                    (4, 1, 0.25), (4, 2, 4.0)])
def test_moe_capacity_matches_reference(E, K, cf):
    spec = MoESpec(num_experts=E, top_k=K, d_ff_expert=8,
                   capacity_factor=cf)
    for n in (1, 4, 17, 64, 4096):
        assert moe.moe_capacity(spec, n) == jmoe.moe_capacity(spec, n)


def test_moe_aux_loss_matches_reference():
    spec = MoESpec(num_experts=8, top_k=2, d_ff_expert=8)
    x, ws = _weights(3, 40, 16, 8, 8)
    got = moe.moe_aux_loss(torch.tensor(x), torch.tensor(ws[0]), spec)
    want = jmoe.moe_aux_loss(jnp.asarray(x), jnp.asarray(ws[0]), spec)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@functools.lru_cache(maxsize=None)
def _reduced_pair(name):
    """(reference config, port config, reference params, port params) of
    the reduced model, the reference's params carried across."""
    jcfg, cfg = jreduced(jget_config(name)), reduced(get_config(name))
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jp, from_numpy_params(
        cfg, jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("name", ["arctic-480b", "mixtral-8x22b"])
def test_reduced_layer_ffn_matches_reference(name, full):
    """A reduced layer's FFN (arctic: the MoE plus its dense residual) on
    the reference's layer-0 weights, through the port's and the
    reference's `_ffn`, at fp32; the leaves are the reference's."""
    jcfg, cfg, jp, p = _reduced_pair(name)
    assert set(p["layers"]) == set(jp["layers"])
    if cfg.moe.dense_residual_ff:
        assert {"w_gate", "w_up", "w_down", "router"} <= set(p["layers"])
    h = np.random.default_rng(2).standard_normal((2, 8, cfg.d_model)).astype(
        np.float32)
    lp = {k: v[0] for k, v in p["layers"].items()}
    jlp = {k: v[0] for k, v in jp["layers"].items()}
    got = transformer._ffn(cfg, lp, torch.tensor(h), full_capacity=full)
    want = jtransformer._ffn(jcfg, jlp, jnp.asarray(h), moe_groups=1,
                             full_capacity=full)
    _close(got.numpy(), np.asarray(want), 1e-4)


def test_mixtral_compressed_train_step_matches_reference_composition(
        monkeypatch):
    """One compressed train step of reduced mixtral against the
    reference's single-pod composition, `jax.value_and_grad(loss_fn)` ->
    `compress` -> `adamw.update`, the reference's operator carried
    across; fp32 compute, one dispatch group (no mesh). The loss within
    1e-5 relative, m, v and the EF residual within 1e-4 of each leaf's
    largest entry, the params within 0.25 learning rates."""
    from repro.rp import ProjectorSpec as JSpec
    from repro.rp import make_projector as jmake
    from repro_torch import rp
    from repro_torch.core import from_numpy_operator
    sk = dict(family="tt", k=256, rank=4, bucket_elems=4 * 8 * 16,
              dims=(4, 8, 16))

    def make(spec, seed=0, *, device=None):
        key = jax.random.fold_in(jax.random.PRNGKey(0x5EED),
                                 seed - 0x5EED * 1_000_003)
        jop = jmake(JSpec(family=spec.family, k=spec.k, dims=spec.dims,
                          rank=spec.rank), key)
        return from_numpy_operator(spec.family,
                                   [np.asarray(a) for a in jop.cores], "cpu")
    monkeypatch.setattr(rp, "make_projector", make)
    jm = jbuild_model(jreduced(jget_config("mixtral-8x22b")))
    m = build_model(reduced(get_config("mixtral-8x22b")))
    jcomp = jcompress.SketchCompressor(jsketch.SketchConfig(**sk))
    jopt_cfg = jadamw.AdamWConfig()
    jparams = jm.init(jax.random.PRNGKey(0))
    jopt = jadamw.init_state(jparams, jopt_cfg)
    jef = jcomp.init_state(jparams)
    state = steps.from_numpy_state(m, jax.tree.map(np.asarray, {
        "params": jparams, "opt": jopt, "ef": jef}), device="cpu")
    step_fn = steps.build_train_step(
        m, ShapeSpec("t", 16, 4, "train"),
        compressor=SketchCompressor(SketchConfig(**sk)),
        lr_fn=functools.partial(schedule.constant, peak_lr=3e-3),
        device="cpu", compute_dtype=torch.float32)
    batch = SyntheticLM(DataConfig(vocab=256, seq_len=16,
                                   global_batch=4)).batch(0)

    @jax.jit    # one compile, not one an op
    def jstep(jparams, jopt, jef, jb):
        jloss, jgrads = jax.value_and_grad(lambda p: jm.loss_fn(
            p, jb, compute_dtype=jnp.float32))(jparams)
        jgrads, jef, _ = jcomp.compress(jgrads, jef, step=jopt["count"])
        jparams, jopt, _ = jadamw.update(jparams, jgrads, jopt,
                                         jnp.float32(3e-3), jopt_cfg)
        return jloss, jparams, jopt, jef

    jloss, jparams, jopt, jef = jstep(
        jparams, jopt, jef, {k: jnp.asarray(v) for k, v in batch.items()})
    state, met = step_fn(state, batch)
    assert float(met["loss"]) == pytest.approx(float(jloss), rel=1e-5)
    assert {"router", "we_gate", "we_up", "we_down"} <= set(
        state["params"]["layers"])
    for tree, jtree in ((state["opt"]["m"], jopt["m"]),
                        (state["opt"]["v"], jopt["v"]),
                        (state["ef"]["residual"], jef["residual"])):
        for a, b in zip(tree_leaves(tree), jax.tree.leaves(jtree)):
            b = np.asarray(b, np.float32)
            assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max()
    # AdamW's first step is about g / (|g| + 1e-8): an entry of the
    # gradient estimate near 1e-8 moves its param by a large part of lr
    # on a last-digit difference (measured: at most 0.0055 lr)
    for a, b in zip(tree_leaves(state["params"]), jax.tree.leaves(jparams)):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 0.25 * 3e-3


def test_lean_policy_keeps_arctic_params_bf16():
    """Under arctic's 'lean' policy `init_train_state` and
    `from_numpy_state` (from the reference's lean state) hold the params
    and moments in bf16, and the prefill and serve steps make no float32
    copy of a layer's weight matrices (the router's, a (D, E) matrix the
    reference also routes in float32, and the norm vectors aside): at
    full width one such copy of an expert leaf is 17.8 GB."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro.launch import steps as jsteps
    cfg = reduced(get_config("arctic-480b"))
    m = build_model(cfg)
    state = steps.init_train_state(m, torch.Generator().manual_seed(0))
    jstate = jsteps.init_train_state(
        jbuild_model(jreduced(jget_config("arctic-480b"))),
        jax.random.PRNGKey(0))
    carried = steps.from_numpy_state(m, jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), jstate), device="cpu")
    for st in (state, carried):
        for tree in (st["params"], st["opt"]["m"], st["opt"]["v"]):
            assert {t.dtype for t in tree_leaves(tree)} == {torch.bfloat16}
    params = carried["params"]
    leaf_of = {t.untyped_storage().data_ptr(): k
               for k, t in params["layers"].items()}
    copies = []

    class Casts(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (func.overloadpacket in (torch.ops.aten._to_copy,
                                        torch.ops.aten.to)
                    and out.dtype == torch.float32
                    and args[0].dtype != torch.float32):
                copies.append(leaf_of.get(
                    args[0].untyped_storage().data_ptr()))
            return out

    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8))
    with Casts():
        logits = steps.build_prefill_step(m, ShapeSpec("p", 8, 2, "prefill"))(
            params, {"tokens": toks})
        serve = steps.build_serve_step(m, ShapeSpec("d", 16, 2, "decode"))
        cache = m.init_cache(2, 16, device="cpu")
        nxt, _ = serve(params, cache, torch.tensor(toks[:, 0]),
                       torch.zeros(2, dtype=torch.int32))
    assert "router" in copies           # the mode sees the casts
    assert {c for c in copies if c is not None} <= {"router", "norm1",
                                                     "norm2"}
    assert logits.dtype == torch.float32 and nxt.shape == (2,)
    assert {t.dtype for t in tree_leaves(params)} == {torch.bfloat16}
