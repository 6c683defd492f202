"""mamba2 (`repro_torch.models.mamba2`) against repro's, on the CPU.

Reduced mamba2-1.3b (d_model 64, 2 layers, 8 heads of 16, state 16,
chunk 8, vocab 256) from the reference's own parameters carried across
with `from_numpy_params`; inputs from numpy seeds. Tolerances: the SSD
core (chunked and one step) at rtol = atol = 1e-4, with G = 2 groups so
that `repeat_interleave` (the reference's `jnp.repeat`) shows; the
causal conv helpers at 1e-5; the loss and the gradients as
`tests/test_torch_models.py` (fp32: the loss to 1e-5 relative, each
gradient leaf to 1e-4 of its largest entry; bf16: 1e-3 and 5e-2);
logits of the forward and of every decode step at fp32 to 1e-4, at bf16
to BF16_TOL of the largest |logit| (the two frameworks round their bf16
intermediates in other places). The init kinds (a_log, dt_bias) are held
in distribution only. The reference's results are computed once a
module.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.models import input_specs as jinput_specs
from repro.models import layers as jlayers
from repro.models import mamba2 as jmamba2
from repro_torch.configs import get_config, reduced
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch import steps
from repro_torch.models import build_model, from_numpy_params, input_specs
from repro_torch.models import layers, mamba2
from repro_torch.models.config import ShapeSpec

NAME = "mamba2-1.3b"
SSD_TOL = 1e-4
BF16_TOL = 3e-2
SEQ = 16


@pytest.fixture(scope="module")
def pair():
    """(reference model, port model, reference params, port params)."""
    jm = jbuild_model(jreduced(jget_config(NAME)))
    m = build_model(reduced(get_config(NAME)))
    jp = jm.init(jax.random.PRNGKey(0))
    p = from_numpy_params(m.cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, m, jp, p


def _tokens(vocab, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _ssd_inputs(seed=0, B=2, S=32, H=4, P=8, G=2, N=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x=f(B, S, H, P),
                dt=np.log1p(np.exp(f(B, S, H))).astype(np.float32),
                a=-np.exp(0.3 * f(H)).astype(np.float32),
                bmat=f(B, S, G, N), cmat=f(B, S, G, N), h0=f(B, H, P, N))


@pytest.mark.parametrize("chunk", [4, 8, 32])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(chunk, with_h0):
    d = _ssd_inputs()
    h0 = d["h0"] if with_h0 else None
    y, h = mamba2.ssd_chunked(
        *(torch.tensor(d[k]) for k in ("x", "dt", "a", "bmat", "cmat")),
        chunk=chunk, h0=None if h0 is None else torch.tensor(h0))
    jy, jh = jax.jit(jmamba2.ssd_chunked, static_argnames="chunk")(
        *(jnp.asarray(d[k]) for k in ("x", "dt", "a", "bmat", "cmat")),
        chunk=chunk, h0=None if h0 is None else jnp.asarray(h0))
    assert y.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=SSD_TOL,
                               atol=SSD_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=SSD_TOL,
                               atol=SSD_TOL)


def test_ssd_step_matches_reference_and_the_chunked_form():
    """Every step of the recurrence (G = 2) against the reference's step,
    and the last state and outputs against the chunked form."""
    d = _ssd_inputs(seed=1)
    h, jh = torch.tensor(d["h0"]), jnp.asarray(d["h0"])
    ys = []
    for t in range(d["x"].shape[1]):
        args = [d["x"][:, t], d["dt"][:, t], d["a"], d["bmat"][:, t],
                d["cmat"][:, t]]
        y, h = mamba2.ssd_step(*map(torch.tensor, args), h)
        jy, jh = jax.jit(jmamba2.ssd_step)(*map(jnp.asarray, args), jh)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=SSD_TOL,
                                   atol=SSD_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=SSD_TOL,
                                   atol=SSD_TOL)
        ys.append(y)
    yc, hc = mamba2.ssd_chunked(
        *(torch.tensor(d[k]) for k in ("x", "dt", "a", "bmat", "cmat")),
        chunk=8, h0=torch.tensor(d["h0"]))
    torch.testing.assert_close(torch.stack(ys, 1), yc, rtol=SSD_TOL,
                               atol=SSD_TOL)
    torch.testing.assert_close(h, hc, rtol=SSD_TOL, atol=SSD_TOL)
    with pytest.raises(ValueError, match="does not divide"):
        mamba2.ssd_chunked(*(torch.tensor(d[k]) for k in (
            "x", "dt", "a", "bmat", "cmat")), chunk=5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_helpers_match_reference(dtype):
    """`causal_depthwise_conv1d` and `conv1d_update` (W = 4), at fp32 to
    1e-5 and at bf16 to a bf16 ulp of the largest output; the update's
    token by token outputs equal the whole-sequence conv."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    tx, tw = (torch.tensor(a).to(getattr(torch, dtype)) for a in (x, w))
    jx, jw = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (x, w))
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    got = layers.causal_depthwise_conv1d(tx, tw)
    want = np.asarray(jlayers.causal_depthwise_conv1d(jx, jw), np.float32)
    assert got.dtype == tx.dtype
    top = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * top)
    state, jstate = torch.zeros((2, 3, 6), dtype=tx.dtype), jnp.zeros(
        (2, 3, 6), jx.dtype)
    for t in range(x.shape[1]):
        out, state = layers.conv1d_update(tx[:, t], state, tw)
        jout, jstate = jlayers.conv1d_update(jx[:, t], jstate, jw)
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(jout, np.float32), rtol=tol,
                                   atol=tol * top)
        np.testing.assert_array_equal(state.float().numpy(),
                                      np.asarray(jstate, np.float32))
        torch.testing.assert_close(out, got[:, t], rtol=tol, atol=tol * top)


def test_params_carry_across_and_init_kinds(pair):
    jm, m, jp, p = pair
    jleaves, leaves = jax.tree.leaves(jp), tree_leaves(p)
    assert [tuple(a.shape) for a in leaves] == [a.shape for a in jleaves]
    for a, b in zip(leaves, jleaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    view = m.module(p)
    assert isinstance(view, mamba2.Mamba2)
    assert view.param_tree()["layers"]["in_proj"].data_ptr() == \
        p["layers"]["in_proj"].data_ptr()
    own = m.init(torch.Generator().manual_seed(0))
    assert [tuple(a.shape) for a in tree_leaves(own)] == \
        [a.shape for a in jleaves]
    # a = -exp(a_log), exp(a_log) ~ U[1, 16); softplus(dt_bias) ~
    # log-uniform on [1e-3, 0.1); ones for the norms and the D skip
    big = mamba2.init_params(dataclasses.replace(m.cfg, n_layers=256),
                             torch.Generator().manual_seed(1))
    ea = torch.exp(big["layers"]["a_log"])
    assert 1.0 <= float(ea.min()) and float(ea.max()) < 16.0
    assert abs(float(ea.mean()) - 8.5) < 0.2
    dt = torch.nn.functional.softplus(big["layers"]["dt_bias"])
    assert 1e-3 * (1 - 1e-5) <= float(dt.min()) and float(dt.max()) < 0.1
    assert abs(float(torch.log(dt).mean()) - 0.5 * (math.log(1e-3)
                                                    + math.log(0.1))) < 0.1
    for k in ("norm", "d_skip", "norm_gate"):
        assert bool((own["layers"][k] == 1).all())
    bad = jax.tree.map(np.asarray, jp)
    bad["layers"]["conv_w"] = bad["layers"]["conv_w"][:, :2]
    with pytest.raises(ValueError, match="layers/conv_w"):
        from_numpy_params(m.cfg, bad, device="cpu")


def test_full_config_parameter_count_matches_reference():
    cfg = get_config(NAME)
    got = sum(math.prod(s) for s, *_ in mamba2._spec(cfg).values())
    want = sum(math.prod(a.shape) for a in jax.tree.leaves(
        jbuild_model(jget_config(NAME)).param_shapes()))
    assert got == want == 1_343_740_928


def _reference_loss(jm, jp, toks, labels, dtype):
    """The reference's loss_fn (its hidden states kept) and gradient."""
    def f(p):
        h = jmamba2.forward_hidden(jm.cfg, p, jnp.asarray(toks),
                                   compute_dtype=getattr(jnp, dtype),
                                   remat="none")
        return jlayers.chunked_ce_loss(h, p["embed"].T,
                                       jnp.asarray(labels)), h
    return jax.jit(jax.value_and_grad(f, has_aux=True))(jp)


@pytest.mark.parametrize("dtype,loss_tol,grad_tol", [
    ("float32", 1e-5, 1e-4), ("bfloat16", 1e-3, 5e-2)])
def test_forward_loss_and_grads_match_reference(pair, dtype, loss_tol,
                                                grad_tol):
    jm, m, jp, p = pair
    toks = _tokens(256, 2, SEQ)
    labels = _tokens(256, 2, SEQ, seed=2)
    cd = getattr(torch, dtype)
    (jloss, jh), jgrads = _reference_loss(jm, jp, toks, labels, dtype)
    h = mamba2.forward_hidden(m.cfg, p, torch.tensor(toks), compute_dtype=cd)
    logits = h.float() @ p["embed"].T
    jlogits = np.asarray(jh, np.float32) @ np.asarray(jp["embed"]).T
    top = float(np.abs(jlogits).max())
    tol = SSD_TOL if dtype == "float32" else BF16_TOL * top
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, rtol=tol,
                               atol=tol)
    view = m.module(tree_map(lambda t: t.clone(), p))   # the loss's view
    loss = view({"tokens": torch.tensor(toks),
                 "labels": torch.tensor(labels)}, compute_dtype=cd)
    grads = torch.autograd.grad(loss, tree_leaves(view.param_tree()))
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=loss_tol)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        jg = np.asarray(jg, np.float32)
        assert np.abs(g.float().numpy() - jg).max() <= grad_tol * np.abs(
            jg).max()


@functools.lru_cache(maxsize=None)
def _jdecode(jm, dtype):
    return jax.jit(functools.partial(jm.decode_step,
                                     compute_dtype=getattr(jnp, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_reference_at_every_position(pair, dtype):
    """SEQ decode steps from init_cache: every step's logits against the
    reference's, the state written in place (the same dict back), and
    the final SSM and conv states against the reference's."""
    jm, m, jp, p = pair
    cd = getattr(torch, dtype)
    toks = _tokens(256, 2, SEQ, seed=3)
    cache = m.init_cache(2, SEQ, dtype=cd, device="cpu")
    jc = jm.init_cache(2, SEQ, dtype=getattr(jnp, dtype))
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in cache.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in jc.items()}
    for t in range(SEQ):
        pos = np.full((2,), t, np.int32)
        lg, same = m.decode_step(p, cache, torch.tensor(toks[:, t]),
                                 torch.tensor(pos), compute_dtype=cd)
        assert same is cache
        jl, jc = _jdecode(jm, dtype)(jp, jc, jnp.asarray(toks[:, t]),
                                     jnp.asarray(pos))
        jl = np.asarray(jl)
        tol = SSD_TOL if dtype == "float32" else BF16_TOL * float(
            np.abs(jl).max())
        np.testing.assert_allclose(lg.numpy(), jl, rtol=tol, atol=tol)
    for k in ("ssm", "conv"):
        want = np.asarray(jc[k], np.float32)
        tol = SSD_TOL if dtype == "float32" else BF16_TOL * float(
            np.abs(want).max())
        np.testing.assert_allclose(cache[k].float().numpy(), want, rtol=tol,
                                   atol=tol)


def test_decode_matches_the_forward(pair):
    """The port's decode against its own fp32 forward at the reference's
    2e-3 (`tests/test_models_correctness.py`)."""
    _, m, _, p = pair
    toks = _tokens(256, 2, SEQ, seed=4)
    h = mamba2.forward_hidden(m.cfg, p, torch.tensor(toks),
                              compute_dtype=torch.float32, remat="none")
    full = h @ p["embed"].T
    cache = m.init_cache(2, SEQ, dtype=torch.float32, device="cpu")
    dec = torch.stack([m.decode_step(
        p, cache, torch.tensor(toks[:, t]), torch.full((2,), t),
        compute_dtype=torch.float32)[0] for t in range(SEQ)], 1)
    torch.testing.assert_close(dec, full, rtol=2e-3, atol=2e-3)


def test_prefill_and_serve_steps(pair):
    """`build_prefill_step` (the chunked SSD over 4 chunks) gives the last
    token's logits of the bf16 forward (held against the reference
    above) bit for bit; `build_serve_step` gives the argmax of the
    decode step and advances the cache in place."""
    _, m, _, p = pair
    toks = _tokens(256, 2, 32, seed=5)
    got = steps.build_prefill_step(m, ShapeSpec("p", 32, 2, "prefill"))(
        p, {"tokens": toks})
    h = mamba2.forward_hidden(m.cfg, p, torch.tensor(toks))
    assert torch.equal(got, h[:, -1].float() @ p["embed"].T)
    serve = steps.build_serve_step(m, ShapeSpec("d", 16, 2, "decode"))
    cache = m.init_cache(2, 16, device="cpu")
    tok = torch.tensor(toks[:, 0], dtype=torch.int32)
    ref = m.init_cache(2, 16, device="cpu")
    lg, _ = m.decode_step(p, ref, tok, torch.zeros(2))
    nxt, same = serve(p, cache, tok, torch.zeros(2, dtype=torch.int32))
    assert same is cache and nxt.dtype == torch.int32
    assert torch.equal(nxt, torch.argmax(lg, -1).to(torch.int32))
    assert all(torch.equal(cache[k], ref[k]) for k in cache)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_reference(kind):
    shape = ShapeSpec("s", 64, 2, kind)
    got = input_specs(reduced(get_config(NAME)), shape)
    want = jinput_specs(jreduced(jget_config(NAME)), shape)

    def desc(tree):
        return {k: desc(v) if isinstance(v, dict) else
                (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in tree.items()}
    assert desc(got) == desc(want)
    assert all(t.device.type == "meta" for t in tree_leaves(got))
