"""recurrentgemma (`repro_torch.models.rglru`) against repro's, on the CPU.

Reduced recurrentgemma-2b (d_model 64, 4 layers: one (rec, rec, attn)
group and one tail rec layer; RNN width 64, local window 8, vocab 256)
from the reference's own parameters carried across with
`from_numpy_params`; inputs from numpy seeds. Tolerances: `rglru_scan`
(with and without an initial state) and `rglru_step` at rtol = atol =
1e-5; the loss and the gradients as `tests/test_torch_models.py` (fp32:
the loss to 1e-5 relative, each gradient leaf to 1e-4 of its largest
entry; bf16: the loss to 1e-3); logits of the forward and of every
decode step at fp32 to 1e-4, at bf16 to BF16_TOL of the largest
|logit|. At bf16 this model's rounding noise is larger than the
decoders': the reference's own bf16 gradients lie up to 7.6% (of a
leaf's largest entry) from its fp32 ones, and XLA's bf16 GELU and
sigmoid round differently from torch's in 30-45% of their outputs. So a
bf16 gradient leaf, and a bf16 decode step's logits, are held to the
larger of the fixed bound (5e-2 of the leaf's largest entry, BF16_TOL
of the largest |logit|) and twice the distance between the reference's
own bf16 and fp32 results (`_bf16_bound`). Decode runs past the reduced
window of 8, so the attention layer's ring buffer wraps. The Lambda init
is held in distribution only. The reference's results are computed once
a module.
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
from repro.models import rglru as jrglru
from repro_torch.configs import get_config, reduced
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch import steps
from repro_torch.models import build_model, from_numpy_params, input_specs
from repro_torch.models import rglru
from repro_torch.models.config import ShapeSpec
from repro_torch.models.transformer import EMPTY_POS

NAME = "recurrentgemma-2b"
TOL = 1e-4
SCAN_TOL = 1e-5
BF16_TOL = 3e-2
SEQ = 20          # past the reduced window of 8


@pytest.fixture(scope="module")
def pair():
    """(reference model, port model, reference params, port params)."""
    jm = jbuild_model(jreduced(jget_config(NAME)))
    m = build_model(reduced(get_config(NAME)))
    jp = jm.init(jax.random.PRNGKey(0))
    p = from_numpy_params(m.cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, m, jp, p


@pytest.fixture(scope="module")
def ref():
    """The reference's results, computed once a module (by key)."""
    return {}


def _tokens(vocab, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _scan_inputs(S, seed=0, B=2, dr=8):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sig = lambda a: (1 / (1 + np.exp(-a))).astype(np.float32)  # noqa: E731
    return [f(B, S, dr), sig(f(B, S, dr)), sig(f(B, S, dr)), f(dr),
            f(B, dr)]


@pytest.mark.parametrize("S", [1, 13, 37])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_reference(S, with_h0):
    x, r, i, lam, h0 = _scan_inputs(S)
    h0 = h0 if with_h0 else None
    y, h = rglru.rglru_scan(*map(torch.tensor, (x, r, i, lam)),
                            None if h0 is None else torch.tensor(h0))
    jy, jh = jax.jit(jrglru.rglru_scan)(*map(jnp.asarray, (x, r, i, lam)),
                                        None if h0 is None
                                        else jnp.asarray(h0))
    assert y.shape == (2, S, 8) and h.shape == (2, 8)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=SCAN_TOL,
                               atol=SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=SCAN_TOL,
                               atol=SCAN_TOL)


def test_rglru_step_matches_reference_and_the_scan():
    x, r, i, lam, h0 = _scan_inputs(16, seed=1)
    h, jh = torch.tensor(h0), jnp.asarray(h0)
    jstep = jax.jit(jrglru.rglru_step)
    ys = []
    for t in range(16):
        args = [x[:, t], r[:, t], i[:, t], lam]
        y, h = rglru.rglru_step(*map(torch.tensor, args), h)
        _, jh = jstep(*map(jnp.asarray, args), jh)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=SCAN_TOL,
                                   atol=SCAN_TOL)
        ys.append(y)
    ys_scan, h_scan = rglru.rglru_scan(*map(torch.tensor, (x, r, i, lam)),
                                       torch.tensor(h0))
    torch.testing.assert_close(torch.stack(ys, 1), ys_scan, rtol=SCAN_TOL,
                               atol=SCAN_TOL)
    torch.testing.assert_close(h, h_scan, rtol=SCAN_TOL, atol=SCAN_TOL)


def test_params_carry_across_and_init_kinds(pair):
    jm, m, jp, p = pair
    jleaves, leaves = jax.tree.leaves(jp), tree_leaves(p)
    assert [tuple(a.shape) for a in leaves] == [a.shape for a in jleaves]
    for a, b in zip(leaves, jleaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert sorted(p) == ["embed", "final_norm", "groups", "tail_0"]
    view = m.module(p)
    assert isinstance(view, rglru.Griffin)
    tree = view.param_tree()
    assert tree["groups"]["attn"]["wq"].data_ptr() == \
        p["groups"]["attn"]["wq"].data_ptr()
    assert sum(t.numel() for t in view.parameters()) == sum(
        t.numel() for t in leaves)
    own = m.init(torch.Generator().manual_seed(0))
    assert [tuple(a.shape) for a in tree_leaves(own)] == \
        [a.shape for a in jleaves]
    # a = exp(-8 softplus(Lambda)) ~ U[0.9, 0.999)
    big = rglru.init_params(dataclasses.replace(m.cfg, n_layers=192),
                            torch.Generator().manual_seed(1))
    a = torch.exp(-rglru.RGLRU_C * torch.nn.functional.softplus(
        big["groups"]["rec_a"]["lam"]))          # 64 x 64 draws
    assert 0.9 * (1 - 1e-6) <= float(a.min()) and float(a.max()) < 0.999
    assert abs(float(a.mean()) - 0.9495) < 2e-3
    bad = jax.tree.map(np.asarray, jp)
    bad["tail_0"]["lam"] = bad["tail_0"]["lam"][:4]
    with pytest.raises(ValueError, match="tail_0/lam"):
        from_numpy_params(m.cfg, bad, device="cpu")
    with pytest.raises(ValueError, match="block pattern"):
        rglru._layout(dataclasses.replace(m.cfg,
                                          block_pattern=("rec", "attn")))


def test_full_config_parameter_count_matches_reference():
    cfg = get_config(NAME)
    got = sum(math.prod(s) for s, _ in rglru._spec(cfg).values())
    want = sum(math.prod(a.shape) for a in jax.tree.leaves(
        jbuild_model(jget_config(NAME)).param_shapes()))
    assert got == want == 2_894_574_080


def _bf16_bound(tol, want, want32):
    """A bf16 result's bound: `tol` of the largest |entry| of the
    reference's bf16 result, or twice the reference's own bf16-to-fp32
    distance, whichever is larger."""
    return max(tol * float(np.abs(want).max()),
               2 * float(np.abs(want - want32).max()))


def _reference_loss(ref, jm, jp, dtype):
    """The reference's (hidden states, loss, gradient leaves) on the
    test batch."""
    if ("loss", dtype) in ref:
        return ref["loss", dtype]
    batch = {"tokens": jnp.asarray(_tokens(256, 2, SEQ)),
             "labels": jnp.asarray(_tokens(256, 2, SEQ, seed=2))}

    def f(p):   # the reference's loss_fn, its hidden states kept
        h = jrglru.forward_hidden(jm.cfg, p, batch["tokens"],
                                  compute_dtype=getattr(jnp, dtype),
                                  remat="none")
        return jlayers.chunked_ce_loss(h, p["embed"].T, batch["labels"]), h
    (loss, h), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(jp)
    ref["loss", dtype] = (np.asarray(h, np.float32), float(loss),
                          [np.asarray(g, np.float32)
                           for g in jax.tree.leaves(grads)])
    return ref["loss", dtype]


@pytest.mark.parametrize("dtype,loss_tol,grad_tol", [
    ("float32", 1e-5, 1e-4), ("bfloat16", 1e-3, 5e-2)])
def test_forward_loss_and_grads_match_reference(pair, ref, dtype, loss_tol,
                                                grad_tol):
    """The forward's logits over 20 tokens (the window of 8 masks the
    attention), the loss and every gradient leaf."""
    jm, m, jp, p = pair
    toks = _tokens(256, 2, SEQ)
    labels = _tokens(256, 2, SEQ, seed=2)
    cd = getattr(torch, dtype)
    jh, jloss, jgrads = _reference_loss(ref, jm, jp, dtype)
    h = rglru.forward_hidden(m.cfg, p, torch.tensor(toks), compute_dtype=cd)
    logits = h.float() @ p["embed"].T
    jlogits = jh @ np.asarray(jp["embed"]).T
    tol = TOL if dtype == "float32" else BF16_TOL * float(
        np.abs(jlogits).max())
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=tol, atol=tol)
    view = m.module(tree_map(lambda t: t.clone(), p))   # the loss's view
    loss = view({"tokens": torch.tensor(toks),
                 "labels": torch.tensor(labels)}, compute_dtype=cd)
    grads = torch.autograd.grad(loss, tree_leaves(view.param_tree()))
    assert float(loss.detach()) == pytest.approx(jloss, rel=loss_tol)
    want32 = _reference_loss(ref, jm, jp, "float32")[2]
    for g, jg, jg32 in zip(grads, jgrads, want32):
        bound = (grad_tol * np.abs(jg).max() if dtype == "float32"
                 else _bf16_bound(grad_tol, jg, jg32))
        assert np.abs(g.float().numpy() - jg).max() <= bound


def _reference_decode(ref, jm, jp, dtype):
    """The reference's decode of the test tokens from init_cache, rows at
    positions t and t + 3: (every step's logits, the final cache)."""
    if ("decode", dtype) in ref:
        return ref["decode", dtype]
    step = jax.jit(functools.partial(jm.decode_step,
                                     compute_dtype=getattr(jnp, dtype)))
    toks = _tokens(256, 2, SEQ, seed=3)
    jc = jm.init_cache(2, 64, dtype=getattr(jnp, dtype))
    out = []
    for t in range(SEQ):
        jl, jc = step(jp, jc, jnp.asarray(toks[:, t]),
                      jnp.asarray(np.array([t, t + 3], np.int32)))
        out.append(np.asarray(jl))
    ref["decode", dtype] = out, jax.tree.map(
        lambda a: np.asarray(a, np.float32) if a.dtype != jnp.int32
        else np.asarray(a), jc)
    return ref["decode", dtype]


def _cache_np(tree):
    return {k: _cache_np(v) if isinstance(v, dict) else
            np.asarray(v.float() if v.is_floating_point() else v)
            for k, v in tree.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_reference_at_every_position(pair, ref, dtype):
    """SEQ decode steps from init_cache with the rows at different
    positions (row 1 three ahead): every step's logits against the
    reference's, the cache written in place, and the final recurrent
    states, ring buffer and positions against the reference's."""
    jm, m, jp, p = pair
    cd = getattr(torch, dtype)
    toks = _tokens(256, 2, SEQ, seed=3)
    cache = m.init_cache(2, 64, dtype=cd, device="cpu")
    jc = jm.init_cache(2, 64, dtype=getattr(jnp, dtype))
    assert cache["attn"]["k"].shape[3] == 8
    assert int(cache["attn"]["pos"].min()) == EMPTY_POS
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), jc) == \
        tree_map(lambda t: (tuple(t.shape),
                            str(t.dtype).removeprefix("torch.")), cache)
    want, want_cache = _reference_decode(ref, jm, jp, dtype)
    want32, want32_cache = _reference_decode(ref, jm, jp, "float32")
    for t in range(SEQ):
        pos = np.array([t, t + 3], np.int32)
        lg, same = m.decode_step(p, cache, torch.tensor(toks[:, t]),
                                 torch.tensor(pos), compute_dtype=cd)
        assert same is cache
        tol = TOL if dtype == "float32" else _bf16_bound(
            BF16_TOL, want[t], want32[t])
        np.testing.assert_allclose(lg.numpy(), want[t], rtol=tol, atol=tol)
    got = _cache_np(cache)
    np.testing.assert_array_equal(got["attn"]["pos"],
                                  want_cache["attn"]["pos"])
    for g, w, w32 in zip(jax.tree.leaves(got), jax.tree.leaves(want_cache),
                         jax.tree.leaves(want32_cache)):
        tol = TOL if dtype == "float32" else _bf16_bound(BF16_TOL, w, w32)
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def test_decode_matches_the_forward(pair):
    """The port's decode through the 8-slot ring against its own fp32
    forward over 20 tokens, at the reference's 2e-3."""
    _, m, _, p = pair
    toks = _tokens(256, 2, SEQ, seed=4)
    h = rglru.forward_hidden(m.cfg, p, torch.tensor(toks),
                             compute_dtype=torch.float32, remat="none")
    full = h @ p["embed"].T
    cache = m.init_cache(2, SEQ, dtype=torch.float32, device="cpu")
    dec = torch.stack([m.decode_step(
        p, cache, torch.tensor(toks[:, t]), torch.full((2,), t),
        compute_dtype=torch.float32)[0] for t in range(SEQ)], 1)
    torch.testing.assert_close(dec, full, rtol=2e-3, atol=2e-3)


def test_prefill_and_serve_steps(pair):
    """`build_prefill_step` gives the last token's logits of the bf16
    forward (held against the reference above) bit for bit;
    `build_serve_step` gives the argmax of the decode step and writes
    the cache in place."""
    _, m, _, p = pair
    toks = _tokens(256, 2, 32, seed=5)
    got = steps.build_prefill_step(m, ShapeSpec("p", 32, 2, "prefill"))(
        p, {"tokens": toks})
    h = rglru.forward_hidden(m.cfg, p, torch.tensor(toks))
    assert torch.equal(got, h[:, -1].float() @ p["embed"].T)
    serve = steps.build_serve_step(m, ShapeSpec("d", 16, 2, "decode"))
    cache, ref = (m.init_cache(2, 16, device="cpu") for _ in range(2))
    tok = torch.tensor(toks[:, 0], dtype=torch.int32)
    pos = torch.tensor([0, 5], dtype=torch.int32)
    lg, _ = m.decode_step(p, ref, tok, pos)
    nxt, same = serve(p, cache, tok, pos)
    assert same is cache
    assert torch.equal(nxt, torch.argmax(lg, -1).to(torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cache),
                                                 tree_leaves(ref)))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_reference(kind):
    shape = ShapeSpec("s", 64, 2, kind)
    got = input_specs(reduced(get_config(NAME)), shape)
    want = jinput_specs(jreduced(jget_config(NAME)), shape)
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), want) == \
        tree_map(lambda t: (tuple(t.shape),
                            str(t.dtype).removeprefix("torch.")), got)
    assert all(t.device.type == "meta" for t in tree_leaves(got))
