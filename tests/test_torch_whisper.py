"""whisper (`repro_torch.models.whisper`) against repro's, on the CPU.

Reduced whisper-medium (d_model 64, 2 encoder and 2 decoder layers, 4
heads of 16, 12 encoder frames, vocab 256) from the reference's own
parameters carried across with `from_numpy_params`; frames and tokens
from numpy seeds. Tolerances: `layer_norm`, `gelu_mlp` and `sinusoidal`
at rtol = atol = 1e-5; `encode`, `build_cross_cache`, the decoder's
logits and every decode step's at fp32 to 1e-4, at bf16 to BF16_TOL of
the largest |entry|; the loss and the gradients as
`tests/test_torch_models.py` (fp32: the loss to 1e-5 relative, each
gradient leaf to 1e-4 of its largest entry; bf16: 1e-3 and 5e-2). The
reference's results are computed once a module.
"""
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
from repro.models import whisper as jwhisper
from repro_torch.configs import get_config, reduced
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch import steps
from repro_torch.models import build_model, from_numpy_params, input_specs
from repro_torch.models import layers, whisper
from repro_torch.models.config import ShapeSpec

NAME = "whisper-medium"
TOL = 1e-4
LAYER_TOL = 1e-5
BF16_TOL = 3e-2
SEQ = 12


@pytest.fixture(scope="module")
def pair():
    """(reference model, port model, reference params, port params)."""
    jm = jbuild_model(jreduced(jget_config(NAME)))
    m = build_model(reduced(get_config(NAME)))
    jp = jm.init(jax.random.PRNGKey(0))
    p = from_numpy_params(m.cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, m, jp, p


def _tokens(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (b, s))


def _frames(b, seed=2):
    cfg = reduced(get_config(NAME))
    return (0.3 * np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model))).astype(np.float32)


def _close(got, want, tol, *, rel_to_max=False):
    want = np.asarray(want, np.float32)
    got = (got.float() if isinstance(got, torch.Tensor) else got)
    if rel_to_max:
        tol = tol * float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_gelu_mlp_and_sinusoidal_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((2, 5, 16)) + 1).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * c for s, c in (
        ((16,), 1.0), ((16,), 1.0), ((16, 24), 0.25), ((24,), 1.0),
        ((24, 16), 0.2), ((16,), 1.0))]
    cd, jcd = getattr(torch, dtype), getattr(jnp, dtype)
    tx, jx = torch.tensor(x).to(cd), jnp.asarray(x).astype(jcd)
    tw = [torch.tensor(w).to(cd) for w in ws]
    jw = [jnp.asarray(w).astype(jcd) for w in ws]
    bf16 = dtype == "bfloat16"
    got = layers.layer_norm(tx, tw[0], tw[1])
    assert got.dtype == cd
    _close(got, jlayers.layer_norm(jx, jw[0], jw[1]),
           BF16_TOL if bf16 else LAYER_TOL, rel_to_max=bf16)
    got = layers.gelu_mlp(tx, *tw[2:])
    _close(got, jlayers.gelu_mlp(jx, *jw[2:]),
           BF16_TOL if bf16 else LAYER_TOL, rel_to_max=bf16)
    _close(whisper.sinusoidal(12, 16, cd),
           jwhisper.sinusoidal(12, 16, jcd),
           BF16_TOL if bf16 else LAYER_TOL, rel_to_max=bf16)


def test_params_carry_across_and_module(pair):
    jm, m, jp, p = pair
    jleaves, leaves = jax.tree.leaves(jp), tree_leaves(p)
    assert [tuple(a.shape) for a in leaves] == [a.shape for a in jleaves]
    for a, b in zip(leaves, jleaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert "bk" not in p["dec"] and "x_bk" not in p["dec"]
    view = m.module(p)
    assert isinstance(view, whisper.Whisper)
    assert view.param_tree()["enc"]["wq"].data_ptr() == \
        p["enc"]["wq"].data_ptr()
    own = m.init(torch.Generator().manual_seed(0))
    assert [tuple(a.shape) for a in tree_leaves(own)] == \
        [a.shape for a in jleaves]
    assert bool((own["dec"]["x_ln_w"] == 1).all())
    assert bool((own["dec"]["x_ln_b"] == 0).all())
    bad = jax.tree.map(np.asarray, jp)
    bad["dec"]["x_wk"] = bad["dec"]["x_wk"][:, :, :8]
    with pytest.raises(ValueError, match="dec/x_wk"):
        from_numpy_params(m.cfg, bad, device="cpu")


def test_full_config_parameter_count_matches_reference():
    cfg = get_config(NAME)
    got = sum(math.prod(s) for s, *_ in whisper._spec(cfg).values())
    want = sum(math.prod(a.shape) for a in jax.tree.leaves(
        jbuild_model(jget_config(NAME)).param_shapes()))
    assert got == want == 758_469_632


@pytest.fixture(scope="module")
def ref():
    """The reference's results, computed once a module (by key)."""
    return {}


def _reference(ref, jm, jp, dtype):
    """The reference's (encoder output, decoder hidden states, loss,
    gradient leaves) on the test batch."""
    if dtype in ref:
        return ref[dtype]
    cd = getattr(jnp, dtype)
    batch = {"tokens": jnp.asarray(_tokens(2, SEQ)),
             "labels": jnp.asarray(_tokens(2, SEQ, seed=3)),
             "frames": jnp.asarray(_frames(2))}

    def f(p):   # the reference's loss_fn, its intermediates kept
        enc = jwhisper.encode(jm.cfg, p, batch["frames"], compute_dtype=cd,
                              remat="none")
        h = jwhisper.decode_hidden(jm.cfg, p, batch["tokens"], enc,
                                   compute_dtype=cd, remat="none")
        loss = jlayers.chunked_ce_loss(h, p["embed"].T, batch["labels"])
        return loss, (enc, h)
    (loss, (enc, h)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jp)
    ref[dtype] = (np.asarray(enc, np.float32), np.asarray(h, np.float32),
                  float(loss), [np.asarray(g, np.float32)
                                for g in jax.tree.leaves(grads)])
    return ref[dtype]


@pytest.mark.parametrize("dtype,loss_tol,grad_tol", [
    ("float32", 1e-5, 1e-4), ("bfloat16", 1e-3, 5e-2)])
def test_encode_decode_loss_and_grads_match_reference(pair, ref, dtype,
                                                      loss_tol, grad_tol):
    """`encode` (non-causal), `decode_hidden`'s logits (causal self- and
    full cross-attention), the loss through the module view, and every
    gradient leaf."""
    jm, m, jp, p = pair
    cd = getattr(torch, dtype)
    jenc, jh, jloss, jgrads = _reference(ref, jm, jp, dtype)
    bf16 = dtype == "bfloat16"
    toks, frames = torch.tensor(_tokens(2, SEQ)), torch.tensor(_frames(2))
    enc = whisper.encode(m.cfg, p, frames, compute_dtype=cd)
    assert enc.dtype == cd
    _close(enc, jenc, BF16_TOL if bf16 else TOL, rel_to_max=bf16)
    h = whisper.decode_hidden(m.cfg, p, toks, enc, compute_dtype=cd)
    _close(h.float() @ p["embed"].T, jh @ np.asarray(jp["embed"]).T,
           BF16_TOL if bf16 else TOL, rel_to_max=bf16)
    view = m.module(tree_map(lambda t: t.clone(), p))   # the loss's view
    loss = view({"tokens": toks, "frames": frames,
                 "labels": torch.tensor(_tokens(2, SEQ, seed=3))},
                compute_dtype=cd)
    grads = torch.autograd.grad(loss, tree_leaves(view.param_tree()))
    assert float(loss.detach()) == pytest.approx(jloss, rel=loss_tol)
    for g, jg in zip(grads, jgrads):
        assert np.abs(g.float().numpy() - jg).max() <= grad_tol * np.abs(
            jg).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_cache_and_decode_match_reference(pair, dtype):
    """`build_cross_cache` on the reference's encoder output, then SEQ
    decode steps (row 1 two positions ahead): the cross K/V, every
    step's logits and the final self-attention cache against the
    reference's, the cache written in place."""
    jm, m, jp, p = pair
    cd, jcd = getattr(torch, dtype), getattr(jnp, dtype)
    bf16 = dtype == "bfloat16"
    frames = jnp.asarray(_frames(2, seed=4))
    jenc = jax.jit(functools.partial(jwhisper.encode, jm.cfg,
                                     compute_dtype=jcd))(jp, frames)
    jc = jm.init_cache(2, SEQ + 2, dtype=jcd)
    jc = jax.jit(functools.partial(jwhisper.build_cross_cache, jm.cfg,
                                   compute_dtype=jcd))(jp, jenc, jc)
    cache = m.init_cache(2, SEQ + 2, dtype=cd, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in cache.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in jc.items()}
    same = whisper.build_cross_cache(
        m.cfg, p, torch.tensor(np.asarray(jenc, np.float32)).to(cd), cache,
        compute_dtype=cd)
    assert same is cache
    for k in ("xk", "xv"):
        _close(cache[k], jc[k], BF16_TOL if bf16 else TOL, rel_to_max=bf16)
    step = jax.jit(functools.partial(jm.decode_step, compute_dtype=jcd))
    toks = _tokens(2, SEQ, seed=5)
    for t in range(SEQ):
        pos = np.array([t, t + 2], np.int32)
        lg, same = m.decode_step(p, cache, torch.tensor(toks[:, t]),
                                 torch.tensor(pos), compute_dtype=cd)
        assert same is cache
        jl, jc = step(jp, jc, jnp.asarray(toks[:, t]), jnp.asarray(pos))
        _close(lg, jl, BF16_TOL if bf16 else TOL, rel_to_max=bf16)
    for k in ("k", "v"):
        _close(cache[k], jc[k], BF16_TOL if bf16 else TOL, rel_to_max=bf16)


def test_decode_matches_decode_hidden(pair):
    """The port's decode through its cache against its own fp32
    `decode_hidden` at the reference's 2e-3."""
    _, m, _, p = pair
    toks = torch.tensor(_tokens(2, SEQ, seed=6))
    enc = whisper.encode(m.cfg, p, torch.tensor(_frames(2, seed=7)),
                         compute_dtype=torch.float32, remat="none")
    h = whisper.decode_hidden(m.cfg, p, toks, enc,
                              compute_dtype=torch.float32, remat="none")
    full = h @ p["embed"].T
    cache = m.init_cache(2, SEQ, dtype=torch.float32, device="cpu")
    whisper.build_cross_cache(m.cfg, p, enc, cache,
                              compute_dtype=torch.float32)
    dec = torch.stack([m.decode_step(
        p, cache, toks[:, t], torch.full((2,), t),
        compute_dtype=torch.float32)[0] for t in range(SEQ)], 1)
    torch.testing.assert_close(dec, full, rtol=2e-3, atol=2e-3)


def test_prefill_and_serve_steps(pair):
    """`build_prefill_step` with frames gives the last token's logits of
    `encode` then `decode_hidden` at bf16 (held against the reference
    above) bit for bit; `build_serve_step` on a cache whose cross K/V
    are filled gives the argmax of the decode step. Without frames the
    prefill step raises."""
    _, m, _, p = pair
    toks, frames = _tokens(2, SEQ, seed=8), _frames(2, seed=9)
    pstep = steps.build_prefill_step(m, ShapeSpec("p", SEQ, 2, "prefill"))
    got = pstep(p, {"tokens": toks, "frames": frames})
    h = whisper.decode_hidden(m.cfg, p, torch.tensor(toks), whisper.encode(
        m.cfg, p, torch.tensor(frames)))
    assert torch.equal(got, h[:, -1].float() @ p["embed"].T)
    with pytest.raises(KeyError, match="frames"):
        pstep(p, {"tokens": toks})
    serve = steps.build_serve_step(m, ShapeSpec("d", SEQ, 2, "decode"))
    cache, ref = (whisper.build_cross_cache(
        m.cfg, p, whisper.encode(m.cfg, p, torch.tensor(frames)),
        m.init_cache(2, SEQ, device="cpu")) for _ in range(2))
    tok = torch.tensor(toks[:, 0], dtype=torch.int32)
    pos = torch.tensor([0, 3], dtype=torch.int32)
    lg, _ = m.decode_step(p, ref, tok, pos)
    nxt, same = serve(p, cache, tok, pos)
    assert same is cache
    assert torch.equal(nxt, torch.argmax(lg, -1).to(torch.int32))
    assert all(torch.equal(cache[k], ref[k]) for k in cache)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_reference(kind):
    """The audio frames (B, encoder_seq, D) float32 join the train and
    prefill cells; a decode cell carries the self- and cross-attention
    cache."""
    shape = ShapeSpec("s", 64, 2, kind)
    got = input_specs(reduced(get_config(NAME)), shape)
    want = jinput_specs(jreduced(jget_config(NAME)), shape)
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), want) == \
        tree_map(lambda t: (tuple(t.shape),
                            str(t.dtype).removeprefix("torch.")), got)
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    assert ("frames" in got) == (kind != "decode")
