"""The port's KV-cache decode path against repro's.

The dense decoders (llama3.2-3b, gemma2-9b, qwen1.5-110b, deepseek-67b)
and the MoE decoders (mixtral-8x22b; arctic-480b under its 'lean'
policy, its parameters carried across as bf16) in their reduced form,
each from the reference's own parameters carried across as numpy: `cache_len`, `init_cache`, `prefill` and a run of
`decode_step`s (per-row positions, the cache written in place) against
the reference's at fp32 compute within rtol = atol = 1e-4; the same at
bf16 compute within BF16_TOL of the largest logit (the two programs
round their bf16 intermediates in other places); decode against the
port's own full forward at the reference's decode tolerance 2e-3
(`tests/test_models_correctness.py`); a ring buffer past its window
(and mixtral's, the reference's `test_swa_ring_buffer_beyond_window`);
gemma2's loss; the prefill and serve steps against the reference's
mesh-free composition; and the configs field by field.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.launch import steps
from repro_torch.models import build_model, transformer
from repro_torch.models.config import ShapeSpec
from repro_torch.models.transformer import from_numpy_params

ARCHS = ["llama3.2-3b", "gemma2-9b", "qwen1.5-110b", "deepseek-67b",
         "mixtral-8x22b", "arctic-480b"]
TOL = 1e-4        # fp32 compute, the port against the reference
DEC_TOL = 2e-3    # decode against the full forward (the reference's)
BF16_TOL = 3e-2   # bf16 compute, of the largest |logit|: about four bf16
                  # ulps (the reduced models give 0.007-0.017)


def _pair(name, **change):
    """(reference model, port model, reference params, port params); the
    'lean' policy's parameters in bf16 on both sides."""
    jcfg = dataclasses.replace(jreduced(jget_config(name)), **change)
    cfg = dataclasses.replace(reduced(get_config(name)), **change)
    jm, m = jbuild_model(jcfg), build_model(cfg)
    lean = cfg.policy == "lean"
    jp = jm.init(jax.random.PRNGKey(0),
                 dtype=jnp.bfloat16 if lean else jnp.float32)
    p = from_numpy_params(cfg, jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), jp), device="cpu",
        dtype=torch.bfloat16 if lean else torch.float32)
    return jm, m, jp, p


@functools.lru_cache(maxsize=None)
def _jdecode(jm, compute):
    """The reference's decode step, jitted once a (model, compute dtype)."""
    return jax.jit(functools.partial(jm.decode_step, compute_dtype=compute))


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _cache_np(cache):
    return {k: v.to(torch.float32).numpy() if v.is_floating_point()
            else v.numpy() for k, v in cache.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_configs_field_by_field(name):
    for full in (True, False):
        want, got = jget_config(name), get_config(name)
        if not full:
            want, got = jreduced(want), reduced(got)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
    assert name in list_archs()


@pytest.mark.parametrize("name", ARCHS)
def test_cache_len_and_init_cache_match_reference(name):
    for cfg, jcfg in ((reduced(get_config(name)), jreduced(jget_config(name))),
                      (get_config(name), jget_config(name))):
        for max_seq in (4, 8, 64, 4096, 1 << 20):
            assert transformer.cache_len(cfg, max_seq) == \
                jtransformer.cache_len(jcfg, max_seq)
    cfg, jcfg = reduced(get_config(name)), jreduced(jget_config(name))
    got = transformer.init_cache(cfg, 3, 24, device="cpu")
    want = jtransformer.init_cache(jcfg, 3, 24)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype)
        np.testing.assert_array_equal(_cache_np(got)[k],
                                      np.asarray(want[k], np.float32)
                                      if k != "pos" else np.asarray(want[k]))


def _prefill_then_decode(name, compute, tol):
    """Prefill 8 tokens, then 5 decode steps whose rows sit at different
    positions (row 1 skips one), against the reference."""
    jm, m, jp, p = _pair(name)
    cfg = m.cfg
    toks = _tokens(cfg, 2, 13)
    jdt = jnp.float32 if compute == torch.float32 else jnp.bfloat16
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :8]), 16, compute_dtype=jdt)
    pl, pc = m.prefill(p, torch.tensor(toks[:, :8]), 16,
                       compute_dtype=compute)
    scale = float(np.abs(np.asarray(jl)).max())
    _close(pl, jl, tol * scale if compute != torch.float32 else tol)
    got, want = _cache_np(pc), {k: np.asarray(v, np.float32) if k != "pos"
                                else np.asarray(v) for k, v in jc.items()}
    np.testing.assert_array_equal(got["pos"], want["pos"])
    for k in ("k", "v"):
        top = float(np.abs(want[k]).max())
        _close(got[k], want[k], tol * top if compute != torch.float32
               else tol)
    for t in range(8, 13):
        pos = np.array([t, t + 1], np.int32)
        tok = toks[:, t].astype(np.int32)
        jl, jc = _jdecode(jm, jdt)(jp, jc, jnp.asarray(tok),
                                   jnp.asarray(pos))
        pl, same = m.decode_step(p, pc, torch.tensor(tok), torch.tensor(pos),
                                 compute_dtype=compute)
        assert same is pc                       # written in place
        scale = float(np.abs(np.asarray(jl)).max())
        _close(pl, jl, tol * scale if compute != torch.float32 else tol)
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
    return pc, jc


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_reference_fp32(name):
    _prefill_then_decode(name, torch.float32, TOL)


@pytest.mark.parametrize("name", ["llama3.2-3b", "gemma2-9b",
                                  "mixtral-8x22b", "arctic-480b"])
def test_prefill_and_decode_match_reference_bf16(name):
    pc, jc = _prefill_then_decode(name, torch.bfloat16, BF16_TOL)
    assert pc["k"].dtype == torch.bfloat16


def _decode_all(m, p, toks, compute=torch.float32, max_seq=None):
    B, S = toks.shape
    cache = m.init_cache(B, max_seq or S, dtype=compute, device="cpu")
    out = []
    for t in range(S):
        lg, cache = m.decode_step(p, cache, torch.tensor(toks[:, t]),
                                  torch.full((B,), t, dtype=torch.int32),
                                  compute_dtype=compute)
        out.append(lg)
    return torch.stack(out, 1)


def _forward_logits(m, p, toks):
    h = transformer.forward_hidden(m.cfg, p, torch.tensor(toks),
                                   compute_dtype=torch.float32, remat="none")
    return transformer._logits(m.cfg, p, h)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_forward(name):
    """Token-by-token decode through the cache reproduces the port's own
    full forward at every position (windows and softcaps included)."""
    _, m, _, p = _pair(name)
    toks = _tokens(m.cfg, 2, 24)
    _close(_decode_all(m, p, toks), _forward_logits(m, p, toks), DEC_TOL)


def test_ring_buffer_past_the_window():
    """A dense decoder whose every layer has window 8: the cache holds 8
    slots, and 20 decode steps wrap it twice. Each step's logits equal
    the reference's, and the forward's under the same window."""
    _ring_buffer(*_pair("llama3.2-3b", window_pattern=(8,)))


def test_mixtral_ring_buffer_past_the_window():
    """Reduced mixtral's sliding window is 8 (its MoE FFN in every
    layer): the same 20 steps through its 8-slot ring."""
    _ring_buffer(*_pair("mixtral-8x22b"))


def _ring_buffer(jm, m, jp, p):
    assert transformer.cache_len(m.cfg, 64) == 8
    toks = _tokens(m.cfg, 2, 20, seed=3)
    jc = jm.init_cache(2, 64, dtype=jnp.float32)
    pc = m.init_cache(2, 64, dtype=torch.float32, device="cpu")
    assert tuple(pc["k"].shape) == (2, 2, 2, 8, 16)
    dec = []
    for t in range(20):
        tok, pos = toks[:, t].astype(np.int32), np.full((2,), t, np.int32)
        jl, jc = _jdecode(jm, jnp.float32)(jp, jc, jnp.asarray(tok),
                                           jnp.asarray(pos))
        pl, pc = m.decode_step(p, pc, torch.tensor(tok), torch.tensor(pos),
                               compute_dtype=torch.float32)
        _close(pl, jl, TOL)
        dec.append(pl)
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
    assert sorted(pc["pos"][0, 0].tolist()) == list(range(12, 20))
    _close(torch.stack(dec, 1), _forward_logits(m, p, toks), DEC_TOL)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_gemma2_loss_matches_reference(compute):
    """Post-block norms, GeGLU, the (1+w) offset, embed scaling, the
    attention and final softcaps and the 8-token local window, through
    the loss: 1e-5 relative at fp32, BF16_TOL at bf16."""
    jm, m, jp, p = _pair("gemma2-9b")
    assert {"norm1_post", "norm2_post"} <= set(p["layers"])
    toks = _tokens(m.cfg, 2, 32, seed=5)
    labels = _tokens(m.cfg, 2, 32, seed=6)
    want = float(jm.loss_fn(jp, {"tokens": jnp.asarray(toks),
                                 "labels": jnp.asarray(labels)},
                            compute_dtype=getattr(jnp, compute)))
    got = float(m.loss_fn(p, {"tokens": torch.tensor(toks),
                              "labels": torch.tensor(labels)},
                          compute_dtype=getattr(torch, compute)))
    assert got == pytest.approx(want, rel=1e-5 if compute == "float32"
                                else BF16_TOL)


def test_geglu_matches_reference():
    from repro_torch.models import layers
    r = np.random.default_rng(0)
    x, wg, wu, wd = (r.standard_normal(s).astype(np.float32) for s in
                     ((3, 5, 8), (8, 12), (8, 12), (12, 8)))
    got = layers.geglu(*map(torch.tensor, (x, wg, wu, wd)))
    want = jlayers.geglu(*map(jnp.asarray, (x, wg, wu, wd)))
    _close(got, want, 1e-5)


def test_prefill_and_serve_steps_match_reference_composition():
    """The prefill step is the reference's: the last token's unembedded
    hidden state (no softcap) at bf16 compute; the serve step is
    decode_step + argmax on the cache it writes in place."""
    jm, m, jp, p = _pair("gemma2-9b")
    toks = _tokens(m.cfg, 2, 16, seed=7)
    fn = steps.build_prefill_step(m, ShapeSpec("p", 16, 2, "prefill"))
    h = jtransformer.forward_hidden(jm.cfg, jp, jnp.asarray(toks),
                                    compute_dtype=jnp.bfloat16)
    want = h[:, -1, :].astype(jnp.float32) @ jp["embed"].T
    got = fn(p, {"tokens": toks})
    _close(got, want, BF16_TOL * float(np.abs(np.asarray(want)).max()))
    with pytest.raises(ValueError, match="built for"):
        fn(p, {"tokens": toks[:, :8]})
    serve = steps.build_serve_step(m, ShapeSpec("d", 32, 2, "decode"))
    cache = m.init_cache(2, 32, device="cpu")
    jc = jm.init_cache(2, 32)
    for t in range(4):
        tok = toks[:, t].astype(np.int32)
        pos = np.full((2,), t, np.int32)
        nxt, same = serve(p, cache, torch.tensor(tok), torch.tensor(pos))
        jl, jc = _jdecode(jm, jnp.bfloat16)(jp, jc, jnp.asarray(tok),
                                            jnp.asarray(pos))
        assert same is cache and nxt.dtype == torch.int32
        top2 = np.sort(np.asarray(jl), axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > BF16_TOL * np.abs(top2).max()
        want = np.asarray(jnp.argmax(jl, axis=-1))
        assert (nxt.numpy()[clear] == want[clear]).all()


def test_prefill_refuses_a_prompt_longer_than_the_cache():
    _, m, _, p = _pair("llama3.2-3b", window_pattern=(8,))
    with pytest.raises(ValueError, match="longer than the cache"):
        m.prefill(p, torch.zeros((1, 9), dtype=torch.int64), 64)
