"""qwen2-vl-2b's M-RoPE and patch embeddings in the port against repro's.

`apply_mrope` against the reference's within 1e-6 (fp32 rotations of the
same inputs; 1e-4 up to position 4096) and, with equal positions in the three sections, against
the port's own `apply_rope`; the reduced qwen2-vl (2 layers, sections
(2, 3, 3), 4 patches an image) from the reference's parameters carried
across as numpy: `forward_hidden` and `loss_fn` with `positions3`,
`patches` and `patch_positions` at fp32 within 1e-4, the gradient of the
loss against `jax.grad` of the reference's within 1e-4 of each leaf's
largest entry, `prefill` and a run of `decode_step`s with `positions3`
within 1e-4, the prefill and serve steps against the reference's
mesh-free composition (bf16, within BF16_TOL of the largest logit),
`input_specs`, and the pod train step on two gloo ranks (each its rows
of the batch, positions3 split on its dim 1) against the reference's
gradient of the two pods' mean loss.
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
from repro.models import input_specs as jinput_specs
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config, reduced
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import steps
from repro_torch.models import build_model, input_specs, layers, transformer
from repro_torch.models.config import ShapeSpec
from repro_torch.models.transformer import from_numpy_params
from torch_dist_workers import start_ranks

TOL = 1e-4
BF16_TOL = 3e-2
NAME = "qwen2-vl-2b"


@functools.lru_cache(maxsize=None)
def _pair():
    """(reference model, port model, reference params, port params)."""
    jm = jbuild_model(jreduced(jget_config(NAME)))
    m = build_model(reduced(get_config(NAME)))
    jp = jm.init(jax.random.PRNGKey(0))
    # non-zero QKV biases, so that their path is held too
    for i, k in enumerate(("bq", "bk", "bv")):
        jp["layers"][k] = 0.1 * jax.random.normal(
            jax.random.PRNGKey(10 + i), jp["layers"][k].shape)
    p = from_numpy_params(m.cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, m, jp, p


@functools.lru_cache(maxsize=None)
def _jdecode(jm, compute):
    return jax.jit(functools.partial(jm.decode_step, compute_dtype=compute))


def _positions3(B, S, image=None, start=0):
    """Qwen2-VL's layout: text at (t, t, t); an image of rows x cols
    patches at offset o takes (o, o + row, o + col), and the text after
    it resumes at o + max(rows, cols)."""
    out = np.zeros((3, B, S), np.int32)
    t, i = start, 0
    while i < S:
        if image is not None and i == image[0]:
            o, rows, cols = image
            for r in range(rows):
                for c in range(cols):
                    out[:, :, i] = np.array([t, t + r, t + c])[:, None]
                    i += 1
            t += max(rows, cols)
            continue
        out[:, :, i] = t
        t += 1
        i += 1
    return out


def _batch(cfg, B=2, S=16, seed=0):
    r = np.random.default_rng(seed)
    P = cfg.num_patches                     # 4: a 2 x 2 image at offset 3
    return {"tokens": r.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": r.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "positions3": _positions3(B, S, image=(3, 2, 2)),
            "patches": r.standard_normal((B, P, cfg.d_model)).astype(
                np.float32),
            "patch_positions": np.tile(np.arange(3, 3 + P), (B, 1)).astype(
                np.int32)}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("sections,dtype,top,tol", [
    ((16, 24, 24), "float32", 48, 1e-6), ((2, 3, 3), "float32", 4096, 1e-6),
    ((16, 24, 24), "float32", 4096, 1e-4), ((4, 2, 2), "bfloat16", 512,
                                            1e-2)])
def test_apply_mrope_matches_reference(sections, dtype, top, tol):
    """Positions below `top`. torch's and XLA's `theta ** x` differ by an
    ulp in 4 of the 64 frequencies at theta 1e6, and the angle's error
    grows with the position: below 48 the rotations agree to 1e-6, up to
    4096 to 1e-4 (the RoPE test's bound in `test_torch_models.py`)."""
    r = np.random.default_rng(1)
    hd = 2 * sum(sections)
    x = r.standard_normal((2, 5, 3, hd)).astype(np.float32)
    p3 = r.integers(0, top, (3, 2, 5)).astype(np.int32)
    got = layers.apply_mrope(torch.tensor(x).to(getattr(torch, dtype)),
                             torch.tensor(p3), sections=sections,
                             theta=1e6)
    want = jlayers.apply_mrope(jnp.asarray(x).astype(getattr(jnp, dtype)),
                               jnp.asarray(p3), sections=sections, theta=1e6)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    _close(got.to(torch.float32), want.astype(jnp.float32), tol)
    with pytest.raises(ValueError, match="sum to"):
        layers.apply_mrope(torch.tensor(x), torch.tensor(p3),
                           sections=(1, 1, 1))


def test_mrope_with_equal_sections_is_rope():
    """positions3 = (t, t, t): every frequency slot rotates by t, which is
    RoPE, bit for bit."""
    r = np.random.default_rng(2)
    x = torch.tensor(r.standard_normal((2, 7, 4, 16)).astype(np.float32))
    pos = torch.tensor(r.integers(0, 4096, (2, 7)))
    got = layers.apply_mrope(x, pos.expand(3, 2, 7), sections=(2, 3, 3),
                             theta=1e4)
    assert torch.equal(got, layers.apply_rope(x, pos, theta=1e4))


def test_forward_and_loss_match_reference():
    """Patches replace the embedded rows at patch_positions, and M-RoPE
    rotates at positions3 whose sections differ over the image."""
    jm, m, jp, p = _pair()
    b = _batch(m.cfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.tensor(v) for k, v in b.items()}
    kw = {k: b[k] for k in ("positions3", "patches", "patch_positions")}
    want = jax.jit(functools.partial(
        jtransformer.forward_hidden, jm.cfg, compute_dtype=jnp.float32))(
        jp, jb["tokens"], **{k: jnp.asarray(v) for k, v in kw.items()})
    got = transformer.forward_hidden(
        m.cfg, p, tb["tokens"], compute_dtype=torch.float32, remat="none",
        **{k: torch.tensor(v) for k, v in kw.items()})
    _close(got, want, TOL)
    # the patches matter: without them the rows differ
    plain = transformer.forward_hidden(
        m.cfg, p, tb["tokens"], compute_dtype=torch.float32, remat="none",
        positions3=tb["positions3"])
    assert not torch.allclose(plain, got, atol=1e-3)
    jl = jax.jit(functools.partial(jm.loss_fn, compute_dtype=jnp.float32))(
        jp, jb)
    tl = m.loss_fn(p, tb, compute_dtype=torch.float32)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5, abs=TOL)


def test_loss_gradient_matches_reference():
    jm, m, jp, p = _pair()
    b = _batch(m.cfg, seed=3)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.tensor(v) for k, v in b.items()}
    jg = jax.jit(jax.grad(lambda q: jm.loss_fn(q, jb,
                                               compute_dtype=jnp.float32)))(jp)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(p)]
    live = jax.tree.unflatten(jax.tree.structure(jp), leaves)
    loss = m.loss_fn(live, tb, compute_dtype=torch.float32)
    grads = torch.autograd.grad(loss, leaves)
    for g, want in zip(grads, jax.tree.leaves(jg)):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=TOL * max(np.abs(want).max(), 1e-30))


def test_positions3_is_required():
    _, m, _, p = _pair()
    tok = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="positions3"):
        transformer.forward_hidden(m.cfg, p, tok)
    with pytest.raises(ValueError, match="positions3"):
        m.prefill(p, tok, 16)
    cache = m.init_cache(2, 16, device="cpu")
    with pytest.raises(ValueError, match="positions3"):
        m.decode_step(p, cache, tok[:, 0], torch.zeros(2, dtype=torch.int32))
    assert int((cache["pos"] != transformer.EMPTY_POS).sum()) == 0
    b = _batch(m.cfg)
    bad = torch.tensor(b["patch_positions"]) + 20
    with pytest.raises(ValueError, match="patch_positions"):
        transformer.forward_hidden(
            m.cfg, p, torch.tensor(b["tokens"]),
            positions3=torch.tensor(b["positions3"]),
            patches=torch.tensor(b["patches"]), patch_positions=bad)


@pytest.mark.parametrize("past", [False, True])
@pytest.mark.parametrize("path", ["forward", "prefill_step"])
def test_patch_positions_outside_the_sequence_raise(path, past):
    """A position below 0 or at the sequence's length raises before the
    scatter, in `forward_hidden` and through the prefill step, which
    leaves the positions on the host."""
    _, m, _, p = _pair()
    b = _batch(m.cfg)
    B, S = b["tokens"].shape
    bad = b["patch_positions"].copy()
    bad[-1, -1] = S if past else -1
    with pytest.raises(ValueError, match="patch_positions"):
        if path == "forward":
            transformer.forward_hidden(
                m.cfg, p, torch.tensor(b["tokens"]),
                positions3=torch.tensor(b["positions3"]),
                patches=torch.tensor(b["patches"]),
                patch_positions=torch.tensor(bad))
        else:
            steps.build_prefill_step(m, ShapeSpec("p", S, B, "prefill"))(
                p, {**b, "patch_positions": bad})


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(compute):
    """Prefill 8 text tokens, then 5 decode steps at positions3 whose
    sections differ (the height and width ids run ahead of the temporal
    one), row 1 one position ahead, against the reference."""
    jm, m, jp, p = _pair()
    tol = TOL if compute == "float32" else BF16_TOL
    jdt, dt = getattr(jnp, compute), getattr(torch, compute)
    toks = np.random.default_rng(4).integers(0, m.cfg.vocab, (2, 13))
    p3 = _positions3(2, 8)
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :8]), 16,
                        positions3=jnp.asarray(p3), compute_dtype=jdt)
    pl, pc = m.prefill(p, torch.tensor(toks[:, :8]), 16,
                       positions3=torch.tensor(p3), compute_dtype=dt)
    scale = 1.0 if compute == "float32" else float(np.abs(jl).max())
    _close(pl, jl, tol * scale)
    for t in range(8, 13):
        pos = np.array([t, t + 1], np.int32)
        p3 = np.stack([pos, pos + 2, pos + 5])[:, :, None].astype(np.int32)
        tok = toks[:, t].astype(np.int32)
        jl, jc = _jdecode(jm, jdt)(jp, jc, jnp.asarray(tok), jnp.asarray(pos),
                                   positions3=jnp.asarray(p3))
        pl, pc = m.decode_step(p, pc, torch.tensor(tok), torch.tensor(pos),
                               positions3=torch.tensor(p3), compute_dtype=dt)
        scale = 1.0 if compute == "float32" else float(np.abs(jl).max())
        _close(pl, jl, tol * scale)
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))


def test_decode_matches_forward():
    """Token-by-token decode with per-token positions3 reproduces the
    port's full forward at the same positions3 (sections differing),
    within the reference's decode tolerance 2e-3."""
    _, m, _, p = _pair()
    B, S = 2, 12
    toks = np.random.default_rng(5).integers(0, m.cfg.vocab, (B, S))
    t = np.arange(S)
    p3 = np.stack([t, t * 2, t + 3])[:, None, :].repeat(B, 1).astype(
        np.int32)
    cache = m.init_cache(B, S, dtype=torch.float32, device="cpu")
    dec = []
    for i in range(S):
        lg, cache = m.decode_step(
            p, cache, torch.tensor(toks[:, i]),
            torch.full((B,), i, dtype=torch.int32),
            positions3=torch.tensor(p3[:, :, i:i + 1]),
            compute_dtype=torch.float32)
        dec.append(lg)
    h = transformer.forward_hidden(m.cfg, p, torch.tensor(toks),
                                   positions3=torch.tensor(p3),
                                   compute_dtype=torch.float32, remat="none")
    _close(torch.stack(dec, 1), transformer._logits(m.cfg, p, h), 2e-3)


def test_prefill_and_serve_steps_match_reference_composition():
    jm, m, jp, p = _pair()
    b = _batch(m.cfg, seed=6)
    fn = steps.build_prefill_step(m, ShapeSpec("p", 16, 2, "prefill"))
    h = jtransformer.forward_hidden(
        jm.cfg, jp, jnp.asarray(b["tokens"]), compute_dtype=jnp.bfloat16,
        **{k: jnp.asarray(b[k]) for k in ("positions3", "patches",
                                          "patch_positions")})
    want = np.asarray(h[:, -1, :].astype(jnp.float32) @ jp["embed"].T)
    got = fn(p, {k: v for k, v in b.items() if k != "labels"})
    _close(got, want, BF16_TOL * float(np.abs(want).max()))
    serve = steps.build_serve_step(m, ShapeSpec("d", 32, 2, "decode"))
    cache = m.init_cache(2, 32, device="cpu")
    jc = jm.init_cache(2, 32)
    for t in range(4):
        tok = b["tokens"][:, t]
        pos = np.full((2,), t, np.int32)
        p3 = np.stack([pos, pos + 1, pos + 2])[:, :, None]
        nxt, same = serve(p, cache, torch.tensor(tok), torch.tensor(pos),
                          positions3=torch.tensor(p3))
        jl, jc = _jdecode(jm, jnp.bfloat16)(jp, jc, jnp.asarray(tok),
                                            jnp.asarray(pos),
                                            positions3=jnp.asarray(p3))
        assert same is cache and nxt.dtype == torch.int32
        top2 = np.sort(np.asarray(jl), axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > BF16_TOL * np.abs(top2).max()
        want = np.asarray(jnp.argmax(jl, axis=-1))
        assert (nxt.numpy()[clear] == want[clear]).all()
    with pytest.raises(ValueError, match="positions3"):
        serve(p, cache, torch.tensor(tok), torch.tensor(pos))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_reference(kind):
    cfg = get_config(NAME)
    shape = next(s for s in cfg.shapes if s.kind == kind)
    shape = dataclasses.replace(shape, seq_len=64, global_batch=2)
    got = input_specs(cfg, shape)
    want = jinput_specs(jget_config(NAME), shape)
    assert set(got) == set(want)
    for k in want:
        if k == "cache":
            continue
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(
            want[k].dtype), k
        assert got[k].device.type == "meta"


def test_pod_train_step_splits_positions3_on_its_batch_dim(tmp_path):
    """Two pods, one row of a global batch of 2 each: the pod step's loss
    is the mean of the two pods' losses, and its state after one AdamW
    step (the gradient all-reduced, no compressor) is the reference's
    `adamw.update` on the gradient of that mean, at fp32: the loss within
    1e-5 relative, m and v within 1e-4 of each leaf's largest entry, each
    param within 0.25 learning rates (AdamW's first step is about
    g / (|g| + 1e-8): an entry of g near 1e-8 moves its param by a large
    part of lr on a last-digit difference). A split of positions3 on its
    dim 0 would hand a pod the wrong rows' positions (or none)."""
    from repro.optim import adamw as jadamw
    jm, m, jp, _ = _pair()
    lr = 3e-3
    b = _batch(m.cfg, seed=8)
    jopt_cfg = jadamw.AdamWConfig()
    jopt = jadamw.init_state(jp, jopt_cfg)
    state = jax.tree.map(np.asarray, {"params": jp, "opt": jopt})
    finish = start_ranks("vlm_pod", 2, tmp_path, {
        "state": state, "batch": b, "lr": lr}, shape=(2, 1, 1),
        names=("pod", "data", "model"))
    halves = [{k: jnp.asarray(v[:, r:r + 1] if k == "positions3"
                              else v[r:r + 1]) for k, v in b.items()}
              for r in range(2)]

    @jax.jit    # one compile, not one an op
    def jstep(jp, jopt):
        jloss, jg = jax.value_and_grad(lambda q: sum(jm.loss_fn(
            q, h, compute_dtype=jnp.float32) for h in halves) / 2)(jp)
        return (jloss, *jadamw.update(jp, jg, jopt, jnp.float32(lr),
                                      jopt_cfg)[:2])

    jloss, want, wopt = jstep(jp, jopt)
    ranks = finish()
    for res in ranks:
        assert res["loss"] == pytest.approx(float(jloss), rel=1e-5)
        for key in ("m", "v"):
            for a, w in zip(res[key], jax.tree.leaves(wopt[key])):
                w = np.asarray(w)
                assert np.abs(a.numpy() - w).max() <= 1e-4 * np.abs(w).max()
        for a, w in zip(res["params"], jax.tree.leaves(want)):
            assert np.abs(a.numpy() - np.asarray(w)).max() <= 0.25 * lr
