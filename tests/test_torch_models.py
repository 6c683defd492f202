"""repro_torch.models / configs / data against the reference, on the CPU.

Reduced llama3.2-3b (d_model 64, 2 layers, vocab 256). The reference
initializes the weights; they are carried across with
`from_numpy_params`. Tolerances: at compute_dtype=float32 the loss agrees
to 1e-5 relative and each gradient leaf to 1e-4 of its largest entry
(float32 on both sides, different summation order); at bfloat16 the two
frameworks round the bf16 matmuls at different points, so the loss is
held to 1e-3 relative and each gradient leaf to 5e-2 of its largest
entry (measured on three seeds: at most 5.2e-5 and 2.0e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.models import settings as jsettings
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import build_model, input_specs, layers, settings
from repro_torch.models import transformer
from repro_torch.models.config import MoESpec, ShapeSpec


def _models():
    jcfg = jreduced(jget_config("llama3.2-3b"))
    cfg = reduced(get_config("llama3.2-3b"))
    return jbuild_model(jcfg), build_model(cfg)


def _carried(jmodel, seed=0):
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    nparams = jax.tree.map(np.asarray, jparams)
    return jparams, transformer.from_numpy_params(
        reduced(get_config("llama3.2-3b")), nparams, device="cpu")


def _batch(seq=32, batch=4, seed=0, step=0):
    b = SyntheticLM(DataConfig(vocab=256, seq_len=seq, global_batch=batch,
                               seed=seed)).batch(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.tensor(v) for k, v in b.items()})


def test_configs_match_reference():
    assert list_archs() == ["arctic-480b", "deepseek-67b", "gemma2-9b",
                            "llama3.2-3b", "mamba2-1.3b", "mixtral-8x22b",
                            "qwen1.5-110b", "qwen2-vl-2b",
                            "recurrentgemma-2b", "whisper-medium"]
    for name in list_archs():
        for full in (True, False):
            want = jget_config(name)
            got = get_config(name)
            if not full:
                want, got = jreduced(want), reduced(got)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.param_count() == want.param_count()
    # the slice's depth cut: 2 layers at the published widths
    two = dataclasses.replace(get_config("llama3.2-3b"), n_layers=2)
    assert two.param_count() == 595_344_384
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("mamba3-1.3b")


@pytest.mark.parametrize("seed,step,shard,shards",
                         [(0, 0, 0, 1), (3, 5, 0, 1), (1, 2, 1, 2)])
def test_synthetic_lm_matches_reference(seed, step, shard, shards):
    kw = dict(vocab=256, seq_len=48, global_batch=4, seed=seed)
    got = SyntheticLM(DataConfig(**kw)).batch(step, shard=shard,
                                              num_shards=shards)
    want = JSyntheticLM(JDataConfig(**kw)).batch(step, shard=shard,
                                                num_shards=shards)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k], want[k])


def test_params_round_trip_and_module():
    jmodel, model = _models()
    jparams, params = _carried(jmodel)
    # same leaves, same sorted order, same shapes and values
    jleaves = jax.tree.leaves(jparams)
    leaves = tree_leaves(params)
    assert [tuple(a.shape) for a in leaves] == [a.shape for a in jleaves]
    for a, b in zip(leaves, jleaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mod = model.module(params)
    tree = mod.param_tree()
    assert sorted(tree) == sorted(params)
    assert sorted(tree["layers"]) == sorted(params["layers"])
    assert tree["embed"].data_ptr() == params["embed"].data_ptr()
    assert sum(p.numel() for p in mod.parameters()) == \
        model.cfg.param_count()
    # the port's own init: the reference's shapes, drawn from a generator
    own = model.init(torch.Generator().manual_seed(0))
    assert [tuple(a.shape) for a in tree_leaves(own)] == \
        [a.shape for a in jleaves]
    assert float(own["layers"]["norm1"].min()) == 1.0
    bad = jax.tree.map(np.asarray, jparams)
    bad["layers"]["wq"] = bad["layers"]["wq"][:, :, :8]
    with pytest.raises(ValueError, match="layers/wq"):
        transformer.from_numpy_params(model.cfg, bad, device="cpu")


def _loss_and_grads(model, params, batch, **kw):
    live = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                    params)
    loss = model.loss_fn(live, batch, **kw)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return loss.detach(), grads


@pytest.mark.parametrize("dtype,loss_tol,grad_tol", [
    ("float32", 1e-5, 1e-4), ("bfloat16", 1e-3, 5e-2)])
@pytest.mark.parametrize("remat", ["nothing", "none"])
def test_loss_and_grads_match_reference(dtype, loss_tol, grad_tol, remat):
    jmodel, model = _models()
    jparams, params = _carried(jmodel)
    jb, b = _batch()
    jloss, jgrads = jax.value_and_grad(lambda p: jmodel.loss_fn(
        p, jb, compute_dtype=getattr(jnp, dtype), remat=remat))(jparams)
    loss, grads = _loss_and_grads(model, params, b,
                                  compute_dtype=getattr(torch, dtype),
                                  remat=remat)
    assert float(loss) == pytest.approx(float(jloss), rel=loss_tol)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        jg = np.asarray(jg, np.float32)
        err = np.abs(g.float().numpy() - jg).max() / np.abs(jg).max()
        assert err <= grad_tol


def test_chunked_attention_path_matches_reference():
    """A sequence above `dense_below` takes the chunked online-softmax
    branch in both packages (small chunks, so several of each)."""
    jmodel, model = _models()
    jparams, params = _carried(jmodel, seed=1)
    jb, b = _batch(seq=64, batch=2, seed=2)
    knobs = dict(dense_below=64 * 32, attn_chunk_q=16, attn_chunk_k=32,
                 ce_chunk=16)
    with jsettings.override(**knobs):
        jloss, jgrads = jax.value_and_grad(lambda p: jmodel.loss_fn(
            p, jb, compute_dtype=jnp.float32))(jparams)
    with settings.override(**knobs):
        loss, grads = _loss_and_grads(model, params, b,
                                      compute_dtype=torch.float32)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        jg = np.asarray(jg)
        assert np.abs(g.numpy() - jg).max() / np.abs(jg).max() <= 1e-4


@pytest.mark.parametrize("branch", ["dense", "chunked"])
@pytest.mark.parametrize("window", [None, 5])
def test_attention_matches_reference(branch, window):
    rng = np.random.default_rng(3)
    B, S, Hq, Hkv, dh = 2, 48, 6, 2, 8
    q, k, v = (rng.standard_normal((B, S, h, dh)).astype(np.float32)
               for h in (Hq, Hkv, Hkv))
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    kw = dict(causal=True, window=window, softcap=20.0,
              dense_below=S * S if branch == "dense" else 1,
              chunk_q=16, chunk_k=12)
    want = jlayers.attention(*(jnp.asarray(a) for a in (q, k, v, pos, pos)),
                             **kw)
    got = layers.attention(*(torch.tensor(a) for a in (q, k, v)),
                           torch.tensor(pos), torch.tensor(pos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_layers_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        layers.apply_rope(torch.tensor(x), torch.tensor(pos),
                          theta=500_000.0).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      theta=500_000.0)),
        rtol=1e-4, atol=1e-4)
    w = rng.standard_normal(8).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(torch.tensor(x), torch.tensor(w)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        layers.soft_cap(torch.tensor(x) * 30, 20.0).numpy(),
        np.asarray(jlayers.soft_cap(jnp.asarray(x) * 30, 20.0)),
        rtol=1e-5, atol=1e-5)
    h = rng.standard_normal((2, 12, 8)).astype(np.float32)
    un = rng.standard_normal((8, 30)).astype(np.float32)
    lab = rng.integers(0, 30, (2, 12)).astype(np.int32)
    mask = (rng.random((2, 12)) > 0.3).astype(np.float32)
    for chunk in (4, 5, 12):
        got = layers.chunked_ce_loss(torch.tensor(h), torch.tensor(un),
                                     torch.tensor(lab), chunk=chunk,
                                     softcap=15.0, mask=torch.tensor(mask))
        want = jlayers.chunked_ce_loss(jnp.asarray(h), jnp.asarray(un),
                                       jnp.asarray(lab), chunk=chunk,
                                       softcap=15.0, mask=jnp.asarray(mask))
        assert float(got) == pytest.approx(float(want), rel=1e-5)


@pytest.mark.parametrize("name", ["arctic-480b", "deepseek-67b",
                                  "gemma2-9b", "llama3.2-3b", "mamba2-1.3b",
                                  "mixtral-8x22b", "qwen1.5-110b",
                                  "qwen2-vl-2b", "recurrentgemma-2b",
                                  "whisper-medium"])
def test_every_architecture_builds(name):
    """Each of the ten reduced architectures builds, draws the
    reference's leaf shapes, gives its family's module view, and takes a
    finite loss and one decode step on the CPU."""
    cfg = reduced(get_config(name))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    want = jax.eval_shape(lambda: jbuild_model(jreduced(jget_config(
        name))).init(jax.random.PRNGKey(0)))
    assert [tuple(t.shape) for t in tree_leaves(params)] == \
        [a.shape for a in jax.tree.leaves(want)]
    view = model.module(params)
    assert type(view).__name__ == {"decoder": "Decoder", "ssm": "Mamba2",
                                   "hybrid": "Griffin",
                                   "encdec": "Whisper"}[cfg.family]
    b = {"tokens": torch.ones((2, 8), dtype=torch.int32),
         "labels": torch.ones((2, 8), dtype=torch.int32)}
    if cfg.family == "encdec":
        b["frames"] = torch.randn((2, cfg.encoder_seq, cfg.d_model),
                                  generator=torch.Generator().manual_seed(1))
    if cfg.mrope_sections is not None:
        b["positions3"] = torch.arange(8).expand(3, 2, 8)
    assert bool(torch.isfinite(view(b, compute_dtype=torch.float32)))
    cache = model.init_cache(2, 8, device="cpu")
    kw = ({"positions3": torch.zeros((3, 2, 1), dtype=torch.int32)}
          if cfg.mrope_sections is not None else {})
    logits, same = model.decode_step(params, cache, torch.zeros(
        2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32), **kw)
    assert same is cache and tuple(logits.shape) == (2, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


def test_decoder_refuses_the_gelu_mlp_and_layer_norm():
    """The decoder family runs SwiGLU or GeGLU and RMSNorm: a decoder
    config asking for the GELU MLP or LayerNorm (the encoder-decoder's)
    raises, where the reference's decoder silently runs SwiGLU and
    RMSNorm; MoE and M-RoPE build and carry their leaves."""
    cfg = reduced(get_config("llama3.2-3b"))
    for change in (dict(mlp="gelu"), dict(norm="ln")):
        with pytest.raises(NotImplementedError, match="not the decoder's"):
            build_model(dataclasses.replace(cfg, **change)).init(
                torch.Generator().manual_seed(0))
    with pytest.raises(KeyError, match="unknown model family"):
        build_model(dataclasses.replace(cfg, family="diffusion"))
    # MoE and M-RoPE are ported: they build and carry their leaves
    for change, leaf in ((dict(moe=MoESpec(4, 2, 64)), "we_gate"),
                         (dict(mrope_sections=(2, 3, 3)), "wq")):
        params = build_model(dataclasses.replace(cfg, **change)).init(
            torch.Generator().manual_seed(0))
        assert leaf in params["layers"]
    specs = input_specs(cfg, ShapeSpec("t", 32, 4, "train"))
    assert {k: (tuple(v.shape), v.dtype, v.device.type)
            for k, v in specs.items()} == {
        "tokens": ((4, 32), torch.int32, "meta"),
        "labels": ((4, 32), torch.int32, "meta")}
    specs = input_specs(cfg, ShapeSpec("d", 32, 4, "decode"))
    assert {k: (tuple(v.shape), v.dtype, v.device.type)
            for k, v in specs.items() if k != "cache"} == {
        "token": ((4,), torch.int32, "meta"),
        "pos": ((4,), torch.int32, "meta")}
    assert {k: (tuple(v.shape), v.dtype, v.device.type)
            for k, v in specs["cache"].items()} == {
        "k": ((2, 4, 2, 32, 16), torch.bfloat16, "meta"),
        "v": ((2, 4, 2, 32, 16), torch.bfloat16, "meta"),
        "pos": ((2, 4, 32), torch.int32, "meta")}
