"""The model axis of a (data, model) mesh for the decoder family (tensor,
sequence and expert parallelism, `launch/tp.py`) against repro.

The reference leaves the model axis to XLA's partitioner, and its mesh
paths fail under the installed jax (ROADMAP.md, "Reference caveats").
So, as ROADMAP's "How a slice lands" prescribes, the port's ranks (gloo
processes, `tests/torch_dist_workers.py`) are held against the
reference's mesh-free functions on the whole params:

* the loss and gradient (`value_and_grad` of `loss_fn`, fp32 compute):
  the reduced llama3.2-3b, gemma2-9b, qwen1.5-110b, mixtral-8x22b,
  arctic-480b and qwen2-vl-2b (its M-RoPE positions and patches) on a
  (1, 2) mesh, llama on (1, 4) (Hkv = 2 below the model size: the KV
  weights read whole) with and without `gqa_expand`, and a mixtral of
  3 experts (the model size does not divide them: `expert_mlp` over
  'model') with `moe_c_shard` off and on. Bounds: the loss 1e-5
  relative, every leaf of the gathered gradient 1e-4 of its largest
  entry. `seq_parallel` on and off give the same loss (1e-6 relative),
  and every leaf the model axis does not split has the same gradient
  bits on every model rank.
* the prefill and serve steps (`build_prefill_step(mesh=)`,
  `build_serve_step(mesh=)`) of llama and mixtral on (1, 2) (the cache
  split by KV heads) and (1, 4) (by positions: the ranks' partial
  softmaxes merged), against the reference's fp32 `prefill` and 8 greedy
  `decode_step`s from its cache: the mesh prefill's last-token logits
  (the policy's bf16) within bf16's 3e-2 of the largest logit; 8 serve
  steps (bf16) from the cache, fed the reference's tokens, equal to its
  greedy tokens at every position whose top two logits are clearly
  apart; the same steps' fp32 logits (`decode_step` on the mesh) within
  1e-4 (mixtral's ring of 8 wraps).
* `cache_specs` equals the reference's on stand-in meshes (1, 2), (2, 4)
  and (16, 16) for every decoder config and mamba2-1.3b,
  recurrentgemma-2b and whisper-medium, and `seq_spec` the reference's
  `shard_batch_seq` entries.
* the two collectives of `launch/tp.py` the other families need, on two
  gloo ranks against one process's autograd (1e-5 of the largest
  entry): `ModelAxis.cols` (a column block's product all-gathered, each
  rank using only some of the columns) and `ModelAxis.stat` (the gated
  norm's statistic over every rank's channels, whose backward
  all-reduces; `_Reduce`'s pass-through backward in its place is off by
  far more).
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs
from repro.configs import reduced as jreduced
from repro.launch import sharding as jsharding
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config, reduced
from repro_torch.core.tree import tree_map
from repro_torch.launch import sharding
from repro_torch.models import build_model

from torch_dist_workers import start_ranks

B, S = 4, 16
GRAD_CASES = {  # name: (arch, mesh, experts, settings)
    "llama": ("llama3.2-3b", (1, 2), None, {}),
    "gemma2": ("gemma2-9b", (1, 2), None, {}),
    "qwen1.5": ("qwen1.5-110b", (1, 2), None, {}),
    "mixtral": ("mixtral-8x22b", (1, 2), None, {}),
    "arctic": ("arctic-480b", (1, 2), None, {}),
    "qwen2-vl": ("qwen2-vl-2b", (1, 2), None, {}),
    "mixtral-e3": ("mixtral-8x22b", (1, 2), 3, {}),
    "mixtral-e3-cshard": ("mixtral-8x22b", (1, 2), 3,
                          {"moe_c_shard": True}),
    "llama-4": ("llama3.2-3b", (1, 4), None, {}),
    "llama-4-expand": ("llama3.2-3b", (1, 4), None, {"gqa_expand": True}),
}
SERVE_CASES = {"llama": "llama3.2-3b", "mixtral": "mixtral-8x22b"}
PROMPT, MAX_SEQ, FEED = 6, 32, 8
BF16_TOL = 3e-2


def _jmodel(arch, experts=None):
    cfg = jreduced(jget_config(arch))
    if experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
    return jbuild_model(cfg)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "loss_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    if cfg.mrope_sections is not None:
        pos = np.broadcast_to(np.arange(S), (3, B, S)).copy()
        pos[1:, :, 2:6] = 2 + rng.integers(0, 3, (2, B, 4))
        out["positions3"] = pos.astype(np.int32)
        out["patches"] = rng.standard_normal((B, 4, cfg.d_model)).astype(
            np.float32)
        out["patch_positions"] = np.tile(np.arange(2, 6), (B, 1)).astype(
            np.int32)
    return out


@functools.lru_cache(maxsize=None)
def _grad_case(arch, experts):
    """The params of a config (drawn by the port's init, as numpy) and a
    batch: the cases of one config share them."""
    cfg = reduced(get_config(arch))
    if experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
    params = tree_map(lambda t: t.numpy(),
                      build_model(cfg).init(torch.Generator().manual_seed(1)))
    return params, _batch(cfg, 2)


@functools.lru_cache(maxsize=None)
def _grad_reference(arch, experts):
    """The reference's loss and gradient of a config."""
    params, batch = _grad_case(arch, experts)
    jm = _jmodel(arch, experts)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(
        p, b, compute_dtype=jnp.float32)))(
            jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def _serve_reference(arch):
    """The reference's fp32 prefill (its logits and cache) and 8 greedy
    decode steps from it."""
    jm = _jmodel(arch)
    params = jm.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jm.cfg.vocab, (B, PROMPT)).astype(np.int32)
    logits, cache = jax.jit(lambda p, t: jm.prefill(
        p, t, MAX_SEQ, compute_dtype=jnp.float32))(params,
                                                    jnp.asarray(tokens))
    out = {"params": jax.tree.map(np.asarray, params), "tokens": tokens,
           "prefill": np.asarray(logits), "feed": [], "steps": [],
           "cache": {k: np.asarray(v) for k, v in cache.items()}}
    step = jax.jit(lambda p, c, t, q: jm.decode_step(
        p, c, t, q, compute_dtype=jnp.float32))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for i in range(FEED):
        out["feed"].append(np.asarray(tok))
        lg, cache = step(params, cache, tok, jnp.full((B,), PROMPT + i,
                                                      jnp.int32))
        out["steps"].append(np.asarray(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mesh's ranks, started before the reference's side is
    computed: the gradient cases' first (the port draws their params),
    the serving cases' once the reference's caches are made."""
    started = {}
    for ms in (2, 4):
        payload = []
        for name, (arch, mesh, experts, st) in GRAD_CASES.items():
            if mesh == (1, ms):
                params, batch = _grad_case(arch, experts)
                payload.append({"name": name, "arch": arch,
                                "experts": experts, "settings": st,
                                "params": params, "batch": batch})
        started[("grad", ms)] = start_ranks(
            "tp_grad", ms, tmp_path_factory.mktemp(f"grad{ms}"),
            {"cases": payload}, shape=(1, ms), names=("data", "model"))
    serve = {name: _serve_reference(arch)
             for name, arch in SERVE_CASES.items()}
    payload = [{"name": name, "arch": arch, **{
        k: serve[name][k] for k in ("params", "tokens", "cache", "feed")}}
               for name, arch in SERVE_CASES.items()]
    for ms in (2, 4):
        started[("serve", ms)] = start_ranks(
            "tp_serve", ms, tmp_path_factory.mktemp(f"serve{ms}"),
            {"cases": payload}, shape=(1, ms), names=("data", "model"))
    refs = {name: _grad_reference(arch, experts)
            for name, (arch, _, experts, _) in GRAD_CASES.items()}
    got = {key: fin() for key, fin in started.items()}
    return got, refs, serve


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_loss_and_gradient_match_the_reference(runs, name):
    got, refs, _ = runs
    ms = GRAD_CASES[name][1][1]
    loss, grads = refs[name]
    for rank in got[("grad", ms)]:
        for sp in (True, False):
            r = rank[name][sp]
            assert r["loss"] == pytest.approx(loss, rel=1e-5)
            assert len(r["grads"]) == len(grads)
            for g, want in zip(r["grads"], grads):
                scale = max(float(np.abs(want).max()), 1e-30)
                assert float(np.abs(g.numpy() - want).max()) <= 1e-4 * scale
        assert rank[name][True]["loss"] == pytest.approx(
            rank[name][False]["loss"], rel=1e-6)


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_replicated_leaves_have_the_same_gradient_bits_on_every_rank(
        runs, name):
    got, _, _ = runs
    ranks = got[("grad", GRAD_CASES[name][1][1])]
    for sp in (True, False):
        first = ranks[0][name][sp]["rep"]
        assert first    # the norms at least
        for other in ranks[1:]:
            rep = other[name][sp]["rep"]
            assert set(rep) == set(first)
            for path, g in rep.items():
                assert g.equal(first[path]), (sp, path)


def check_serving(ranks, ref, layout):
    """Each rank's mesh prefill and serve steps (`tp_serve_scenario`)
    against the reference's (`_serve_reference`)."""
    for r in ranks:
        assert r["layout"] == layout
        want = ref["prefill"]
        assert np.abs(r["prefill"].numpy() - want).max() <= \
            BF16_TOL * np.abs(want).max()
        for i, (tok, lg) in enumerate(zip(r["tokens"], r["logits"])):
            want = ref["steps"][i]
            top2 = np.sort(want, -1)[:, -2:]
            clear = (top2[:, 1] - top2[:, 0]) > BF16_TOL * np.abs(top2).max()
            assert clear.any()
            assert (tok.numpy()[clear] == want.argmax(-1)[clear]).all()
            np.testing.assert_allclose(lg.numpy(), want, rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("ms", [2, 4])
@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_mesh_prefill_and_serve_steps_match_the_reference(runs, name, ms):
    got, _, serve = runs
    check_serving([rank[name] for rank in got[("serve", ms)]], serve[name],
                  "heads" if ms == 2 else "seq")     # Hkv = 2


def _stand_in(shape, names=("data", "model")):
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


def _norm(spec):
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


def _flat_specs(tree, prefix=""):
    """{path: normalised spec} of a nested dict of specs."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = _norm(v)
    return out


# every decoder, and the SSM, hybrid and encoder-decoder families, whose
# caches nest (the hybrid's) and hold recurrent states and cross K/V
ARCHS = [a for a in list_archs() if get_config(a).family == "decoder"] + [
    "mamba2-1.3b", "recurrentgemma-2b", "whisper-medium"]


@pytest.mark.parametrize("shape", [(1, 2), (2, 4), (16, 16)])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch, shape):
    mesh = _stand_in(shape)
    model = build_model(get_config(arch))
    jm = jbuild_model(jget_config(arch))
    for batch, seq in ((8, 4096), (1, 320), (16, 32768)):
        cache = model.init_cache(batch, seq, device="meta")
        jcache = jax.eval_shape(lambda: jm.init_cache(batch, seq))
        got = _flat_specs(sharding.cache_specs(model.cfg, cache, mesh))
        want = _flat_specs(jsharding.cache_specs(jm.cfg, jcache, mesh))
        assert set(got) == set(want)
        for k in got:
            assert got[k] == want[k], (k, batch, seq)


@pytest.mark.parametrize("shape", [(1, 2), (2, 4), (16, 16), (3, 5)])
def test_seq_spec_is_the_references_shard_batch_seq(shape, monkeypatch):
    """The entries the reference's `shard_batch_seq` constrains the
    residual stream to (read off its `with_sharding_constraint`)."""
    mesh = _stand_in(shape)
    seen = []
    monkeypatch.setattr(jsharding, "NamedSharding",
                        lambda m, spec: seen.append(_norm(spec)))
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: x)
    for b, s in ((16, 4096), (4, 30), (2, 16)):
        jsharding.shard_batch_seq(np.zeros((b, s, 8)), mesh)
        assert _norm(sharding.seq_spec((b, s, 8), mesh)) == seen[-1]


@pytest.mark.parametrize("batched", [False, True])
def test_product_in_keeps_sums_in_fp32_and_backs_off_in_bf16(batched):
    """`nn.product_in` (a row-parallel product on a model axis): bf16
    operands, the output in fp32 equal to the upcast product's; the
    backward that of the bf16 product (one device's), given the same
    bf16-exact upstream gradient; fp32 operands run the plain product."""
    from repro_torch.models import layers as nn

    gen = torch.Generator().manual_seed(3)
    shape_a, shape_b = ((3, 5, 16), (3, 16, 7)) if batched else \
        ((2, 5, 16), (16, 7))
    a = torch.randn(shape_a, generator=gen).to(torch.bfloat16)
    b = torch.randn(shape_b, generator=gen).to(torch.bfloat16)
    g = torch.randn(shape_a[:-1] + (7,), generator=gen).to(torch.bfloat16)
    a1, b1 = a.clone().requires_grad_(), b.clone().requires_grad_()
    out = nn.product_in(a1, b1, torch.float32)
    assert out.dtype == torch.float32
    assert torch.equal(out, a.float() @ b.float())
    out.backward(g.float())
    a2, b2 = a.clone().requires_grad_(), b.clone().requires_grad_()
    (a2 @ b2).backward(g)
    assert a1.grad.dtype == torch.bfloat16
    assert torch.equal(a1.grad, a2.grad) and torch.equal(b1.grad, b2.grad)
    af, bf = a.float(), b.float()
    assert torch.equal(nn.product_in(af, bf, torch.float32), af @ bf)
    assert torch.equal(nn.product_in(a, b), a @ b)


def test_column_gather_and_stat_reduce_backward(tmp_path):
    """`ModelAxis.cols` and `ModelAxis.stat` (`layers.rms_norm_split`) on
    a (1, 2) mesh (`tests/torch_dist_workers.py`'s `tp_collectives`):
    the loss summed over the ranks and the gradients put back together
    equal one process's autograd of the same functions to 1e-5 of their
    largest entry; with `_Reduce`'s pass-through backward in `_Stat`'s
    place the norm's input gradient is off by more than 10% of it."""
    from repro_torch.models import layers as nn

    from torch_dist_workers import collective_inputs, run_ranks
    ranks = run_ranks("tp_collectives", 2, tmp_path, {}, shape=(1, 2),
                      names=("data", "model"))
    x, w, c, xn, wn, cn = collective_inputs()
    x, w, xn, wn = (t.clone().requires_grad_(True) for t in (x, w, xn, wn))
    cols = ((x @ w) * c).sum()
    gx, gw = torch.autograd.grad(cols, (x, w))
    norm = (nn.rms_norm(xn, wn) * cn).sum()
    gxn, gwn = torch.autograd.grad(norm, (xn, wn))

    def close(got, want):
        return float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
    for r in ranks:
        assert r["cols"]["loss"] == pytest.approx(float(cols.detach()),
                                                 rel=1e-6)
        assert close(r["cols"]["x"], gx) and close(r["cols"]["w"], gw)
        assert r["stat"]["loss"] == pytest.approx(float(norm.detach()),
                                                 rel=1e-6)
        assert close(r["stat"]["x"], gxn) and close(r["stat"]["w"], gwn)
        off = float((r["pass_through"]["x"] - gxn).abs().max())
        assert off > 0.1 * float(gxn.abs().max())
