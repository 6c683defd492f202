"""A model axis that splits inside a head, against repro.

The production mesh's model axis of 16 does not divide llama3.2-3b's 24
query heads, qwen2-vl-2b's 12, arctic-480b's 56 or recurrentgemma-2b's
10. The reference's `spec_for` splits `wq` into blocks of Hq*hd/ms
columns all the same (its partitioner regroups them), and so does the
port (`launch.tp.ModelAxis.head_split`): the rank's block of q is
all-gathered to every head, the rank attends with the heads its rows of
`wo` read and takes its columns of their output. Held here on (1, 4)
gloo meshes (`tests/torch_dist_workers.py`) against the reference's
mesh-free functions, with the reduced configs' query heads raised to 6
(96 columns, 24 a rank: one and a half heads):

* the loss and gradient at fp32 (`tp_grad`, sequence parallelism on and
  off): llama with 2 KV heads (each rank's heads in one KV group), with
  `gqa_expand`, with 3 KV heads (ranks whose heads cross two groups, the
  expanded path), qwen2-vl (M-RoPE and patches) and recurrentgemma (its
  attention layers beside the RG-LRU). Bounds as `test_torch_tp.py`'s:
  the loss 1e-5 relative, every leaf of the gathered gradient 1e-4 of its
  largest entry.
* llama's mesh prefill and 8 serve steps from the reference's cache
  (split by positions: 2 KV heads over 4 ranks) against the reference's
  `prefill` and `decode_step`, `test_torch_tp.py`'s bounds.

Mamba2's SSD heads and whisper's heads are not split inside a head: where
the axis does not divide them, or where it does not divide a decoder's
Hq*hd columns, that attention or mixer runs whole on every model rank
(`tests/test_torch_model_sizes.py`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config, reduced
from repro_torch.core.tree import tree_map
from repro_torch.models import build_model

from torch_dist_workers import start_ranks

B, S = 4, 16
HEADS = 6
GRAD_CASES = {  # name: (arch, KV heads or None, settings)
    "llama": ("llama3.2-3b", None, {}),
    "llama-expand": ("llama3.2-3b", None, {"gqa_expand": True}),
    "llama-kv3": ("llama3.2-3b", 3, {}),
    "qwen2-vl": ("qwen2-vl-2b", None, {}),
    "recurrentgemma": ("recurrentgemma-2b", None, {}),
}
PROMPT, MAX_SEQ, FEED = 6, 32, 8
BF16_TOL = 3e-2


def _cfg(reduce, get, arch, kv=None):
    kw = {"n_heads": HEADS}
    if kv:
        kw["n_kv_heads"] = kv
    return dataclasses.replace(reduce(get(arch)), **kw)


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


def _grad_case(arch, kv):
    cfg = _cfg(reduced, get_config, arch, kv)
    params = tree_map(lambda t: t.numpy(),
                      build_model(cfg).init(torch.Generator().manual_seed(1)))
    return params, _batch(cfg, 2)


def _grad_reference(arch, kv, params, batch):
    jm = jbuild_model(_cfg(jreduced, jget_config, arch, kv))
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(
        p, b, compute_dtype=jnp.float32)))(
            jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def _serve_reference(arch):
    jm = jbuild_model(_cfg(jreduced, jget_config, arch))
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
    """The gradient cases' ranks, then the serving case's, both started
    before the reference's side is computed."""
    cases = {name: _grad_case(arch, kv)
             for name, (arch, kv, _) in GRAD_CASES.items()}
    payload = [{"name": name, "arch": arch, "heads": HEADS, "settings": st,
                "params": cases[name][0], "batch": cases[name][1]}
               for name, (arch, kv, st) in GRAD_CASES.items()]
    for case, (_, kv, _) in zip(payload, GRAD_CASES.values()):
        if kv:
            case["kv_heads"] = kv
    grad = start_ranks("tp_grad", 4, tmp_path_factory.mktemp("grad"),
                       {"cases": payload}, shape=(1, 4),
                       names=("data", "model"))
    serve_ref = _serve_reference("llama3.2-3b")
    serve = start_ranks(
        "tp_serve", 4, tmp_path_factory.mktemp("serve"),
        {"cases": [{"name": "llama", "arch": "llama3.2-3b", "heads": HEADS,
                    **{k: serve_ref[k] for k in ("params", "tokens",
                                                 "cache", "feed")}}]},
        shape=(1, 4), names=("data", "model"))
    refs = {name: _grad_reference(arch, kv, *cases[name])
            for name, (arch, kv, _) in GRAD_CASES.items()}
    return grad(), refs, serve(), serve_ref


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_split_head_loss_and_gradient_match_the_reference(runs, name):
    got, refs, _, _ = runs
    loss, grads = refs[name]
    for rank in got:
        for sp in (True, False):
            r = rank[name][sp]
            assert r["loss"] == pytest.approx(loss, rel=1e-5)
            assert len(r["grads"]) == len(grads)
            for g, want in zip(r["grads"], grads):
                scale = max(float(np.abs(want).max()), 1e-30)
                assert float(np.abs(g.numpy() - want).max()) <= 1e-4 * scale


def test_split_head_prefill_and_serve_steps_match_the_reference(runs):
    _, _, serve, ref = runs
    for rank in serve:
        r = rank["llama"]
        assert r["layout"] == "seq"
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
