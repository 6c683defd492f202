"""The model axis of a (data, model) mesh for the SSM, hybrid and
encoder-decoder families (mamba2-1.3b, recurrentgemma-2b, whisper-medium;
`launch/tp.py`) against repro.

As `tests/test_torch_tp.py` does for the decoder family, the port's ranks
(gloo processes, `tests/torch_dist_workers.py`'s `tp_family` and
`tp_steps`) are held against the reference's mesh-free functions on the
whole params (its mesh paths fail under the installed jax: ROADMAP.md,
"Reference caveats"), and against the port's own one-process steps. The
reduced configs, fp32 compute; every mamba2 block crosses `in_proj`'s
z/x boundary (rank 0's half of its 296 columns is all of z and 20
channels of x).

* Train on (1, 2), `seq_parallel` on and off (whisper's stream is whole
  either way): the loss (1e-5 relative) and every leaf of the gathered
  gradient (1e-4 of its largest entry) against the reference's
  `value_and_grad` and the port's one-process gradient (1e-5 relative,
  1e-5 of the largest entry); every leaf the model axis does not split
  has the same gradient bits on both ranks. The run without sequence
  parallelism is the one a missing `model_partial` (mamba2's `a_log`,
  `d_skip`, `dt_bias`, read on the rank's heads) would fail.
* Train on (2, 2), mamba2's fused step (`fused_update=True`, K4's block
  form through its plain version; `in_proj` a two-dim block, its data
  dim over 'data' and its columns over 'model'): three steps against the
  reference's `update_sketched` composition under
  `tests/test_torch_pod_data.py`'s bounds, the EF residual 1e-4 of its
  largest entry and the same bits on every rank.
* Serve on (1, 2): the mesh prefill step's logits, then 4 mesh serve
  steps at positions 6-9 from an empty cache (the hybrid's ring of 8
  slots, 4 a rank, wraps: slots 6, 7 on rank 1, then 0, 1 on rank 0),
  against the port's one-process prefill and `decode_step` (1e-5 of the
  largest logit) and the reference's (1e-4); after each step the cache
  put back together from the ranks' blocks equals the one-process cache
  to 1e-5 of each leaf's largest entry, the ring's positions exactly
  (mamba2's conv and ssm states, the RG-LRU's states and its
  position-split ring, whisper's self and cross K/V). Each rank holds its
  block of the cache by `cache_specs`.
* The train CLI runs each of the three archs on `--mesh 1x2` under
  `torch.distributed.run` (whisper's batches with synthetic frames).
"""
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config, reduced
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.launch import fsdp, sharding, steps
from repro_torch.models import build_model, from_numpy_params
from repro_torch.models.config import ShapeSpec

from test_torch_pod_data import (BATCH, LR, SEQ, SKETCH, STEPS,
                                 _fused_reference, _hold, _ops, _rel, _setup)
from torch_dist_workers import start_ranks

FAMILIES = {"ssm": "mamba2-1.3b", "hybrid": "recurrentgemma-2b",
            "encdec": "whisper-medium"}
B, S = 4, 16
MAX_SEQ = 16
POS0, FEED = 6, 4
FUSED = "mamba2-1.3b"
F32 = torch.float32
REPO = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _case(arch):
    """The params (the port's init, as numpy), a training batch (whisper's
    with frames), and the serving side's prompt, fed tokens and
    positions."""
    cfg = reduced(get_config(arch))
    params = tree_map(lambda t: t.numpy(), build_model(cfg).init(
        torch.Generator().manual_seed(1)))
    rng = np.random.default_rng(2)
    batch = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    feed = [rng.integers(0, cfg.vocab, (B,)).astype(np.int32)
            for _ in range(FEED)]
    pos = [np.full((B,), POS0 + i, np.int32) for i in range(FEED)]
    return cfg, params, batch, feed, pos


def _payload():
    grad, serve = [], []
    for arch in FAMILIES.values():
        _, params, batch, feed, pos = _case(arch)
        grad.append({"name": arch, "arch": arch, "params": params,
                     "batch": batch})
        sc = {"name": arch, "arch": arch, "params": params,
              "tokens": batch["tokens"], "feed": feed, "pos": pos,
              "max_seq": MAX_SEQ}
        if "frames" in batch:
            sc["frames"] = batch["frames"]
        serve.append(sc)
    return {"grad": grad, "serve": serve}


def _reference(arch):
    """The reference's loss and gradient, its last-token logits of the
    prompt (the prefill step's, no softcap), and its decode steps' logits
    from `init_cache` (whisper's cross K/V built from `encode`)."""
    _, params, batch, feed, pos = _case(arch)
    jm = jbuild_model(jreduced(jget_config(arch)))
    cfg, fam = jm.cfg, jm.mod
    jp = jax.tree.map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(
        p, b, compute_dtype=jnp.float32)))(jp, jb)
    if cfg.family == "encdec":
        enc = fam.encode(cfg, jp, jb["frames"], compute_dtype=jnp.float32)
        h = fam.decode_hidden(cfg, jp, jb["tokens"], enc,
                              compute_dtype=jnp.float32)
    else:
        h = fam.forward_hidden(cfg, jp, jb["tokens"],
                               compute_dtype=jnp.float32)
    prefill = np.asarray(h[:, -1].astype(jnp.float32) @ jp["embed"].T)
    cache = jm.init_cache(B, MAX_SEQ, jnp.float32)
    if cfg.family == "encdec":
        cache = fam.build_cross_cache(cfg, jp, enc, cache,
                                      compute_dtype=jnp.float32)
    step = jax.jit(lambda c, t, q: jm.decode_step(
        jp, c, t, q, compute_dtype=jnp.float32))
    logits = []
    for tok, p in zip(feed, pos):
        lg, cache = step(cache, jnp.asarray(tok), jnp.asarray(p))
        logits.append(np.asarray(lg))
    return {"loss": float(loss),
            "grads": [np.asarray(g) for g in jax.tree.leaves(grads)],
            "prefill": prefill, "steps": logits}


def _one_process(arch):
    """The port's own loss, gradient, prefill step and decode steps on one
    process (fp32), the cache after each step."""
    cfg, params, batch, feed, pos = _case(arch)
    model = build_model(cfg)
    p = from_numpy_params(cfg, params, device="cpu")
    leaves, treedef = tree_flatten(p)
    live = [t.clone().requires_grad_(True) for t in leaves]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = model.loss_fn(tree_unflatten(treedef, live), tb,
                         compute_dtype=F32)
    grads = torch.autograd.grad(loss, live)
    pre = steps.build_prefill_step(model, ShapeSpec("p", S, B, "prefill"),
                                   compute_dtype=F32)
    prefill = pre(p, {k: v for k, v in tb.items() if k != "labels"})
    cache = model.init_cache(B, MAX_SEQ, F32, device="cpu")
    if cfg.family == "encdec":
        with torch.inference_mode():
            enc = model.mod.encode(cfg, p, tb["frames"], compute_dtype=F32)
            model.mod.build_cross_cache(cfg, p, enc, cache,
                                        compute_dtype=F32)
    rows = []
    for tok, q in zip(feed, pos):
        lg, cache = model.decode_step(p, cache, torch.from_numpy(tok),
                                      torch.from_numpy(q), compute_dtype=F32)
        rows.append({"logits": lg.clone(),
                     "cache": tree_map(lambda t: t.clone(), cache)})
    return {"loss": float(loss.detach()), "grads": list(grads),
            "prefill": prefill, "steps": rows}


def _cli(arch, tmp):
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
            "--arch", arch, "--reduced", "--mesh", "1x2", "--dist-backend",
            "gloo", "--device", "cpu", "--steps", "2", "--batch", "4",
            "--seq", "16"]
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp), "TMPDIR": str(tmp), "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The (1, 2) ranks (training and serving), the (2, 2) fused ranks and
    the CLI runs, started before the reference's and the one-process
    sides are computed."""
    cli = {arch: _cli(arch, tmp_path_factory.mktemp(f"cli_{family}"))
           for family, arch in FAMILIES.items()}
    fam = start_ranks("tp_family", 2, tmp_path_factory.mktemp("family"),
                      _payload(), shape=(1, 2), names=("data", "model"))
    _, _, _, state, batches = _setup(FUSED)
    fused = start_ranks(
        "tp_steps", 4, tmp_path_factory.mktemp("fused"),
        {"arch": FUSED, "state": state, "batches": batches, "seq": SEQ,
         "batch": BATCH, "lr": LR, "ops": _ops(), "cfg": SKETCH,
         "modes": ["fused"]}, shape=(2, 2), names=("data", "model"))
    refs = {arch: _reference(arch) for arch in FAMILIES.values()}
    ones = {arch: _one_process(arch) for arch in FAMILIES.values()}
    fused_ref = _fused_reference(FUSED, 1)
    outs = {arch: p.communicate(timeout=240)[0] for arch, p in cli.items()}
    return {"family": fam(), "fused": fused(), "fused_ref": fused_ref,
            "refs": refs, "ones": ones,
            "cli": {arch: (cli[arch].returncode, outs[arch]) for arch in cli}}


def _close(got, want, tol):
    want = torch.as_tensor(np.array(want))
    return float((got - want).abs().max()) <= tol * max(
        float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_gradient_match_the_reference_and_one_process(runs, family):
    arch = FAMILIES[family]
    ref, one = runs["refs"][arch], runs["ones"][arch]
    for rank in runs["family"]:
        res = rank["grad"][arch]
        for sp in (True, False):
            r = res[sp]
            assert r["loss"] == pytest.approx(ref["loss"], rel=1e-5)
            assert r["loss"] == pytest.approx(one["loss"], rel=1e-5)
            assert len(r["grads"]) == len(ref["grads"])
            for g, want, mine in zip(r["grads"], ref["grads"],
                                     one["grads"]):
                assert _close(g, want, 1e-4)
                assert _close(g, mine, 1e-5)
        assert res[True]["loss"] == pytest.approx(res[False]["loss"],
                                                  rel=1e-6)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_replicated_leaves_have_the_same_gradient_bits_on_both_ranks(
        runs, family):
    arch = FAMILIES[family]
    first, other = (rank["grad"][arch] for rank in runs["family"])
    for sp in (True, False):
        assert first[sp]["rep"]     # the norms at least
        assert set(first[sp]["rep"]) == set(other[sp]["rep"])
        for path, g in first[sp]["rep"].items():
            assert g.equal(other[sp]["rep"][path]), (sp, path)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_mesh_prefill_and_serve_match_one_process_and_the_reference(
        runs, family):
    arch = FAMILIES[family]
    ref, one = runs["refs"][arch], runs["ones"][arch]
    for rank in runs["family"]:
        r = rank["serve"][arch]
        assert _close(r["prefill"], one["prefill"], 1e-5)
        assert _close(r["prefill"], ref["prefill"], 1e-4)
        for i, (row, mine, want) in enumerate(zip(r["steps"], one["steps"],
                                                  ref["steps"])):
            assert _close(row["logits"], mine["logits"], 1e-5), i
            assert _close(row["logits"], want, 1e-4), i
            got, base = _flat(row["cache"]), _flat(mine["cache"])
            assert set(got) == set(base)
            for k, t in base.items():
                if t.dtype == torch.int32:      # the ring's positions
                    assert torch.equal(got[k], t), (i, k)
                else:
                    assert _close(got[k], t, 1e-5), (i, k)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_each_rank_holds_its_block_of_the_cache(runs, family):
    arch = FAMILIES[family]
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    cache = model.init_cache(B, MAX_SEQ, device="meta")
    mesh = _MeshOf((1, 2))
    want = {k: tuple(fsdp.block(t, s, mesh).shape) for (k, t), s in zip(
        _flat(cache).items(), _flat(sharding.cache_specs(
            cfg, cache, mesh)).values())}
    layout = {"ssm": None, "hybrid": "seq", "encdec": "heads"}[family]
    for rank in runs["family"]:
        r = rank["serve"][arch]
        assert r["layout"] == layout
        assert r["held"] == want
        assert any(want[k] != tuple(t.shape)
                   for k, t in _flat(cache).items())


class _MeshOf:
    """A stand-in (data, model) mesh whose groups give rank 0's index:
    enough for `fsdp.block`'s shapes."""

    def __init__(self, shape):
        self.shape = dict(zip(("data", "model"), shape))
        self.axis_names = ("data", "model")

    def group(self, axes):
        n = 1
        for a in axes:
            n *= self.shape[a]
        return type("G", (), {"size": n, "index": 0, "axes": tuple(axes)})()


def test_mamba2_fused_step_on_2x2_matches_update_sketched(runs):
    out, want = runs["fused"], runs["fused_ref"]
    firm = [True] * len(want[0]["v"])
    for i in range(STEPS):
        got = out[0]["fused"]["runs"][i]
        firm = _hold(got, want[i], i, firm)
        for a, b in zip(got["ef"], want[i]["ef"]):
            assert _rel(a, b) <= 1e-4, "ef"
        for o in out[1:]:
            for part in ("params", "m", "v", "ef"):
                for a, b in zip(o["fused"]["runs"][i][part], got[part]):
                    assert torch.equal(a, b)   # the residual's bits too


def test_mamba2_fused_step_runs_k4s_two_dim_block_on_in_proj(runs):
    """Each rank holds its blocks of params (m and v alike) by the
    reference's `param_specs` on (2, 2), `in_proj` a two-dim block, and
    the EF residual whole; every step dispatches one K1 and one K4 (its
    block form) a leaf."""
    cfg = reduced(get_config(FUSED))
    model = build_model(cfg)
    shapes = fsdp._flat_specs(model.param_shapes())
    names = list(shapes)
    j = names.index("layers/in_proj")
    L, D, N = shapes["layers/in_proj"].shape
    mesh = _MeshOf((2, 2))
    specs = fsdp._flat_specs(steps.state_specs(model, mesh,
                                               compressed=True)["params"])
    blocks = [tuple(fsdp.block(shapes[p], specs[p], mesh).shape)
              for p in names]
    assert blocks[j] == (L, D // 2, N // 2)
    n = len(names)
    for o in runs["fused"]:
        assert o["fused"]["held"] == blocks
        for r in o["fused"]["runs"]:
            assert [tuple(t.shape) for t in r["ef"]] == [
                tuple(shapes[p].shape) for p in names]
            assert r["dispatches"] == {"dense": n, "fused-update": n}
            assert r["calls"] == {"fused_update_block": n,
                                  "fused_update_buckets": 0}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_cli_on_a_model_mesh(runs, family):
    rc, out = runs["cli"][FAMILIES[family]]
    assert rc == 0, out[-3000:]
    assert "'model': 2" in out
    assert "finished at step 2" in out
