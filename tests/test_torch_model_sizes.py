"""Model sizes whose dims the axis does not divide, every family, against
repro.

The reference's `spec_for` lays out any model size: a dim the model axis
does not divide is replicated. The port follows it leaf by leaf: a part
whose leaves the specs replicate runs whole on every model rank
(`models.<family>.split_parts`, `launch/tp.py`), and the gradient is
counted once (`launch.steps.grad_view`). Held here on gloo ranks
(`tests/torch_dist_workers.py`) against the reference's mesh-free
functions at fp32, the reference's side computed in a pool of two
processes meanwhile:

* the loss (1e-5 relative) and every leaf of the gathered gradient (1e-4
  of its largest entry), `seq_parallel` on and off, at S = 16 and S = 18
  (3 divides 18 and not 16, 4 the other way round), every replicated
  leaf's gradient with the same bits on every rank:
  (a) the reduced llama with 4 heads and d_ff 98 on (1, 4): the heads
      split, the FFN whole (before, its output was summed four times);
      and arctic with its dense residual FFN of 66 on (1, 4): the experts
      split, the dense FFN beside them whole;
  (b) the reduced llama, mamba2, recurrentgemma and whisper on (1, 3):
      the attention, mamba2's mixer, the RG-LRU block and the embedding
      whole, the MLPs of d_ff 96 split; and llama with 6 query heads on
      (1, 3): the attention split, its KV weights (2 heads) replicated,
      each rank's share of their gradient summed over the axis; and
      llama with d_model 96 on (1, 3): the embedding split over 'model',
      B*S = 64 rows that 3 does not divide, so the tied loss runs whole
      on every rank with the embedding gathered whole (its gradient
      alike, tag `model_whole`);
  (c) the reduced mixtral with its 4 experts and untied vocabulary of 256
      on (1, 3): the MoE and the unembedding whole;
* (d) mamba2's and whisper's mesh prefill and 8 serve steps on (1, 3)
  against the reference's prefill and `decode_step` (1e-4 of the largest
  logit), the caches whole on every rank;
* (e) mamba2's fused step on (1, 3) (K1 and K4 on every leaf, each K4
  block the whole leaf) against the reference's `update_sketched` composition and the
  port's one-rank step, the same bits on every rank;
* (f) the dry run of mamba2 and whisper on a fake (1, 3) mesh, each in a
  child process: status ok.
"""
import dataclasses
import json
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.tree import tree_map
from repro_torch.launch import sharding
from repro_torch.models import build_model

from test_torch_dryrun import _cells, _python, _wait
from test_torch_pod_data import (BATCH, LR, SEQ, SKETCH, STEPS,
                                 _fused_reference, _hold, _ops, _rel, _setup)
from torch_dist_workers import start_ranks

B = 4
LENGTHS = (16, 18)
# name: (arch, overrides, mesh)
GRAD = {
    "llama-ff98": ("llama3.2-3b", {"d_ff": 98}, (1, 4)),
    "arctic-ff66": ("arctic-480b", {"dense_residual_ff": 66}, (1, 4)),
    "llama": ("llama3.2-3b", {}, (1, 3)),
    "llama-h6": ("llama3.2-3b", {"n_heads": 6}, (1, 3)),
    "llama-d96": ("llama3.2-3b", {"d_model": 96}, (1, 3)),
    "mamba2": ("mamba2-1.3b", {}, (1, 3)),
    "recurrentgemma": ("recurrentgemma-2b", {}, (1, 3)),
    "whisper": ("whisper-medium", {}, (1, 3)),
    "mixtral": ("mixtral-8x22b", {}, (1, 3)),
}
# the config fields a case overrides, as `_tp_model` names them
WORKER_KEYS = {"n_heads": "heads", "d_ff": "d_ff", "d_model": "d_model",
               "dense_residual_ff": "dense_ff"}
SERVE = {"mamba2": "mamba2-1.3b", "whisper": "whisper-medium"}
MAX_SEQ, POS0, FEED = 16, 6, 8
FUSED = "mamba2-1.3b"


def _cfg(reduce, get, arch, kw):
    cfg = reduce(get(arch))
    kw = dict(kw)
    if "dense_residual_ff" in kw:   # a field of the MoE spec
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dense_residual_ff=kw.pop("dense_residual_ff")))
    return dataclasses.replace(cfg, **kw)


def _case(arch, kw, S):
    """The params (the port's init, as numpy) and a batch of S tokens
    (whisper's with frames), the same in every process."""
    cfg = _cfg(reduced, get_config, arch, kw)
    params = tree_map(lambda t: t.numpy(), build_model(cfg).init(
        torch.Generator().manual_seed(1)))
    rng = np.random.default_rng(S)
    batch = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return params, batch


def _serve_case(arch):
    """The params, a prompt of 16 tokens (whisper's frames), and the fed
    tokens and positions."""
    params, batch = _case(arch, {}, 16)
    rng = np.random.default_rng(7)
    feed = [rng.integers(0, 256, (B,)).astype(np.int32) for _ in range(FEED)]
    pos = [np.full((B,), POS0 + i, np.int32) for i in range(FEED)]
    return params, batch, feed, pos


def _grad_job(arch, kw):
    """The reference's loss and gradient at each length (a pool's job)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import build_model as jbuild_model
    jm = jbuild_model(_cfg(jreduced, jget_config, arch, kw))
    fn = jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(
        p, b, compute_dtype=jnp.float32)))
    out = {}
    for S in LENGTHS:
        params, batch = _case(arch, kw, S)
        loss, grads = fn(jax.tree.map(jnp.asarray, params),
                         {k: jnp.asarray(v) for k, v in batch.items()})
        out[S] = (float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)])
    return out


def _serve_job(arch):
    """The reference's last-token logits of the prompt (the prefill
    step's) and its decode steps' logits from `init_cache` (whisper's
    cross K/V built from `encode`), fp32 (a pool's job)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import build_model as jbuild_model
    params, batch, feed, pos = _serve_case(arch)
    jm = jbuild_model(jreduced(jget_config(arch)))
    cfg, fam = jm.cfg, jm.mod
    jp = jax.tree.map(jnp.asarray, params)
    f32 = jnp.float32
    if cfg.family == "encdec":
        enc = fam.encode(cfg, jp, jnp.asarray(batch["frames"]),
                         compute_dtype=f32)
        h = fam.decode_hidden(cfg, jp, jnp.asarray(batch["tokens"]), enc,
                              compute_dtype=f32)
    else:
        h = fam.forward_hidden(cfg, jp, jnp.asarray(batch["tokens"]),
                               compute_dtype=f32)
    prefill = np.asarray(h[:, -1].astype(f32) @ jp["embed"].T)
    cache = jm.init_cache(B, MAX_SEQ, f32)
    if cfg.family == "encdec":
        cache = fam.build_cross_cache(cfg, jp, enc, cache, compute_dtype=f32)
    step = jax.jit(lambda c, t, q: jm.decode_step(jp, c, t, q,
                                                  compute_dtype=f32))
    logits = []
    for tok, p in zip(feed, pos):
        lg, cache = step(cache, jnp.asarray(tok), jnp.asarray(p))
        logits.append(np.asarray(lg))
    return {"prefill": prefill, "steps": logits}


def _job(kind, arch=None, kw=None):
    if kind == "grad":
        return _grad_job(arch, kw)
    if kind == "serve":
        return _serve_job(arch)
    return _fused_reference(FUSED, 1)


def _grad_payload(names):
    cases = []
    for name in names:
        arch, kw, _ = GRAD[name]
        for S in LENGTHS:
            params, batch = _case(arch, kw, S)
            cases.append({"name": f"{name}@{S}", "arch": arch,
                          **{WORKER_KEYS[k]: v for k, v in kw.items()},
                          "params": params, "batch": batch})
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks and the dry-run child started first, the reference's
    side computed in a pool of two processes meanwhile, the fused step's
    ranks once the first ranks are done."""
    mk = tmp_path_factory.mktemp
    four = start_ranks("tp_grad", 4, mk("four"), {"cases": _grad_payload(
        [n for n, c in GRAD.items() if c[2] == (1, 4)])}, shape=(1, 4),
        names=("data", "model"))
    serve = []
    for arch in SERVE.values():
        params, batch, feed, pos = _serve_case(arch)
        serve.append({"name": arch, "arch": arch, "params": params,
                      "tokens": batch["tokens"], "feed": feed, "pos": pos,
                      "max_seq": MAX_SEQ,
                      **({"frames": batch["frames"]} if "frames" in batch
                         else {})})
    three = start_ranks("tp_family", 3, mk("three"), {
        "grad": _grad_payload([n for n, c in GRAD.items()
                               if c[2] == (1, 3)]), "serve": serve},
        shape=(1, 3), names=("data", "model"))
    dry = _python(_cells(repr([
        (f"{a}-{kind}", a, {}, shape, (1, 3)) for a in SERVE.values()
        for kind, shape in (("train", ("t", 18, 6, "train")),
                            ("decode", ("d", 16, 6, "decode")))])))
    jobs = ([("grad", arch, kw) for arch, kw, _ in GRAD.values()]
            + [("serve", arch) for arch in SERVE.values()] + [("fused",)])
    # two processes: the test runs beside other multi-process test files
    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        pending = pool.map(_job, *zip(*[j + (None,) * (3 - len(j))
                                        for j in jobs]))
        out = {"four": four(), "three": three()}
        _, _, _, state, batches = _setup(FUSED)
        fused_pl = {"arch": FUSED, "state": state, "batches": batches,
                    "seq": SEQ, "batch": BATCH, "lr": LR, "ops": _ops(),
                    "cfg": SKETCH, "modes": ["fused"]}
        fused = {n: start_ranks("tp_steps", n, mk(f"fused{n}"), fused_pl,
                                shape=(1, n), names=("data", "model"))
                 for n in (3, 1)}
        refs = list(pending)
    out["fused"] = {n: f() for n, f in fused.items()}
    out.update(grad_refs=dict(zip(GRAD, refs[:len(GRAD)])),
               serve_refs=dict(zip(SERVE.values(), refs[len(GRAD):-1])),
               fused_ref=refs[-1], dry=json.loads(_wait(dry)))
    return out


def _close(got, want, tol):
    want = torch.as_tensor(np.array(want))
    return float((got - want).abs().max()) <= tol * max(
        float(want.abs().max()), 1e-30)


def _ranks(runs, name):
    mesh = GRAD[name][2]
    if mesh == (1, 4):
        return [r for r in runs["four"]]
    return [r["grad"] for r in runs["three"]]


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("name", list(GRAD))
def test_loss_and_gradient_match_the_reference(runs, name, S):
    loss, grads = runs["grad_refs"][name][S]
    for rank in _ranks(runs, name):
        for sp in (True, False):
            r = rank[f"{name}@{S}"][sp]
            assert r["loss"] == pytest.approx(loss, rel=1e-5), sp
            assert len(r["grads"]) == len(grads)
            for g, want in zip(r["grads"], grads):
                assert _close(g, want, 1e-4), sp


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("name", list(GRAD))
def test_replicated_leaves_have_the_same_gradient_bits_on_every_rank(
        runs, name, S):
    first, *others = (r[f"{name}@{S}"] for r in _ranks(runs, name))
    for sp in (True, False):
        assert first[sp]["rep"]
        for other in others:
            assert set(other[sp]["rep"]) == set(first[sp]["rep"])
            for path, g in first[sp]["rep"].items():
                assert g.equal(other[sp]["rep"][path]), (sp, path)


def test_the_sizes_leave_parts_whole():
    """What each case runs whole: the parts its specs replicate."""
    def parts(name):
        arch, kw, mesh = GRAD[name]
        cfg = _cfg(reduced, get_config, arch, kw)
        stand = _Mesh(mesh)
        return build_model(cfg).mod.split_parts(cfg, stand)
    assert parts("llama-ff98") == {"attn": True, "ffn": False, "moe": False,
                                   "unembed": False, "embed": True}
    assert parts("arctic-ff66") == {"attn": True, "ffn": False, "moe": True,
                                    "unembed": True, "embed": True}
    assert parts("llama") == {"attn": False, "ffn": True, "moe": False,
                              "unembed": False, "embed": False}
    assert parts("llama-h6") == {"attn": True, "ffn": True, "moe": False,
                                 "unembed": False, "embed": False}
    assert parts("llama-d96") == {"attn": False, "ffn": True, "moe": False,
                                  "unembed": False, "embed": True}
    assert parts("mamba2") == {"mixer": False, "embed": False}
    assert parts("recurrentgemma") == {"rec": False, "mlp": True,
                                       "attn": False, "embed": False}
    assert parts("whisper") == {"attn": False, "mlp": True, "embed": False}
    assert parts("mixtral") == {"attn": False, "ffn": False, "moe": False,
                                "unembed": False, "embed": False}


class _Mesh:
    def __init__(self, shape):
        self.shape = dict(zip(("data", "model"), shape))
        self.axis_names = ("data", "model")


@pytest.mark.parametrize("arch", list(SERVE.values()))
def test_mesh_prefill_and_serve_match_the_reference(runs, arch):
    ref = runs["serve_refs"][arch]
    cfg = reduced(get_config(arch))
    cache = build_model(cfg).init_cache(B, MAX_SEQ, device="meta")
    whole = {k: tuple(v.shape) for k, v in cache.items()}
    assert all(e is None for s in sharding.cache_specs(
        cfg, cache, _Mesh((1, 3))).values() for e in s[2:])
    for rank in runs["three"]:
        r = rank["serve"][arch]
        assert r["layout"] is None and r["held"] == whole
        assert _close(r["prefill"], ref["prefill"], 1e-4)
        assert len(r["steps"]) == FEED
        for i, (row, want) in enumerate(zip(r["steps"], ref["steps"])):
            assert _close(row["logits"], want, 1e-4), i


def test_mamba2_fused_step_on_1x3_matches_the_reference_and_one_rank(runs):
    out, one, want = runs["fused"][3], runs["fused"][1], runs["fused_ref"]
    firm = [True] * len(want[0]["v"])
    for i in range(STEPS):
        got = out[0]["fused"]["runs"][i]
        firm = _hold(got, want[i], i, firm)
        for a, b in zip(got["ef"], want[i]["ef"]):
            assert _rel(a, b) <= 1e-4, "ef"
        mine = one[0]["fused"]["runs"][i]
        assert got["loss"] == pytest.approx(mine["loss"], rel=1e-6)
        for part in ("params", "m", "v", "ef"):
            for a, b in zip(got[part], mine[part]):
                assert _rel(a, b.numpy()) <= 1e-6, part
        for o in out[1:]:
            for part in ("params", "m", "v", "ef"):
                for a, b in zip(o["fused"]["runs"][i][part], got[part]):
                    assert torch.equal(a, b)   # the residual's bits too


def test_mamba2_fused_step_on_1x3_runs_k1_and_k4_on_whole_leaves(runs):
    """Every leaf of the reduced mamba2 is whole on (1, 3): each step
    dispatches one K1 and one K4 a leaf on every rank, K4 in the mesh
    step's block form, each block the whole leaf."""
    n = len(runs["fused_ref"][0]["params"])
    for o in runs["fused"][3]:
        held = o["fused"]["held"]
        assert held == runs["fused"][1][0]["fused"]["held"]
        for r in o["fused"]["runs"]:
            assert r["dispatches"] == {"dense": n, "fused-update": n}
            assert r["calls"] == {"fused_update_block": n,
                                  "fused_update_buckets": 0}


@pytest.mark.parametrize("arch", list(SERVE.values()))
def test_dry_run_counts_the_sizes(runs, arch):
    for kind in ("train", "decode"):
        cell = runs["dry"][f"{arch}-{kind}"]
        assert cell["status"] == "ok", cell
        assert cell["mesh"] == "1x3" and cell["kind"] == kind
        assert cell["roofline"]["hlo_flops_per_device"] > 0
