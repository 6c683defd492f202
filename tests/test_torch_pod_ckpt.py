"""Checkpoints of a pod mesh: the port's train loop on 2 and 4 gloo ranks
(`tests/torch_dist_workers.py`, a `file://` store, no fixed port).

Each rank holds its own pod's error-feedback row; a save gathers the rows
into the reference's `(npod, ...)` layout on rank 0, which writes. Held:
a crash-restart bit-equal to an uninterrupted run (dense EF, 2 and 4
pods); the 2-pod checkpoint read by the reference's `checkpointer.restore`
into the same `(npod, ...)` arrays; `resume_elastic` onto 1 and 4 pods
bit-equal to the reference's `respec_pod_ef` on those arrays, and
`resume_pod_rank` on 4 ranks handing each its row; the sketched record of
the stacked rows equal to the reference codec's (its `n_buckets`, its
`y` within TOL of the reference's encode, its decode within TOL of the
reference's decode, on the reference's operators carried across); a
SIGTERM on one rank alone saving on both and stopping both; and the
train CLI on two ranks checkpointing a sketched record, crashing with
`--crash-at` and resuming on the next launch. Every multi-rank case has
its own timeout.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import rp as jrp
from repro.ckpt import checkpointer as jck
from repro.ckpt import elastic as jelastic
from repro.ckpt.sketched import SketchedTreeCodec as JCodec
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.sketch import SketchConfig as JSketchConfig
from repro.models import build_model as jbuild_model
from repro_torch import rp
from repro_torch.ckpt import (CKPT_KEY, SketchedTreeCodec, checkpointer,
                              resume_elastic)
from repro_torch.core import from_numpy_operator
from repro_torch.core.tree import tree_leaves

from torch_dist_workers import run_ranks, start_ranks

CFG = dict(family="tt", k=64, rank=2, dims=(4, 8, 16), bucket_elems=512)
KEY = 0x5EED
STEPS = 4
TOL = 1e-5        # the sketched record against the reference's codec
TIMEOUT = 150.0   # seconds a case's ranks may take
SIGNALLED = 1     # the rank that alone gets the SIGTERM


def _ops(base, steps):
    """{port seed: the reference's operator arrays} for `base`'s steps."""
    jcfg = JSketchConfig(**CFG)
    out = {}
    for s in steps:
        jop = jrp.make_projector(jcfg.spec(), jax.random.fold_in(
            jax.random.PRNGKey(base), s))
        out[base * 1_000_003 + s] = ("tt", [np.asarray(a)
                                            for a in jop.cores])
    return out


@functools.lru_cache(maxsize=1)
def _base():
    """The reference's initial state of the reduced model (numpy) and its
    operators for the compressor's and the codec's seeds."""
    jm = jbuild_model(jreduced(jget_config("llama3.2-3b")))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    zeros = jax.tree.map(np.zeros_like, params)
    ops = _ops(KEY, range(STEPS + 2))
    ops.update(_ops(CKPT_KEY, range(STEPS + 2)))
    return {"params": params, "opt": {"m": zeros, "v": zeros,
                                      "count": np.int64(0)}}, ops


def _payload(tmp, **kw):
    state, ops = _base()
    pl = dict(state=state, ops=ops, cfg=CFG, seq=16, steps=STEPS,
              crash_at=3, sketched=False, dir=str(tmp / "ckpt"))
    pl["async"] = True
    pl.update(kw)
    return pl


def _start(name, world, tmp, **kw):
    """Start `name` on `world` ranks; returns the function that waits for
    them and returns (payload, the ranks' results), once."""
    pl = _payload(tmp, **kw)
    wait = start_ranks(name, world, tmp, pl, shape=(world, 1, 1),
                       names=("pod", "data", "model"), timeout=TIMEOUT)
    return functools.lru_cache(maxsize=1)(lambda: (pl, wait()))


@pytest.fixture(scope="module")
def two_rank_runs(tmp_path_factory):
    """The module's 2-rank runs, started together so that their ranks
    overlap: the dense-EF and the sketched crash-restart, the SIGTERM on
    one rank, and the train CLI's first launch (`_cli_argv`, crashing at
    step 3). Name -> the function that waits for a run."""
    cli = tmp_path_factory.mktemp("cli")
    first = start_ranks("cli", 2, cli / "a",
                        {"argv": _cli_argv(cli / "ck") + ["--crash-at", "3"]},
                        shape=(2,), names=("pod",), timeout=TIMEOUT)
    return {"cli": functools.lru_cache(maxsize=1)(lambda: (cli, first())),
            "dense": _start("pod_ckpt", 2, tmp_path_factory.mktemp("dense2")),
            "sketched": _start("pod_ckpt", 2,
                               tmp_path_factory.mktemp("sketched"),
                               sketched=True),
            "sigterm": _start("pod_sigterm", 2,
                              tmp_path_factory.mktemp("sigterm"),
                              signalled=SIGNALLED, steps=6)}


@pytest.fixture(scope="module")
def dense_runs(two_rank_runs, tmp_path_factory):
    """world -> (world, payload, the ranks' results) of the dense-EF
    crash-restart on `world` pods, each run once a module. The 4-pod run
    also restores the 2-pod run's checkpoint (`resume_pod_rank`)."""
    runs = {2: (2, *two_rank_runs["dense"]())}

    def get(world):
        if world not in runs:
            runs[world] = (world, *_start(
                "pod_ckpt", world, tmp_path_factory.mktemp(f"dense{world}"),
                resume_dir=runs[2][1]["dir"])())
        return runs[world]
    return get


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("world", [2, 4])
def test_pod_crash_restart_is_bit_equal(dense_runs, world):
    world, _, out = dense_runs(world)
    assert len(out) == world
    for o in out:
        assert (o["restarts"], o["final_step"]) == (1, STEPS)
        for part in ("params", "opt", "ef"):
            _equal(o["resumed"][part], o["plain"][part])
        for rows in o["restored_ef"]:
            _equal(rows, o["resumed"]["ef"])
    for o in out[1:]:       # params and moments: the same bits on every pod
        _equal(o["resumed"]["params"], out[0]["resumed"]["params"])
        _equal(o["resumed"]["opt"], out[0]["resumed"]["opt"])


def _jexample(npod):
    """The reference's example tree of the checkpoint: params, opt, and
    the EF with a leading pod dim."""
    jm = jbuild_model(jreduced(jget_config("llama3.2-3b")))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    return {"params": shapes,
            "opt": {"m": shapes, "v": shapes,
                    "count": jax.ShapeDtypeStruct((), jnp.int32)},
            "ef": {"residual": jax.tree.map(lambda s: jax.ShapeDtypeStruct(
                (npod,) + s.shape, s.dtype), shapes)}}


@pytest.mark.parametrize("world", [2, 4])
def test_reference_restores_the_pod_checkpoint(dense_runs, world):
    world, pl, out = dense_runs(world)
    got, step = jck.restore(pl["dir"], _jexample(world))
    assert step == STEPS
    manifest = checkpointer.read_manifest(pl["dir"], STEPS)
    assert manifest["extra"]["npod"] == world
    ef = [np.asarray(x) for x in jax.tree.leaves(got["ef"])]
    for i, leaf in enumerate(ef):
        want = np.stack([o["resumed"]["ef"][i].numpy() for o in out])
        np.testing.assert_array_equal(leaf, want)
    for a, b in zip(jax.tree.leaves(got["params"]),
                    out[0]["resumed"]["params"]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _meta_like(tree):
    """Meta tensors shaped like a tree of arrays or shape structs."""
    return {k: _meta_like(v) if isinstance(v, dict) else torch.empty(
        v.shape, dtype=torch.int64 if v.shape == () else torch.float32,
        device="meta") for k, v in tree.items()}


def test_elastic_resume_matches_reference_respec(dense_runs):
    """The 2-pod checkpoint onto 1 and 4 pods."""
    world, pl, _ = dense_runs(2)
    saved, _ = jck.restore(pl["dir"], _jexample(world))
    rows = _jexample(1)["params"]
    for new in (1, 4):
        want = jax.tree.leaves(jelastic.respec_pod_ef(saved["ef"], world,
                                                      new))
        example = _meta_like(_jexample(new))
        if new == 1:
            example["ef"] = _meta_like({"residual": rows})
        got, step = resume_elastic(pl["dir"], example, npod_new=new,
                                   device="cpu")
        assert step == STEPS
        for a, b in zip(tree_leaves(got["ef"]), want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # on 4 ranks (the 4-pod run's), each gets its row of that respec
    for r, o in enumerate(dense_runs(4)[2]):
        step, ef = o["elastic"]
        assert step == STEPS
        for a, b in zip(ef, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b)[r])


def test_reference_pod_checkpoint_restores_in_the_port(tmp_path):
    """The other way: a 2-pod dense checkpoint written by the reference's
    checkpointer restores in the port, rows as they are on 2 pods and
    their fixed-order sum on 1."""
    jm = jbuild_model(jreduced(jget_config("llama3.2-3b")))
    params = jm.init(jax.random.PRNGKey(0))
    r = np.random.default_rng(4)
    ef = jax.tree.map(lambda x: jnp.asarray(r.standard_normal(
        (2,) + x.shape).astype(np.float32)), params)
    state = {"params": params,
             "opt": {"m": params, "v": params,
                     "count": jnp.asarray(3, jnp.int32)},
             "ef": {"residual": ef}}
    jck.save(tmp_path, 6, state, extra={"npod": 2})
    for new in (2, 1):
        example = _meta_like(_jexample(new))
        if new == 1:
            example["ef"] = _meta_like({"residual": _jexample(1)["params"]})
        got, step = resume_elastic(tmp_path, example, npod_new=new,
                                   device="cpu")
        assert step == 6 and int(got["opt"]["count"]) == 3
        for a, b in zip(tree_leaves(got["ef"]), jax.tree.leaves(ef)):
            b = np.asarray(b)
            np.testing.assert_array_equal(a.numpy(),
                                          b if new == 2 else b[0] + b[1])
        for a, b in zip(tree_leaves(got["params"]),
                        jax.tree.leaves(params)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _carry(monkeypatch, ops):
    made = {s: from_numpy_operator(f, a, "cpu") for s, (f, a) in ops.items()}
    monkeypatch.setattr(rp, "make_projector",
                        lambda spec, seed=0, *, device=None: made[seed])


def test_sketched_pod_record_is_the_reference_codecs(two_rank_runs,
                                                     monkeypatch):
    pl, out = two_rank_runs["sketched"]()
    _carry(monkeypatch, pl["ops"])
    for o in out:
        assert (o["restarts"], o["final_step"]) == (1, STEPS)
        # the record decodes to the same bits twice on a rank
        _equal(o["restored_ef"][0], o["restored_ef"][1])
    jshapes = _jexample(2)["ef"]
    jcodec = JCodec(JSketchConfig(**CFG), jshapes)
    manifest = checkpointer.read_manifest(pl["dir"], STEPS)
    meta = manifest["extra"]["sketched_ef"]
    assert manifest["extra"]["npod"] == 2
    assert meta["n_buckets"] == jcodec.meta()["n_buckets"]
    codec = SketchedTreeCodec.from_meta(meta, _meta_like(jshapes),
                                        device="cpu")
    example = _meta_like({k: v for k, v in _jexample(2).items()
                          if k != "ef"})
    example["ef"] = codec.record_shapes()
    rec = checkpointer.restore(pl["dir"], example, STEPS)[0]["ef"]
    # the record is the reference codec's encode of the stacked rows ...
    leaves, treedef = jax.tree.flatten(jshapes)
    stacked = jax.tree.unflatten(treedef, [
        jnp.asarray(np.stack([o["resumed"]["ef"][i].numpy() for o in out]))
        for i in range(len(leaves))])
    jrec = jcodec.encode(stacked, step=STEPS)
    y, jy = rec["y"].numpy(), np.asarray(jrec["y"])
    assert y.shape == jy.shape
    assert np.abs(y - jy).max() <= TOL * np.abs(jy).max()
    # ... and decodes like the reference's decode of the same y; each
    # rank restored its own row of that decode
    want = jcodec.decode({"y": jnp.asarray(y), "seed": jrec["seed"],
                          "step": jrec["step"]})
    mine = codec.decode(rec)
    for i, (a, b) in enumerate(zip(tree_leaves(mine),
                                   jax.tree.leaves(want))):
        b = np.asarray(b)
        top = np.abs(b).max()
        assert np.abs(a.numpy() - b).max() <= TOL * top
        for r, o in enumerate(out):
            assert np.abs(o["restored_ef"][0][i].numpy() - b[r]).max() \
                <= TOL * top


@pytest.mark.parametrize("signalled", [SIGNALLED])
def test_sigterm_on_one_rank_saves_on_both(signalled, two_rank_runs):
    pl, out = two_rank_runs["sigterm"]()
    assert pl["signalled"] == signalled
    for o in out:
        assert o["final_step"] == 2
        assert "[shutdown] SIGTERM honored at step 1" in o["logs"]
    assert checkpointer.available_steps(pl["dir"]) == [2]
    got, step = jck.restore(pl["dir"], _jexample(2))
    assert step == 2
    for i, leaf in enumerate(jax.tree.leaves(got["ef"])):
        np.testing.assert_array_equal(
            np.asarray(leaf), np.stack([o["ef"][i].numpy() for o in out]))


def _cli_argv(ck):
    """The train CLI's arguments: two pods, a sketched EF record every 2
    steps into `ck`."""
    return ["--arch", "llama3.2-3b", "--reduced", "--mesh", "2x1x1",
            "--dist-backend", "gloo", "--device", "cpu", "--steps", "4",
            "--batch", "2", "--seq", "16", "--compress",
            "tt:k=64,dims=4x8x16", "--compress-sync", "sketch-mean",
            "--ckpt-dir", str(ck), "--ckpt-every", "2", "--sketch-ef-ckpt"]


def test_train_cli_crash_and_resume_on_a_pod_mesh(two_rank_runs):
    """Two ranks of the train CLI with `--sketch-ef-ckpt` on a `2x1x1`
    mesh: the first launch checkpoints at step 2 and crashes at 3, the
    second resumes from step 2 and finishes."""
    tmp, first = two_rank_runs["cli"]()
    ck = tmp / "ck"
    argv = _cli_argv(ck)
    assert all(o["error"] == "RuntimeError: injected fault at step 3"
               for o in first), first
    assert checkpointer.available_steps(ck) == [2]
    extra = checkpointer.read_manifest(ck, 2)["extra"]
    assert extra["npod"] == 2
    assert extra["sketched_ef"]["n_buckets"] == JCodec(
        JSketchConfig(**CFG), _jexample(2)["ef"]).meta()["n_buckets"]
    second = run_ranks("cli", 2, tmp / "b", {"argv": argv},
                       shape=(2,), names=("pod",), timeout=TIMEOUT)
    assert all(o["error"] is None for o in second), second
    assert checkpointer.latest_step(ck) == 4
