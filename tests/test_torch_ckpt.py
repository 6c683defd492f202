"""repro_torch.ckpt and repro_torch.runtime against repro.ckpt and
repro.runtime: the checkpoint format both ways, integrity and fallback,
the async checkpointer, retries and injected I/O faults, the sketched-EF
codec on the reference's operator, the elastic pod respec, the
fault-tolerant train loop (crash-restart, SIGTERM, the watchdog) and the
train CLI's checkpoint flags.

Trees are made with numpy from a seed and handed to both packages.
Dense float32 dict trees are readable by either package and come back
bit for bit. The sketched codec regenerates its operator with the port's
own sampler (seed `CKPT_KEY * 1_000_003 + step`), so the codec tests hand
the port the reference's operator for `fold_in(PRNGKey(CKPT_KEY), step)`
(`from_numpy_operator`; the port's `rp.make_projector` is monkeypatched
here only) and hold the sketch and the decoded tree to 1e-5 of their
largest entry (fp32, other summation orders). The crash-restart run
lands on the uninterrupted run's params at the reference test's
tolerance (rtol = atol = 1e-6).
"""
import functools
import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import rp as jrp
from repro.ckpt import SketchedTreeCodec as JCodec
from repro.ckpt import checkpointer as jck
from repro.ckpt import respec_pod_ef as jrespec
from repro.core.sketch import SketchConfig as JSketchConfig
from repro.runtime import resilience as jres
from repro_torch import rp
from repro_torch.ckpt import (CKPT_KEY, SketchedTreeCodec, checkpointer,
                              respec_pod_ef, resume_elastic)
from repro_torch.ckpt.checkpointer import CheckpointError, CorruptionError
from repro_torch.configs import get_config, reduced
from repro_torch.core import from_numpy_operator
from repro_torch.core.sketch import SketchConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import steps
from repro_torch.models import build_model
from repro_torch.models.config import ShapeSpec
from repro_torch.optim import schedule
from repro_torch.runtime import resilience, train_loop
from repro_torch.runtime.resilience import (FaultInjector, IOFaultInjector,
                                            IOFaultPlan, Watchdog,
                                            backoff_delays, flip_byte,
                                            retry_with_backoff,
                                            run_with_restarts)

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
SK = dict(family="tt", k=128, rank=2, dims=(4, 8, 16),
          bucket_elems=4 * 8 * 16, fresh_per_step=True)


def _np_tree(seed=0):
    """The reference test's tree: float32 (17, 5), int32 (3, 4), a float32
    scalar, as numpy."""
    r = np.random.default_rng(seed)
    return {"a": r.standard_normal((17, 5)).astype(np.float32),
            "b": {"w": np.arange(12, dtype=np.int32).reshape(3, 4),
                  "s": np.float32(3.5 + seed)}}


def _t(tree):
    """numpy tree -> torch tree (CPU)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_tree_equal(got, want):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


def _meta(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


# ---------------------------------------------------------------------------
# the format, both ways
# ---------------------------------------------------------------------------

def test_port_checkpoint_reads_in_the_reference_and_back(tmp_path):
    t = _np_tree(1)
    path = checkpointer.save(tmp_path / "p", 7, _t(t))
    assert jck.verify(path)["step"] == 7
    got, step = jck.restore(tmp_path / "p", jax.eval_shape(lambda: _j(t)))
    assert step == 7
    _assert_tree_equal(_t(jax.tree.map(np.asarray, got)), t)
    # and a reference-written checkpoint through the port
    jpath = jck.save(tmp_path / "j", 9, _j(t))
    assert checkpointer.verify(jpath)["step"] == 9
    got, step = checkpointer.restore(tmp_path / "j", _meta(_t(t)))
    assert step == 9 and all(x.device.type == "cpu"
                             for x in tree_leaves(got))
    _assert_tree_equal(got, t)
    # the manifests agree field for field, but for time, treedef, digest
    pm = json.loads((path / "manifest.json").read_text())
    jm = json.loads((jpath / "manifest.json").read_text())
    for key in ("n_arrays", "arrays", "extra"):
        assert pm[key] == jm[key], key


def _truncate(path):
    with open(path / "arr_0.npy", "r+b") as f:
        f.truncate(40)


CORRUPTIONS = {
    "truncated_array": (_truncate, "unreadable|truncated|drift"),
    "flipped_array_byte": (lambda p: flip_byte(p / "arr_0.npy", -1),
                           "checksum"),
    "flipped_manifest_byte": (lambda p: flip_byte(p / "manifest.json", -2),
                              "manifest"),
}


@pytest.mark.parametrize("kind", sorted(CORRUPTIONS))
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_both_packages_detect_the_same_corruption(tmp_path, kind, writer):
    t = _np_tree()
    path = (checkpointer.save(tmp_path, 3, _t(t)) if writer == "port"
            else jck.save(tmp_path, 3, _j(t)))
    corrupt, match = CORRUPTIONS[kind]
    corrupt(path)
    with pytest.raises(CorruptionError, match=match):
        checkpointer.verify(path)
    with pytest.raises(jck.CorruptionError, match=match):
        jck.verify(path)
    assert not checkpointer.is_verified(tmp_path, 3)
    assert not jck.is_verified(tmp_path, 3)


def test_save_restore_roundtrip_gc_and_devices(tmp_path):
    t = _t(_np_tree())
    for s in range(6):
        checkpointer.save(tmp_path, s, t, keep=2)
    names = sorted(p.name for p in tmp_path.glob("step_*"))
    assert names == ["step_0000000004", "step_0000000005"]
    assert checkpointer.available_steps(tmp_path) == [4, 5]
    got, step = checkpointer.restore(tmp_path, t)
    assert step == 5
    _assert_tree_equal(got, t)
    # an explicit device wins; a dtype change is a cast, as astype
    got, _ = checkpointer.restore(tmp_path, tree_map(
        lambda x: x.to(torch.float64) if x.is_floating_point() else x, t),
        device="cpu")
    assert got["a"].dtype == torch.float64
    np.testing.assert_array_equal(got["a"].numpy(),
                                  t["a"].numpy().astype(np.float64))


def test_bf16_leaves_roundtrip_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(0)
    t = {"w": torch.randn((33, 7), generator=g).to(torch.bfloat16),
         "s": torch.tensor(-1.5, dtype=torch.bfloat16),
         "f": torch.randn(5, generator=g)}
    path = checkpointer.save(tmp_path, 1, t)
    man = checkpointer.verify(path)
    assert [a["dtype"] for a in man["arrays"]] == ["float32", "bfloat16",
                                                  "bfloat16"]
    got, _ = checkpointer.restore(tmp_path, _meta(t))
    for key in t:
        assert got[key].dtype == t[key].dtype
        assert torch.equal(got[key].view(torch.int16) if key != "f"
                           else got[key],
                           t[key].view(torch.int16) if key != "f"
                           else t[key])
    flip_byte(path / "arr_1.npy", -1)
    with pytest.raises(CorruptionError, match="checksum"):
        checkpointer.verify(path)


def test_no_partial_checkpoints_on_failure(tmp_path):
    class Boom:
        pass
    with pytest.raises(TypeError, match="not a tensor"):
        checkpointer.save(tmp_path, 1, {"x": Boom()})
    assert checkpointer.latest_step(tmp_path) is None
    assert not list(tmp_path.glob("step_*"))
    assert not list(tmp_path.glob(".tmp_*"))


def test_restore_falls_back_to_newest_verified(tmp_path):
    for s in (1, 2, 3):
        checkpointer.save(tmp_path, s, _t(_np_tree(s)), keep=10)
    flip_byte(tmp_path / "step_0000000003" / "arr_0.npy")
    assert checkpointer.newest_verified_step(tmp_path) == 2
    example = _meta(_t(_np_tree()))
    got, step = checkpointer.restore(tmp_path, example)
    assert step == 2
    _assert_tree_equal(got, _np_tree(2))
    with pytest.raises(CorruptionError):
        checkpointer.restore(tmp_path, example, step=3, fallback=False)
    flip_byte(tmp_path / "step_0000000002" / "arr_1.npy")
    flip_byte(tmp_path / "step_0000000001" / "manifest.json")
    with pytest.raises(CorruptionError, match="no verifiable"):
        checkpointer.restore(tmp_path, example)
    # the reference reads the same directory the same way
    with pytest.raises(jck.CorruptionError, match="no verifiable"):
        jck.restore(tmp_path, jax.eval_shape(lambda: _j(_np_tree())))


def test_corrupted_manifest_via_injector_falls_back(tmp_path):
    checkpointer.save(tmp_path, 5, _t(_np_tree(5)), keep=10)
    io = IOFaultInjector(IOFaultPlan(corrupt_manifest=True))
    checkpointer.save(tmp_path, 6, _t(_np_tree(6)), keep=10, io=io)
    assert "flip:manifest.json" in io.injected
    _, step = checkpointer.restore(tmp_path, _meta(_t(_np_tree())))
    assert step == 5


def test_restore_typed_errors(tmp_path):
    t = _t(_np_tree())
    checkpointer.save(tmp_path, 1, t)
    with pytest.raises(CheckpointError, match="tree structure"):
        checkpointer.restore(tmp_path, {"a": t["a"]})
    wrong = dict(t)
    wrong["a"] = torch.empty((4, 4), device="meta")
    with pytest.raises(CheckpointError, match="shape"):
        checkpointer.restore(tmp_path, wrong)
    with pytest.raises(FileNotFoundError):
        checkpointer.restore(tmp_path / "none", t)
    assert issubclass(CorruptionError, CheckpointError)
    assert issubclass(CheckpointError, ValueError)


def test_restore_validation_survives_python_O(tmp_path):
    code = f"""
import torch
from repro_torch.ckpt import checkpointer
from repro_torch.ckpt.checkpointer import CheckpointError
d = {str(tmp_path)!r}
t = {{"a": torch.ones((3, 2)), "b": torch.zeros((4,))}}
checkpointer.save(d, 1, t)
for example, word in (({{"a": t["a"]}}, "tree structure"),
                      ({{"a": torch.ones(9, 9), "b": t["b"]}}, "shape")):
    try:
        checkpointer.restore(d, example)
    except CheckpointError as e:
        if word not in str(e):
            raise SystemExit(f"wrong message: {{e}}")
    else:
        raise SystemExit(f"{{word}} mismatch not caught under -O")
print("O_SAFE_OK")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-O", "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "O_SAFE_OK" in res.stdout, (
        res.stdout, res.stderr)


# ---------------------------------------------------------------------------
# retry / backoff / injected I/O faults / the supervisor
# ---------------------------------------------------------------------------

def test_retry_with_backoff_schedule_matches_the_reference():
    for pkg in (resilience, jres):
        slept, calls = [], {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] <= 3:
                raise OSError("transient")
            return "ok"

        out = pkg.retry_with_backoff(flaky, retries=4, base_delay=0.1,
                                     max_delay=0.25, sleep=slept.append)
        assert out == "ok" and calls["n"] == 4
        assert slept == [0.1, 0.2, 0.25]
        assert pkg.backoff_delays(3, base_delay=0.1, max_delay=0.25) == slept
        with pytest.raises(KeyError):
            pkg.retry_with_backoff(
                lambda: (_ for _ in ()).throw(KeyError("x")),
                sleep=slept.append)
    assert backoff_delays(6, base_delay=0.05, max_delay=2.0) == \
        jres.backoff_delays(6, base_delay=0.05, max_delay=2.0)
    assert retry_with_backoff(lambda: 3) == 3


@pytest.mark.parametrize("plan, retries, ok", [
    (IOFaultPlan(fail_writes=2), 3, True),
    (IOFaultPlan(fail_renames=2), 3, True),
    (IOFaultPlan(fail_renames=5), 2, False),
    (IOFaultPlan(fail_writes=5), 2, False),
], ids=["transient_writes", "transient_renames", "exhausted_renames",
        "exhausted_writes"])
def test_save_under_injected_io_faults(tmp_path, plan, retries, ok):
    io = IOFaultInjector(plan)
    if ok:
        checkpointer.save(tmp_path, 1, _t(_np_tree()), io=io,
                          retries=retries, base_delay=0.0)
        assert checkpointer.is_verified(tmp_path, 1)
        assert len(io.injected) == 2
    else:
        with pytest.raises(OSError, match="injected"):
            checkpointer.save(tmp_path, 1, _t(_np_tree()), io=io,
                              retries=retries, base_delay=0.0)
        assert checkpointer.latest_step(tmp_path) is None
    assert not list(tmp_path.glob(".tmp_*"))


def test_sweep_tmp_on_startup_and_save(tmp_path):
    orphan = tmp_path / ".tmp_deadbeef"
    orphan.mkdir(parents=True)
    (orphan / "arr_0.npy").write_bytes(b"partial")
    ck = checkpointer.AsyncCheckpointer(tmp_path)
    assert not orphan.exists()
    ck.close()
    orphan.mkdir()
    checkpointer.save(tmp_path, 1, _t(_np_tree()))
    assert not orphan.exists()


def test_async_checkpointer_saves_and_surfaces_errors(tmp_path):
    ck = checkpointer.AsyncCheckpointer(tmp_path / "ok", keep=2)
    t = _t(_np_tree())
    ck.save(3, t)
    ck.wait()
    got, step = checkpointer.restore(tmp_path / "ok", t)
    assert step == 3
    _assert_tree_equal(got, t)
    ck.close()
    io = IOFaultInjector(IOFaultPlan(fail_writes=50))
    ck = checkpointer.AsyncCheckpointer(tmp_path, io=io, retries=1)
    ck.save(1, t)
    ck._thread.join()
    with pytest.raises(OSError, match="injected"):
        ck.save(2, t)                    # fails THIS call
    ck.close()
    with checkpointer.AsyncCheckpointer(tmp_path, keep=2) as ck2:
        ck2.save(3, t)
    assert checkpointer.is_verified(tmp_path, 3)
    with pytest.raises(OSError, match="injected"):
        with checkpointer.AsyncCheckpointer(
                tmp_path, io=IOFaultInjector(IOFaultPlan(fail_writes=50)),
                retries=1) as ck3:
            ck3.save(4, t)
            ck3._thread.join()


def test_supervisor_fatal_vs_retryable_matches_the_reference():
    for pkg in (resilience, jres):
        rep = pkg.run_with_restarts(
            lambda inj: (_ for _ in ()).throw(ValueError("misconfigured")),
            max_restarts=3)
        assert not rep.completed and rep.restarts == 0
        assert "misconfigured" in rep.fatal_error
        slept, state = [], {"n": 0}

        def flaky(injector):
            state["n"] += 1
            if state["n"] <= 2:
                raise RuntimeError("preempted")
            return 7

        rep = pkg.run_with_restarts(flaky, max_restarts=3, base_delay=0.1,
                                    max_delay=0.15, sleep=slept.append)
        assert rep.completed and rep.restarts == 2 and rep.final_step == 7
        assert slept == [0.1, 0.15]
    assert resilience.FATAL_DEFAULT == jres.FATAL_DEFAULT


def test_watchdog_events_match_the_reference(monkeypatch):
    """The same sequence of step times through both watchdogs (a fake
    monotonic clock): the same events, scored against the pre-update
    EMA/variance."""
    dts = [0.02, 0.021, 0.019, 0.022, 0.02, 0.018, 0.021, 0.02, 0.2, 0.02,
           0.021, 0.019, 0.022, 0.5, 0.02]
    clock = {"t": 0.0}
    monkeypatch.setattr(time, "monotonic", lambda: clock["t"])
    got = []
    for wd in (Watchdog(warmup=2, z_thresh=3.0),
               jres.Watchdog(warmup=2, z_thresh=3.0)):
        clock["t"] = 100.0
        for s, dt in enumerate(dts):
            wd.start_step()
            clock["t"] += dt
            wd.end_step(s)
        got.append([(e.step, e.dt, e.ema, e.zscore) for e in wd.events])
    assert got[0] == got[1] and {8, 13} <= {e[0] for e in got[0]}
    with pytest.raises(ValueError, match="start_step"):
        Watchdog().end_step(0)


# ---------------------------------------------------------------------------
# the sketched codec, on the reference's operator
# ---------------------------------------------------------------------------

@pytest.fixture
def ckpt_ops(monkeypatch):
    """The port's make_projector hands out the reference's operator for
    `key_for(step)` of a codec with base key CKPT_KEY."""
    cache = {}

    def make(spec, seed=0, *, device=None):
        step = seed - CKPT_KEY * 1_000_003
        if (spec, step) not in cache:
            key = jax.random.fold_in(jax.random.PRNGKey(CKPT_KEY), step)
            jop = jrp.make_projector(jrp.ProjectorSpec(
                family=spec.family, k=spec.k, dims=spec.dims,
                rank=spec.rank), key)
            arrays = jop.cores if spec.family == "tt" else jop.factors
            cache[spec, step] = from_numpy_operator(
                spec.family, [np.asarray(a) for a in arrays], "cpu")
        return cache[spec, step]

    monkeypatch.setattr(rp, "make_projector", make)
    return cache


def _np_ef(npod=1, seed=1):
    r = np.random.default_rng(seed)
    lead = (npod,) if npod > 1 else ()
    return {"w": r.standard_normal(lead + (64, 32)).astype(np.float32),
            "b": r.standard_normal(lead + (128,)).astype(np.float32)}


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


def test_codec_matches_the_reference_on_its_operator(tmp_path, ckpt_ops):
    ef = _np_ef()
    jcodec = JCodec(JSketchConfig(**SK), jax.eval_shape(lambda: _j(ef)))
    codec = SketchedTreeCodec(SketchConfig(**SK), _meta(_t(ef)),
                              device="cpu")
    jrec = jcodec.encode(_j(ef), step=9)
    rec = codec.encode(_t(ef), step=9)
    assert set(rec) == set(jrec) == {"y", "seed", "step"}
    # the port tags its seed above the base key (the reference stores it
    # bare), so neither package decodes the other's record
    assert int(jrec["seed"]) == CKPT_KEY
    assert int(rec["seed"]) == (0x7254 << 48) | CKPT_KEY
    assert int(rec["step"]) == 9 and rec["y"].shape == (5, SK["k"])
    assert _rel(rec["y"], jrec["y"]) <= TOL
    # decode the REFERENCE's sketch with both: the same estimate
    want = jcodec.decode(jrec)
    got = codec.decode({"y": torch.from_numpy(np.array(jrec["y"])),
                        "seed": rec["seed"], "step": rec["step"]})
    for key in ef:
        assert _rel(got[key], want[key]) <= TOL, key
    # deterministic, through a disk round trip, and through from_meta
    d1, d2 = codec.decode(rec), codec.decode(rec)
    _assert_tree_equal(d1, d2)
    checkpointer.save(tmp_path, 9, rec)
    back, _ = checkpointer.restore(tmp_path, codec.record_shapes())
    assert back["seed"].dtype == torch.int64 and back["y"].device.type == "cpu"
    _assert_tree_equal(codec.decode(back), d1)
    codec2 = SketchedTreeCodec.from_meta(codec.meta(), _meta(_t(ef)),
                                         device="cpu")
    assert codec2.meta() == codec.meta() == {**jcodec.meta(),
                                             "generator": "repro_torch"}
    _assert_tree_equal(codec2.decode(rec), d1)
    assert codec.sketch_bytes() == jcodec.sketch_bytes()
    assert codec.dense_bytes() == jcodec.dense_bytes()
    assert codec.compression_ratio() == jcodec.compression_ratio()


def test_sketched_records_refuse_the_other_package(tmp_path):
    """A sketched EF record (and its meta) written by either package is
    refused by the other, through the disk: the operators come from
    different generators, so a decode would give noise of the right
    size. The reference refuses the port's record by its own seed check."""
    ef = _np_ef()
    jcodec = JCodec(JSketchConfig(**SK), jax.eval_shape(lambda: _j(ef)))
    codec = SketchedTreeCodec(SketchConfig(**SK), _meta(_t(ef)),
                              device="cpu")
    jck.save(tmp_path / "j", 5, jcodec.encode(_j(ef), step=5),
             extra={"sketched_ef": jcodec.meta()})
    back, _ = checkpointer.restore(tmp_path / "j", codec.record_shapes())
    with pytest.raises(CheckpointError, match="written by the package "
                                              "'repro'"):
        codec.decode(back)
    jmeta = checkpointer.read_manifest(tmp_path / "j", 5)["extra"][
        "sketched_ef"]
    with pytest.raises(CheckpointError, match="'repro'"):
        SketchedTreeCodec.from_meta(jmeta, _meta(_t(ef)), device="cpu")
    # the port's record through the reference's own checks
    checkpointer.save(tmp_path / "p", 6, codec.encode(_t(ef), step=6),
                      extra={"sketched_ef": codec.meta()})
    jback, _ = jck.restore(tmp_path / "p", jcodec.record_shapes())
    with pytest.raises(jck.CheckpointError, match="base key"):
        jcodec.decode(jback)
    assert jck.read_manifest(tmp_path / "p", 6)["extra"]["sketched_ef"][
        "generator"] == "repro_torch"
    # a record without the tag names its writer; the base key and shape
    # checks still hold under the tag
    with pytest.raises(CheckpointError, match="'repro'"):
        codec.decode({"y": back["y"], "seed": torch.tensor(CKPT_KEY),
                      "step": back["step"]})


def test_dense_ef_checkpoints_cross_both_ways(tmp_path):
    state = {"params": _np_ef(seed=2), "ef": _np_ef(npod=2, seed=3)}
    checkpointer.save(tmp_path / "p", 3, _t(state), extra={"npod": 2})
    got, _ = jck.restore(tmp_path / "p", jax.eval_shape(lambda: _j(state)))
    _assert_tree_equal(_t(jax.tree.map(np.asarray, got)), state)
    jck.save(tmp_path / "j", 4, _j(state), extra={"npod": 2})
    got, _ = checkpointer.restore(tmp_path / "j", _meta(_t(state)))
    _assert_tree_equal(got, state)


def test_resume_elastic_on_a_mesh_equals_no_mesh(tmp_path):
    """resume_elastic(mesh=) on two gloo ranks: each decodes its block of
    every leaf's buckets and the blocks are gathered; the state equals
    what mesh=None gives."""
    from torch_dist_workers import run_ranks
    old, new = 4, 2
    state = {"params": _t(_np_ef(seed=2)), "ef": _t(_np_ef(npod=old, seed=3))}
    codec = SketchedTreeCodec(SketchConfig(**SK), state["ef"])
    to_save = dict(state)
    to_save["ef"] = codec.encode(state["ef"], step=8)
    checkpointer.save(tmp_path / "ck", 8, to_save,
                      extra={"npod": old, "sketched_ef": codec.meta()})
    example = {"params": {k: (tuple(v.shape), "float32")
                          for k, v in state["params"].items()},
               "ef": {k: ((new,) + tuple(v.shape[1:]), "float32")
                      for k, v in state["ef"].items()}}
    out = run_ranks("resume", 2, tmp_path / "ranks",
                    {"dir": str(tmp_path / "ck"), "example": example,
                     "new": new}, shape=(2,), names=("data",))
    for o in out:
        assert o["step"] == 8
        _assert_tree_equal(o["mesh"]["params"], state["params"])
        for key in o["plain"]["ef"]:
            np.testing.assert_allclose(o["mesh"]["ef"][key].numpy(),
                                       o["plain"]["ef"][key].numpy(),
                                       rtol=1e-6, atol=1e-6)
    # the w leaf (4 buckets) splits over the two ranks, b (1) does not
    assert SketchedTreeCodec(SketchConfig(**SK), state["ef"])._sk._nb == [
        1, 4 * old]


def test_codec_typed_errors_and_seed_rule():
    ef = _t(_np_ef())
    codec = SketchedTreeCodec(SketchConfig(**SK), ef)
    assert codec.device.type == "cpu"
    assert codec.key_for(3) == CKPT_KEY * 1_000_003 + 3
    fixed = SketchedTreeCodec(SketchConfig(**{**SK, "fresh_per_step": False}),
                              ef)
    assert fixed.key_for(3) == fixed.key_for(4) == CKPT_KEY
    rec = codec.encode(ef, step=0)
    with pytest.raises(CheckpointError, match="base key"):
        SketchedTreeCodec(SketchConfig(**SK), ef, base_key=0xBAD).decode(rec)
    bad = dict(rec)
    bad["y"] = rec["y"][:, :SK["k"] // 2]
    with pytest.raises(CheckpointError, match="shape"):
        codec.decode(bad)
    # a meta example tree with no device means CUDA, which is absent here
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SketchedTreeCodec(SketchConfig(**SK), _meta(ef))


# ---------------------------------------------------------------------------
# elastic resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("old, new", [(4, 2), (4, 1), (2, 2), (1, 1)])
def test_respec_pod_ef_divisible_is_bit_equal_to_the_reference(old, new):
    ef = _np_ef(npod=old)
    got = respec_pod_ef(_t(ef), old, new)
    want = jrespec(_j(ef), old, new)
    _assert_tree_equal(got, jax.tree.map(np.asarray, want))


@pytest.mark.parametrize("old, new", [(2, 3), (1, 4), (3, 2)])
def test_respec_pod_ef_total_preserving_like_the_reference(old, new):
    ef = _np_ef(npod=old)
    got = respec_pod_ef(_t(ef), old, new)
    want = jrespec(_j(ef), old, new)
    for key in ef:
        assert tuple(got[key].shape) == want[key].shape
        total = ef[key].sum(0) if old > 1 else ef[key]
        np.testing.assert_allclose(got[key].sum(0).numpy(), total,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))


def test_respec_pod_ef_errors_match_the_reference():
    for fn, conv, err in ((respec_pod_ef, _t, CheckpointError),
                          (jrespec, _j, jck.CheckpointError)):
        with pytest.raises(err, match="leading dim"):
            fn(conv(_np_ef(npod=2)), 3, 2)
        with pytest.raises(err, match=">= 1"):
            fn(conv(_np_ef(npod=2)), 0, 2)


def test_resume_elastic_sketched_onto_fewer_pods(tmp_path):
    old, new = 4, 2
    state = {"params": _t(_np_ef(seed=2)), "ef": _t(_np_ef(npod=old, seed=3))}
    codec = SketchedTreeCodec(SketchConfig(**SK), state["ef"])
    to_save = dict(state)
    to_save["ef"] = codec.encode(state["ef"], step=8)
    checkpointer.save(tmp_path, 8, to_save,
                      extra={"npod": old, "sketched_ef": codec.meta()})
    example = {"params": _meta(state["params"]),
               "ef": tree_map(lambda x: torch.empty(
                   (new,) + tuple(x.shape[1:]), device="meta"), state["ef"])}
    got, step = resume_elastic(tmp_path, example, npod_new=new, device="cpu")
    assert step == 8
    _assert_tree_equal(got["params"], state["params"])
    want = respec_pod_ef(codec.decode(to_save["ef"]), old, new)
    _assert_tree_equal(got["ef"], want)
    flip_byte(tmp_path / "step_0000000008" / "arr_0.npy")
    with pytest.raises(CorruptionError):
        resume_elastic(tmp_path, example, npod_new=new, device="cpu")


def test_resume_elastic_dense_ef_and_no_ef(tmp_path):
    state = {"params": _t(_np_ef(seed=2)), "ef": _t(_np_ef(npod=2, seed=3))}
    checkpointer.save(tmp_path / "d", 4, state, extra={"npod": 2})
    example = {"params": state["params"],
               "ef": tree_map(lambda x: x[0], state["ef"])}
    got, step = resume_elastic(tmp_path / "d", example, npod_new=1)
    for key in state["ef"]:
        assert torch.equal(got["ef"][key],
                           state["ef"][key][0] + state["ef"][key][1])
    # the reference resumes the same directory to the same bits
    jgot, _ = __import__("repro.ckpt", fromlist=["x"]).resume_elastic(
        tmp_path / "d", jax.eval_shape(lambda: _j(jax.tree.map(
            lambda x: x.numpy(), example))), npod_new=1)
    _assert_tree_equal(got["ef"], jax.tree.map(np.asarray, jgot["ef"]))
    plain = {"params": _t(_np_ef(seed=5))}
    checkpointer.save(tmp_path / "p", 2, plain)
    _, step = resume_elastic(tmp_path / "p", plain, npod_new=8)
    assert step == 2


# ---------------------------------------------------------------------------
# the fault-tolerant train loop
# ---------------------------------------------------------------------------

def test_crash_restart_resumes_exactly(tmp_path):
    """30 steps of the reduced model with a crash at step 17; the
    supervised restart lands on the uninterrupted run's params."""
    cfg = reduced(get_config("llama3.2-3b"))
    model = build_model(cfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4))
    step_fn = steps.build_train_step(
        model, ShapeSpec("t", 32, 4, "train"), device="cpu",
        lr_fn=functools.partial(schedule.constant, peak_lr=1e-3))

    def train(ckpt_dir, injector=None):
        state = steps.init_train_state(model,
                                       torch.Generator().manual_seed(0))
        return train_loop.run(step_fn, state, data, train_loop.LoopConfig(
            total_steps=30, ckpt_dir=str(ckpt_dir), ckpt_every=5,
            log_every=1000, async_ckpt=False), injector=injector,
            log=lambda *_: None)

    s_ref, _ = train(tmp_path / "ref")
    holder = {}

    def attempt(injector):
        holder["state"], final = train(tmp_path / "crash", injector)
        return final

    report = run_with_restarts(attempt, max_restarts=2,
                               injector=FaultInjector({17}))
    assert report.completed and report.restarts == 1, report
    assert report.final_step == 30
    for a, b in zip(tree_leaves(s_ref["params"]),
                    tree_leaves(holder["state"]["params"])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-6)
    assert int(holder["state"]["opt"]["count"]) == 30


def _toy_step(state, batch):
    g = float(np.sum(batch["tokens"])) * 1e-3
    params = tree_map(lambda p: p - 1e-2 * (p + g), state["params"])
    ef = tree_map(lambda e, p: 0.9 * e + 0.1 * p, state["ef"], params)
    loss = sum(torch.sum(p ** 2) for p in tree_leaves(params))
    return {"params": params, "ef": ef}, {"loss": loss}


def _toy_init():
    return {"params": _t(_np_ef(seed=2)), "ef": _t(_np_ef(seed=3))}


TOY_DATA = SyntheticLM(DataConfig(vocab=31, seq_len=8, global_batch=2))


def test_train_loop_sketched_ef_crash_restart_bit_identical(tmp_path):
    def run_once(d):
        codec = SketchedTreeCodec(SketchConfig(**SK), _toy_init()["ef"])
        holder = {}

        def attempt(injector):
            cfg = train_loop.LoopConfig(total_steps=14, ckpt_dir=str(d),
                                        ckpt_every=4, log_every=1000,
                                        async_ckpt=False)
            holder["state"], final = train_loop.run(
                _toy_step, _toy_init(), TOY_DATA, cfg, injector=injector,
                log=lambda *_: None, ef_codec=codec)
            return final

        rep = run_with_restarts(attempt, max_restarts=2,
                                injector=FaultInjector({9}))
        assert rep.completed and rep.restarts == 1, rep
        return holder["state"]

    s1 = run_once(tmp_path / "a")
    s2 = run_once(tmp_path / "b")
    _assert_tree_equal(s1, s2)
    step = checkpointer.latest_step(tmp_path / "a")
    man = checkpointer.read_manifest(tmp_path / "a", step)
    assert "sketched_ef" in man["extra"] and man["extra"]["npod"] == 1
    shapes = [tuple(a["shape"]) for a in man["arrays"]]
    assert shapes.count((64, 32)) == 1 and shapes.count((128,)) == 1, shapes
    assert shapes.count((5, 128)) == 1, shapes    # the (nb, k) sketch


def test_async_save_in_flight_survives_a_crash(tmp_path, monkeypatch):
    """A slow async save (IOFaultPlan(slow_write_s=...)) is still writing
    when the next step crashes: the loop drains it before the exception
    leaves, so the restart resumes from it (its checkpointer's startup
    sweep would otherwise delete the live tmp directory)."""
    monkeypatch.setattr(checkpointer, "_default_io", lambda: IOFaultInjector(
        IOFaultPlan(slow_write_s=0.15)))
    logs, holder = [], {}

    def attempt(injector):
        cfg = train_loop.LoopConfig(total_steps=4, ckpt_dir=str(tmp_path),
                                    ckpt_every=2, log_every=1000,
                                    async_ckpt=True)
        holder["state"], final = train_loop.run(
            _toy_step, _toy_init(), TOY_DATA, cfg, injector=injector,
            log=logs.append)
        return final

    rep = run_with_restarts(attempt, max_restarts=1,
                            injector=FaultInjector({2}))
    assert rep.completed and rep.restarts == 1, rep
    assert "[resume] restored step 2 from" in "\n".join(logs)
    ref, _ = train_loop.run(_toy_step, _toy_init(), TOY_DATA,
                            train_loop.LoopConfig(total_steps=4),
                            log=lambda *_: None)
    _assert_tree_equal(holder["state"], ref)
    assert checkpointer.available_steps(tmp_path) == [2, 4]


def test_sigterm_inside_a_step_checkpoints_and_stops(tmp_path):
    def step_fn(state, batch):
        if int(state["n"]) == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return {"n": state["n"] + 1}, {"loss": torch.zeros(())}

    logs = []
    state, final = train_loop.run(
        step_fn, {"n": torch.tensor(0)}, TOY_DATA,
        train_loop.LoopConfig(total_steps=10, ckpt_dir=str(tmp_path),
                              ckpt_every=100, async_ckpt=True),
        log=logs.append)
    assert final == 4 and int(state["n"]) == 4
    assert checkpointer.available_steps(tmp_path) == [4]
    assert "[shutdown] SIGTERM honored at step 3" in logs
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


def test_train_cli_checkpoint_flags(tmp_path, capsys):
    """`--ckpt-dir --crash-at` under run_with_restarts (the first attempt
    crashes at step 3, the second resumes from step 2), and the
    reference's ValueError for `--sketch-ef-ckpt` without `--compress`."""
    from repro_torch.launch import train
    argv = ["--device", "cpu", "--arch", "llama3.2-3b", "--reduced",
            "--steps", "4", "--batch", "2", "--seq", "16", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2", "--compress",
            "tt:k=64,dims=4x8x16", "--sketch-ef-ckpt"]
    attempts = []

    def attempt(injector):
        attempts.append(1)
        crash = ["--crash-at", "3"] if len(attempts) == 1 else []
        return train.main(argv + crash)

    rep = run_with_restarts(attempt, max_restarts=1)
    out = capsys.readouterr().out
    assert rep.completed and rep.restarts == 1, rep
    assert "injected fault at step 3" in rep.history[0]
    assert "[ckpt] sketched EF records: " in out and "x)" in out
    assert "[resume] restored step 2 from" in out
    assert "[train] finished at step 4" in out
    man = checkpointer.read_manifest(tmp_path, 4)
    assert man["extra"]["sketched_ef"]["k"] == 64
    with pytest.raises(ValueError, match="--compress"):
        train.main(argv[:-3] + ["--sketch-ef-ckpt"])
