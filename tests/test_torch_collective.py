"""The cross-pod compressed all-reduce of repro_torch against repro's.

`compress_per_pod` (the whole pod axis in one process) is held against
the reference's `compress_per_pod` in-process. `compress_collective`
runs on 2 and 3 gloo ranks (`tests/torch_dist_workers.py`; each rank
passes its own pod's row) and is held against the reference's
`compress_per_pod`, the oracle the reference's own shard_map test uses
(its shard_map paths do not run under this JAX), at that test's rtol =
atol = 2e-5 for wire='fp32'; wire='int8' stays within the reference's
budget of 0.12 relative to fp32 (`tests/test_compress.py`). Every rank
must give the same bits, and an int8 call the same bits twice. The
collective ledger must hold exactly the pod-link bytes `wire_bytes`
reports (the reference's HLO check). Then the 2-pod train step on the
reduced llama3.2-3b (seq 32, global batch 8, three steps a sync mode)
against the reference's mesh-free composition (`value_and_grad` a half
batch, `compress_per_pod`, `adamw.update`) at `test_torch_train.py`'s
fp32 tolerance (loss 1e-5 relative, every leaf 1e-4 of its largest
entry), and without a compressor (one dense all_reduce; the reference's
composition takes the pods' mean gradient) at the bound given there;
and the train CLI on two ranks through `torch.distributed.run`.
The reference's operators for `fold_in(PRNGKey(0x5EED), step)` are
carried across as numpy.
"""
import functools
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import rp as jrp
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.ckpt.sketched import SketchedTreeCodec as JCodec
from repro.core.sketch import SketchConfig as JSketchConfig
from repro.models import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.optim.compress import SketchCompressor as JCompressor
from repro_torch import rp
from repro_torch.core import from_numpy_operator
from repro_torch.core.sketch import SketchConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.optim.compress import SketchCompressor

from torch_dist_workers import run_ranks, start_ranks

REPO = Path(__file__).resolve().parents[1]
CFG = dict(family="tt", k=512, rank=4, dims=(4, 8, 16), bucket_elems=512)
KEY = 0x5EED
STEP = 3
SYNCS = ("sketch-mean", "local-mean")


def _ops(cfg: dict, steps) -> dict:
    """{port seed: the reference's operator arrays} for `steps`."""
    jcfg = JSketchConfig(**cfg)
    out = {}
    for s in steps:
        jop = jrp.make_projector(jcfg.spec(), jax.random.fold_in(
            jax.random.PRNGKey(KEY), s))
        arrays = jop.cores if cfg["family"] == "tt" else jop.factors
        out[KEY * 1_000_003 + s] = (cfg["family"],
                                    [np.asarray(a) for a in arrays])
    return out


@pytest.fixture
def carried(monkeypatch):
    ops = _ops(CFG, [STEP])
    made = {s: from_numpy_operator(f, a, "cpu") for s, (f, a) in ops.items()}
    monkeypatch.setattr(rp, "make_projector",
                        lambda spec, seed=0, *, device=None: made[seed])


def _tree(npod, seed=0):
    r = np.random.default_rng(seed)
    g = {"w": r.standard_normal((npod, 1000)).astype(np.float32),
         "b": r.standard_normal((npod, 33)).astype(np.float32)}
    return g, {k: 0.1 * v for k, v in g.items()}


@functools.lru_cache(maxsize=None)
def _reference(npod, sync):
    g, e = _tree(npod)
    jcomp = JCompressor(JSketchConfig(**CFG), sync=sync)
    out, state, met = jcomp.compress_per_pod(
        {k: jnp.asarray(v) for k, v in g.items()},
        {"residual": {k: jnp.asarray(v) for k, v in e.items()}}, step=STEP)
    return (jax.tree.map(np.asarray, out),
            jax.tree.map(np.asarray, state["residual"]),
            jax.tree.map(float, met), jcomp)


def _close(got, want, tol=2e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("sync", SYNCS)
@pytest.mark.parametrize("npod", [2, 3])
def test_compress_per_pod_matches_reference(npod, sync, carried):
    want, want_resid, jmet, _ = _reference(npod, sync)
    g, e = _tree(npod)
    comp = SketchCompressor(SketchConfig(**CFG), sync=sync)
    with rp.dispatch_stats() as st:
        out, state, met = comp.compress_per_pod(
            {k: torch.from_numpy(v) for k, v in g.items()},
            {"residual": {k: torch.from_numpy(v) for k, v in e.items()}},
            step=STEP)
    for k in g:
        _close(out[k], want[k])
        _close(state["residual"][k], want_resid[k])
    # one projection a leaf for every pod; one reconstruction a leaf, and
    # one more a leaf under sketch-mean
    calls = {}
    for (_, structure, _, _), n in st.breakdown.items():
        calls[structure] = calls.get(structure, 0) + n
    assert calls == {"dense": 2,
                     "sketch": 4 if sync == "sketch-mean" else 2}
    assert set(met) == set(jmet)
    for key in met:
        assert float(met[key]) == pytest.approx(jmet[key], rel=1e-5)


def test_compressor_validation_matches_reference():
    cfg, jcfg = SketchConfig(**CFG), JSketchConfig(**CFG)
    for make in (SketchCompressor, JCompressor):
        c = cfg if make is SketchCompressor else jcfg
        with pytest.raises(ValueError, match="unknown sync mode"):
            make(c, sync="nope")
        with pytest.raises(ValueError, match="unknown wire"):
            make(c, wire="fp16")
    g, e = _tree(2)
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    te = {"residual": {k: torch.from_numpy(v) for k, v in e.items()}}
    with pytest.raises(ValueError, match="compress_collective feature"):
        SketchCompressor(cfg, wire="int8").compress_per_pod(tg, te, step=0)
    with pytest.raises(ValueError, match="needs a mesh"):
        SketchCompressor(cfg).compress_collective(tg, te, step=0)
    flat = types.SimpleNamespace(axis_names=("data",))
    with pytest.raises(ValueError, match="pod axis 'pod' not in"):
        SketchCompressor(cfg).compress_collective(tg, te, step=0, mesh=flat)
    big = types.SimpleNamespace(axis_names=("pod",), group=lambda a:
                                types.SimpleNamespace(size=128, axes=("pod",)))
    with pytest.raises(ValueError, match="at most 127 pods"):
        SketchCompressor(cfg, wire="int8").compress_collective(
            tg, te, step=0, mesh=big)


# ---------------------------------------------------------------------------
# compress_collective on 2 and 3 ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[2, 3], ids=lambda n: f"{n}pods")
def pods(request, tmp_path_factory):
    npod = request.param
    g, e = _tree(npod)
    out = run_ranks("collective", npod,
                    tmp_path_factory.mktemp(f"coll{npod}"),
                    {"ops": _ops(CFG, [STEP]), "cfg": CFG, "grads": g,
                     "resid": e, "step": STEP},
                    shape=(npod,), names=("pod",))
    return npod, out


@pytest.mark.parametrize("sync", SYNCS)
def test_compress_collective_equals_per_pod(pods, sync):
    npod, out = pods
    want, want_resid, _, _ = _reference(npod, sync)
    for p, o in enumerate(out):
        r = o[sync, "fp32"]
        for k in want:
            _close(r["g"][k], want[k])
            _close(r["resid"][k], want_resid[k][p])
            assert torch.equal(r["g"][k], out[0][sync, "fp32"]["g"][k])
            assert torch.equal(r["first_g"][k], r["g"][k])


@pytest.mark.parametrize("sync", SYNCS)
def test_int8_wire_within_budget_and_same_bits(pods, sync):
    npod, out = pods
    for o in out:
        a, b = o[sync, "fp32"], o[sync, "int8"]
        for k in a["g"]:
            for x, y in ((a["g"][k], b["g"][k]),
                         (a["resid"][k], b["resid"][k])):
                rel = float(torch.linalg.norm(x - y) / torch.linalg.norm(x))
                assert rel < 0.12, (k, rel)
            # the same bits in both calls and on every rank
            assert torch.equal(b["g"][k], b["first_g"][k])
            assert torch.equal(b["g"][k], out[0][sync, "int8"]["g"][k])


@pytest.mark.parametrize("wire", ["fp32", "int8"])
@pytest.mark.parametrize("sync", SYNCS)
def test_ledger_bytes_equal_wire_bytes(pods, sync, wire):
    npod, out = pods
    jcomp = JCompressor(JSketchConfig(**CFG), sync=sync, wire=wire)
    g, _ = _tree(npod)
    jwire = jcomp.wire_bytes(jcomp._sketcher({k: jnp.asarray(v[0])
                                              for k, v in g.items()}))
    for o in out:
        r = o[sync, wire]
        assert r["wire_bytes"] == r["metric"] == jwire
        assert all(row["axes"] == ["pod"] and row["tag"] == "compress"
                   and row["op"] == "all_reduce" for row in r["ledger"])
        assert sum(row["bytes"] for row in r["ledger"]) == jwire
        if (sync, wire) == ("sketch-mean", "fp32"):
            # the one cross-pod collective: the (n_buckets, k) sketch
            assert [(row["calls"], row["reduce"], row["dtype"])
                    for row in r["ledger"]] == [(1, "sum", "float32")]
            assert jwire == 3 * 512 * 4


def test_one_tree_per_pod(pods):
    _, out = pods
    for o in out:
        assert "one tree per pod" in o["mismatch_error"]


# ---------------------------------------------------------------------------
# the pod train step and the CLI
# ---------------------------------------------------------------------------

SKETCH = dict(family="tt", k=1024, rank=8, bucket_elems=4 * 8 * 16,
              dims=(4, 8, 16))
LR, SEQ, BATCH, STEPS, NPOD = 3e-3, 32, 8, 3, 2


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def pod_steps(tmp_path_factory):
    jmodel = jbuild_model(jreduced(jget_config("llama3.2-3b")))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jopt_cfg = jadamw.AdamWConfig()
    jopt = jadamw.init_state(jparams, jopt_cfg)
    zeros = jax.tree.map(lambda p: np.zeros(p.shape, np.float32), jparams)
    state = jax.tree.map(np.asarray, {"params": jparams, "opt": jopt,
                                      "ef": {"residual": zeros}})
    finish = start_ranks(
        "train", NPOD, tmp_path_factory.mktemp("train"),
        {"ops": _ops(SKETCH, range(STEPS)), "cfg": SKETCH, "state": state,
         "seq": SEQ, "batch": BATCH, "steps": STEPS, "lr": LR,
         "syncs": SYNCS + ("none",)},
        shape=(NPOD, 1, 1), names=("pod", "data", "model"))
    data = SyntheticLM(DataConfig(vocab=256, seq_len=SEQ, global_batch=BATCH))
    loss_grad = jax.jit(jax.value_and_grad(lambda p, bb: jmodel.loss_fn(
        p, bb, compute_dtype=jnp.float32)))
    update = jax.jit(lambda p, g, o: jadamw.update(
        p, g, o, jnp.float32(LR), jopt_cfg))
    want = {}
    for sync in SYNCS + ("none",):
        jcomp = JCompressor(JSketchConfig(**SKETCH), sync=sync
                            if sync != "none" else "local-mean")
        sync_fn = jax.jit(lambda g, e, step, jcomp=jcomp: jcomp.
                          compress_per_pod(g, {"residual": e}, step=step)[:2])
        if sync == "none":      # the uncompressed baseline: the pods' mean
            sync_fn = jax.jit(lambda g, e, step: (
                jax.tree.map(lambda x: x.mean(0), g), {"residual": e}))
        params, opt = jparams, jopt
        ef = jax.tree.map(lambda p: jnp.zeros((NPOD,) + p.shape), jparams)
        runs = []
        for i in range(STEPS):
            b = data.batch(i)
            half = BATCH // NPOD
            per = [loss_grad(params, {
                k: jnp.asarray(v[q * half:(q + 1) * half])
                for k, v in b.items()}) for q in range(NPOD)]
            grads_pp = jax.tree.map(lambda *g: jnp.stack(g),
                                    *[g for _, g in per])
            g, est = sync_fn(grads_pp, ef, opt["count"])
            ef = est["residual"]
            params, opt, omet = update(params, g, opt)
            runs.append({"loss": float(np.mean([float(x) for x, _ in per])),
                         "grad_norm": float(omet["grad_norm"]),
                         "params": [np.asarray(x)
                                    for x in jax.tree.leaves(params)],
                         "ef": [np.asarray(x) for x in jax.tree.leaves(ef)]})
        want[sync] = runs
    return finish(), want


@pytest.mark.parametrize("sync", SYNCS + ("none",))
def test_pod_train_step_matches_reference_composition(pod_steps, sync):
    out, want = pod_steps
    for i in range(STEPS):
        w = want[sync][i]
        for p, o in enumerate(out):
            got = o[sync][i]
            assert got["loss"] == pytest.approx(w["loss"], rel=1e-5)
            assert got["grad_norm"] == pytest.approx(w["grad_norm"],
                                                     rel=1e-5)
            for a, b in zip(got["params"], w["params"]):
                if sync != "none":
                    assert _rel(a, b) <= 1e-4
                    continue
                # uncompressed, AdamW's step m / (sqrt(v) + eps) moves
                # with the summation order where a gradient entry is near
                # eps (the sketched estimate has no such entries): 0.1 lr
                # there, 1e-4 of the largest entry on 99.9% of the leaf
                # (measured: 0.006 lr, 99.988%)
                d = np.abs(a.numpy() - b)
                assert d.max() <= 0.1 * LR
                assert (d <= 1e-4 * np.abs(b).max()).mean() >= 0.999
            for a, b in zip(got["params"], out[0][sync][i]["params"]):
                assert torch.equal(a, b)     # the same bits on both pods
            if sync != "none":
                for a, b in zip(got["ef"], w["ef"]):
                    assert _rel(a, b[p]) <= 1e-4


def test_pod_train_step_ledger(pod_steps):
    """A sketch-mean step: one scalar all_reduce of the loss, apart from
    the compressor's one all_reduce of the sketch; without a compressor,
    one dense all_reduce of the whole gradient."""
    out, _ = pod_steps
    for o in out:
        rows = o["none"][-1]["ledger"]
        assert [(r["tag"], r["calls"], r["dtype"]) for r in rows] == [
            ("grad", 1, "float32"), ("loss", 1, "float32")]
        assert rows[0]["bytes"] == 78144 * 4
        for sync in SYNCS:
            rows = o[sync][-1]["ledger"]
            assert [(r["tag"], r["calls"]) for r in rows
                    if r["tag"] == "loss"] == [("loss", 1)]
            comp = [r for r in rows if r["tag"] == "compress"]
            if sync == "sketch-mean":
                assert [(r["calls"], r["dtype"]) for r in comp] == [
                    (1, "float32")]
            assert {r["tag"] for r in rows} == {"loss", "compress"}


def test_train_cli_on_two_ranks():
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "llama3.2-3b", "--reduced", "--mesh", "2x1x1",
         "--dist-backend", "gloo", "--device", "cpu", "--steps", "4",
         "--batch", "4", "--seq", "32", "--compress",
         "tt:k=256,dims=4x8x16", "--compress-sync", "sketch-mean"],
        cwd=REPO, env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin",
                       "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("[mesh] {'pod': 2, 'data': 1, 'model': 1} "
                            "backend=gloo device=cpu") == 1
    assert "sync=sketch-mean" in out.stdout
    assert "wire_bytes=" in out.stdout
    assert out.stdout.count("[train] finished at step 4 (params=78144)") == 1


def test_train_cli_refuses_sketched_ef_records_on_a_pod_mesh(tmp_path):
    """Each rank of a pod mesh holds only its own pod's EF row. The
    refusal of `--sketch-ef-ckpt` on a `2x1x1` mesh is gone: the ranks
    gather their rows, and rank 0 writes one sketched record of the
    stacked `(2, ...)` tree (its manifest's `n_buckets` is the stacked
    tree's) with the pod count."""
    from repro_torch.ckpt import checkpointer
    from torch_dist_workers import run_ranks
    argv = ["--arch", "llama3.2-3b", "--reduced", "--mesh", "2x1x1",
            "--dist-backend", "gloo", "--device", "cpu", "--steps", "1",
            "--batch", "2", "--seq", "16", "--compress",
            "tt:k=64,dims=4x8x16", "--sketch-ef-ckpt", "--ckpt-dir",
            str(tmp_path / "ck")]
    out = run_ranks("cli", 2, tmp_path, {"argv": argv}, shape=(2,),
                    names=("pod",))
    assert [o["error"] for o in out] == [None, None]
    extra = checkpointer.read_manifest(tmp_path / "ck", 1)["extra"]
    assert extra["npod"] == 2
    codec = JCodec(JSketchConfig(family="tt", k=64, dims=(4, 8, 16),
                                 bucket_elems=512),
                   jax.eval_shape(lambda: jax.tree.map(
                       lambda x: jnp.zeros((2,) + x.shape), jbuild_model(
                           jreduced(jget_config("llama3.2-3b"))).init(
                           jax.random.PRNGKey(0)))))
    assert extra["sketched_ef"]["n_buckets"] == codec.meta()["n_buckets"]