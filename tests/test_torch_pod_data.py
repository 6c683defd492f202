"""The rest of the data axis on gloo ranks: `fused_update=True` on a
(data, 1) mesh, and (pod, data, 1) meshes, against the reference's
mesh-free composition.

The reference's mesh paths fail under the installed jax (ROADMAP.md,
"Reference caveats"), so, as `tests/test_torch_fsdp.py` does, the ranks
(`tests/torch_dist_workers.py`) are held against the composition the
reference's step runs, jitted without a mesh, with the reference's
operators carried across to the ranks:

* the fused data step (2 ranks; reduced llama3.2-3b and mixtral-8x22b,
  batch 4, G = 2 MoE groups): `value_and_grad(loss_fn)` of the global
  batch, then `adamw.update_sketched` on the whole trees (K4 in
  interpret mode), `AdamWConfig(clip_norm=None)`. Each rank holds its
  blocks of params, m and v and the whole EF residual, the same bits on
  both ranks; a step a rank dispatches one K1 and one K4 (its block
  form) a leaf, no K2, and the ledger has no `unsketch` gather;
* pod x data (4 ranks, (2, 2, 1), reduced llama3.2-3b, batch 4): with a
  `sketch-mean` compressor, each pod's rows through
  `value_and_grad(loss_fn)`, `compress_per_pod` over the two pods'
  gradients and `adamw.update` (clip 1.0), each rank's EF against its
  pod's row; params, m and v are blocks over 'data' only, the same bits
  on the ranks that share a data index, and the ledger's `compress`
  bytes are `wire_bytes`. Without a compressor, FSDP over both axes
  against one step of the global batch.

Three steps each at fp32 compute, lr 1e-2, under
`test_data_mesh_step_matches_reference_composition`'s bounds: the loss
(and the clip's norm) 1e-5 relative; m, v and the EF 1e-4 of each leaf's
largest entry (on the pod x data mesh 1e-4 a step taken: the
summation-order noise compounds over the three steps); the params 0.01
lr where the reference's sqrt(v_hat) stayed above 100 eps, 2 lr a step
everywhere, and 1e-4 of the largest entry on 99.9% of each leaf. The
train CLI runs `--mesh 2x2x1` under `torch.distributed.run`; the pod x
data ranks save a checkpoint and restore it (the checkpoints' crash and
restart: `tests/test_torch_pod_model.py`).
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
from repro.core.sketch import SketchConfig as JSketchConfig
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.steps import moe_groups_for as jmoe_groups_for
from repro.models import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.optim.compress import SketchCompressor as JCompressor
from repro_torch.configs import get_config, reduced
from repro_torch.launch import fsdp, steps
from repro_torch.models import build_model

from torch_dist_workers import start_ranks

REPO = Path(__file__).resolve().parents[1]
SKETCH = dict(family="tt", k=64, rank=2, dims=(4, 8, 16), bucket_elems=512)
KEY = 0x5EED
SEQ, STEPS, LR, BATCH = 16, 3, 1e-2, 4
FUSED = {"llama": "llama3.2-3b", "mixtral": "mixtral-8x22b"}
POD_MESH = ((2, 2, 1), ("pod", "data", "model"))


def _stand_in(shape, names):
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


def _ops() -> dict:
    """{port seed: the reference's operator arrays} for the steps."""
    jcfg = JSketchConfig(**SKETCH)
    out = {}
    for s in range(STEPS):
        jop = jrp.make_projector(jcfg.spec(), jax.random.fold_in(
            jax.random.PRNGKey(KEY), s))
        out[KEY * 1_000_003 + s] = ("tt", [np.asarray(c) for c in jop.cores])
    return out


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """The reference's model, initial params and optimizer state, the
    same state as numpy for the ranks, and the batches (once an arch)."""
    jmodel = jbuild_model(jreduced(jget_config(arch)))
    params = jmodel.init(jax.random.PRNGKey(0))
    opt = jadamw.init_state(params, jadamw.AdamWConfig())
    zeros = jax.tree.map(lambda p: np.zeros(p.shape, np.float32), params)
    state = jax.tree.map(np.asarray, {"params": params, "opt": opt,
                                      "ef": {"residual": zeros}})
    data = JSyntheticLM(JDataConfig(vocab=256, seq_len=SEQ,
                                    global_batch=BATCH))
    batches = [{k: np.asarray(v) for k, v in data.batch(i).items()}
               for i in range(STEPS)]
    return jmodel, params, opt, state, batches


def _record(runs, loss, params, opt, ef=None, grad_norm=None):
    runs.append({"loss": float(loss), "grad_norm": grad_norm,
                 **{k: [np.asarray(x) for x in jax.tree.leaves(t)]
                    for k, t in (("params", params), ("m", opt["m"]),
                                 ("v", opt["v"]))},
                 "ef": None if ef is None else np.asarray(ef)})


def _fused_reference(arch, G):
    cfg = jadamw.AdamWConfig(clip_norm=None)
    jmodel, params, opt, state, batches = _setup(arch)
    loss_grad = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss_fn(
        p, b, compute_dtype=jnp.float32, moe_groups=G)))
    jcomp = JCompressor(JSketchConfig(**SKETCH))
    update = jax.jit(lambda p, g, e, o: jadamw.update_sketched(
        p, g, e, o, jnp.float32(LR), cfg, compressor=jcomp)[:3])
    ef = jcomp.init_state(params)
    runs = []
    for b in batches:
        loss, g = loss_grad(params, {k: jnp.asarray(v) for k, v in b.items()})
        params, opt, ef = update(params, g, ef, opt)
        _record(runs, loss, params, opt)
        runs[-1]["ef"] = [np.asarray(x) for x in
                          jax.tree.leaves(ef["residual"])]
    return runs


def _pod_reference(state_params, opt, jmodel, batches):
    """Compressed (compress_per_pod over the pods' rows) and uncompressed
    (the global batch) steps from the same state."""
    cfg = jadamw.AdamWConfig()
    loss_grad = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss_fn(
        p, b, compute_dtype=jnp.float32)))
    update = jax.jit(lambda p, g, o: jadamw.update(p, g, o,
                                                   jnp.float32(LR), cfg))
    jcomp = JCompressor(JSketchConfig(**SKETCH), sync="sketch-mean")
    per_pod = jax.jit(lambda g, e, step: jcomp.compress_per_pod(
        g, {"residual": e}, step=step)[:2])
    out = {}
    for mode in ("compressed", "uncompressed"):
        params, o = state_params, opt
        ef = jax.tree.map(lambda p: jnp.zeros((2,) + p.shape, jnp.float32),
                          params)
        runs = []
        for b in batches:
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            if mode == "compressed":
                pods = [loss_grad(params, {k: v[p * 2:(p + 1) * 2]
                                           for k, v in jb.items()})
                        for p in range(2)]
                loss = (pods[0][0] + pods[1][0]) / 2
                g_pp = jax.tree.map(lambda a, c: jnp.stack([a, c]),
                                    pods[0][1], pods[1][1])
                g, est = per_pod(g_pp, ef, o["count"])
                ef = est["residual"]
            else:
                loss, g = loss_grad(params, jb)
            params, o, met = update(params, g, o)
            _record(runs, loss, params, o,
                    grad_norm=float(met["grad_norm"]))
            runs[-1]["ef"] = [np.asarray(x) for x in jax.tree.leaves(ef)]
        out[mode] = runs
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks of every case, started together, and the reference's
    steps computed meanwhile."""
    ops = _ops()
    started, refs = {}, {}
    for name, arch in FUSED.items():
        _, _, _, state, batches = _setup(arch)
        started[name] = start_ranks(
            "fsdp_fused", 2, tmp_path_factory.mktemp(f"fused_{name}"),
            {"arch": arch, "state": state, "batches": batches, "seq": SEQ,
             "batch": BATCH, "lr": LR, "ops": ops, "cfg": SKETCH,
             "clip": None}, shape=(2, 1), names=("data", "model"))
    jmodel, params, opt, state, batches = _setup("llama3.2-3b")
    started["pod"] = start_ranks(
        "pod_data", 4, tmp_path_factory.mktemp("pod_data"),
        {"arch": "llama3.2-3b", "state": state, "batches": batches,
         "seq": SEQ, "batch": BATCH, "lr": LR, "ops": ops, "cfg": SKETCH,
         "modes": ["compressed", "uncompressed"],
         "ckpt_dir": str(tmp_path_factory.mktemp("pod_data_ckpt"))},
        shape=POD_MESH[0],
        names=POD_MESH[1])
    for name, arch in FUSED.items():
        G = jmoe_groups_for(jget_config(arch),
                            _stand_in((2, 1), ("data", "model")), BATCH)
        refs[name] = _fused_reference(arch, G)
    refs["pod"] = _pod_reference(params, opt, jmodel, batches)
    return {name: (fin(), refs[name]) for name, fin in started.items()}


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _hold(got, want, i, firm, moments=1e-4):
    """One step of a rank against the reference's, the fsdp tests'
    bounds (m and v to `moments` of their largest entry); returns the
    firm masks (sqrt(v_hat) above 100 eps so far)."""
    c2 = 1.0 - 0.95 ** (i + 1)
    firm = [f & (np.sqrt(v / c2) > 100 * 1e-8)
            for f, v in zip(firm, want["v"])]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    if want["grad_norm"] is not None:
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-5)
    for a, b, f in zip(got["params"], want["params"], firm):
        d = np.abs(a.numpy() - b)
        assert d[f].max(initial=0.0) <= 1e-2 * LR
        assert d.max() <= 2 * (i + 1) * LR
        assert (d <= 1e-4 * np.abs(b).max()).mean() >= 0.999
    for part in ("m", "v"):
        for a, b in zip(got[part], want[part]):
            assert _rel(a, b) <= moments, part
    return firm


def _blocks(arch, mesh, compressed):
    """The shapes of a rank's blocks of params (and m, v) on `mesh`."""
    model = build_model(reduced(get_config(arch)))
    specs = fsdp._flat_specs(steps.state_specs(
        model, mesh, compressed=compressed)["params"])
    whole = [tuple(t.shape) for t in
             fsdp._flat_specs(model.param_shapes()).values()]
    out = []
    for shape, spec in zip(whole, specs.values()):
        d = fsdp.shard_dim(spec, mesh)
        if d is not None:
            n = fsdp._size(mesh, fsdp._axes(spec[d]))
            shape = shape[:d] + (shape[d] // n,) + shape[d + 1:]
        out.append(shape)
    return out, whole


@pytest.mark.parametrize("case", list(FUSED))
def test_fused_data_step_matches_reference_update_sketched(runs, case):
    out, want = runs[case]
    firm = [True] * len(want[0]["v"])
    for i in range(STEPS):
        firm = _hold(out[0]["runs"][i], want[i], i, firm)
        for a, b in zip(out[0]["runs"][i]["ef"], want[i]["ef"]):
            assert _rel(a, b) <= 1e-4, "ef"
        for o in out[1:]:
            for part in ("params", "m", "v", "ef"):
                for a, b in zip(o["runs"][i][part],
                                out[0]["runs"][i][part]):
                    assert torch.equal(a, b)   # the residual's bits too


@pytest.mark.parametrize("case", list(FUSED))
def test_fused_data_step_holds_blocks_and_launches_k1_k4_a_leaf(runs, case):
    out, _ = runs[case]
    blocks, whole = _blocks(FUSED[case], _stand_in((2, 1), ("data",
                                                            "model")), True)
    n = len(whole)
    if case == "llama":
        assert n == 11
    for o in out:
        assert o["held"]["params"] == blocks
        assert o["held"]["m"] == blocks and o["held"]["v"] == blocks
        assert o["held"]["ef"] == whole
        for r in o["runs"]:
            assert r["dispatches"] == {"dense": n, "fused-update": n}
            assert r["calls"] == {"fused_update_block": n,
                                  "fused_update_buckets": 0}
            tags = {row["tag"] for row in r["ledger"]}
            assert "sketch" in tags and "unsketch" not in tags


def test_pod_data_compressed_matches_compress_per_pod(runs):
    """m, v and the EF rows to 1e-4 of their largest entry a step taken:
    the sketched estimate's fp32 noise compounds through the EF and the
    moments (measured: at most 1.4e-4 at step 3, as far from the
    reference as the port's own pod branch on a (2, 1, 1) mesh)."""
    out, want = runs["pod"]
    want = want["compressed"]
    firm = [True] * len(want[0]["v"])
    for i in range(STEPS):
        for o in out:
            _hold(o["compressed"]["runs"][i], want[i], i, firm,
                  moments=1e-4 * (i + 1))
            pod = o["coordinate"]["pod"]
            for a, b in zip(o["compressed"]["runs"][i]["ef"], want[i]["ef"]):
                assert _rel(a, b[pod]) <= 1e-4 * (i + 1), "ef"
        firm = [f & (np.sqrt(v / (1.0 - 0.95 ** (i + 1))) > 100 * 1e-8)
                for f, v in zip(firm, want[i]["v"])]


def test_pod_data_uncompressed_matches_the_global_batch(runs):
    """m and v to 1e-4 of their largest entry a step taken: the params
    the step moves by up to 2 lr where sqrt(v) is near eps (the other
    summation order of a 4-way reduce-scatter) change the next gradient
    (measured: at most 1.14e-4 at step 3)."""
    out, want = runs["pod"]
    want = want["uncompressed"]
    firm = [True] * len(want[0]["v"])
    for i in range(STEPS):
        for o in out:
            _hold(o["uncompressed"]["runs"][i], want[i], i, firm,
                  moments=1e-4 * (i + 1))
        firm = [f & (np.sqrt(v / (1.0 - 0.95 ** (i + 1))) > 100 * 1e-8)
                for f, v in zip(firm, want[i]["v"])]


@pytest.mark.parametrize("mode", ["compressed", "uncompressed"])
def test_pod_data_ranks_hold_their_blocks(runs, mode):
    """Compressed: blocks over 'data', the same bits on the two pods'
    ranks of a data index, the EF whole; uncompressed: blocks over
    ('pod', 'data')."""
    out, _ = runs["pod"]
    mesh = _stand_in(*POD_MESH)
    blocks, whole = _blocks("llama3.2-3b", mesh, mode == "compressed")
    by = {(o["coordinate"]["pod"], o["coordinate"]["data"]): o for o in out}
    assert sorted(by) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for o in out:
        held = o[mode]["held"]
        assert held["params"] == blocks and held["m"] == blocks
        assert held["ef"] == (whole if mode == "compressed" else [])
    if mode == "compressed":
        assert blocks[0] == (128, 64)           # embed over data = 2
        for d in range(2):
            for i in range(STEPS):
                for a, b in zip(by[0, d][mode]["runs"][i]["blocks"],
                                by[1, d][mode]["runs"][i]["blocks"]):
                    assert torch.equal(a, b)
        for i in range(STEPS):   # the pods' residuals differ
            assert not torch.equal(by[0, 0][mode]["runs"][i]["ef"][0],
                                   by[1, 0][mode]["runs"][i]["ef"][0])
    else:
        assert blocks[0] == (64, 64)            # embed over pod x data = 4


def test_pod_data_ledger(runs):
    """Compressed: the `compress` all_reduce over 'pod' moves
    `wire_bytes`; the gradients' reduce runs over 'data' within the pod;
    the loss over every rank. Uncompressed: the gathers and
    reduce-scatters over ('pod', 'data')."""
    out, _ = runs["pod"]
    for o in out:
        for r in o["compressed"]["runs"]:
            rows = {row["tag"]: row for row in r["ledger"]}
            assert rows["compress"]["bytes"] == float(r["wire_bytes"]) > 0
            assert rows["compress"]["axes"] == ["pod"]
            assert rows["grad_reduce"]["op"] == "all_reduce"
            assert rows["grad_reduce"]["axes"] == ["data"]
            assert rows["param_gather"]["axes"] == ["data"]
            assert rows["loss"]["axes"] == ["pod", "data"]
        for r in o["uncompressed"]["runs"]:
            rows = {row["tag"]: row for row in r["ledger"]}
            assert "compress" not in rows
            assert rows["grad_reduce"]["op"] == "reduce_scatter"
            assert rows["grad_reduce"]["axes"] == ["pod", "data"]


def test_a_leaf_split_over_part_of_the_gradients_axes(runs):
    """A leaf that `spec_for` could split over 'pod' only, beside one over
    ('pod', 'data') and a replicated one: each rank's gradient block is
    its block of the four ranks' mean (reduce='scatter': a reduce-scatter
    over the pod ranks, then an all_reduce over the data ranks that hold
    the same block; reduce='all': the whole mean), and the norm counts
    such a block once."""
    from torch_dist_workers import _partial_tree
    out, _ = runs["pod"]
    whole, xs, specs = _partial_tree()
    mean = {k: sum(x[k] for x in xs) / 4 for k in whole}
    norm = float(torch.sqrt(sum(torch.sum(t * t) for t in whole.values())))
    for o in out:
        p, d = o["coordinate"]["pod"], o["coordinate"]["data"]
        got = o["partial"]
        want = {"a": mean["a"].chunk(4)[2 * p + d], "b": mean["b"].chunk(2)[p],
                "c": mean["c"]}
        for k in whole:
            torch.testing.assert_close(got["scatter"][k], want[k])
            torch.testing.assert_close(got["all"][k], mean[k])
        assert got["norm"] == pytest.approx(norm, rel=1e-6)


def test_pod_data_checkpoints_are_refused(runs):
    """The call that was refused before pod x data checkpoints were
    ported, `train_loop.run(mesh=, shardings=)` with a `ckpt_dir` on the
    (2, 2, 1) mesh, now saves a step and, called again, restores it:
    every rank's blocks, moments and EF row bit for bit."""
    out, _ = runs["pod"]
    for o in out:
        saved, restored = o["ckpt"]
        assert len(saved) == len(restored) > 0
        for a, b in zip(saved, restored):
            assert torch.equal(a, b)


def test_train_cli_on_a_pod_data_mesh(tmp_path):
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
            "--arch", "llama3.2-3b", "--reduced", "--mesh", "2x2x1",
            "--dist-backend", "gloo", "--device", "cpu", "--steps", "3",
            "--batch", "4", "--seq", "16", "--compress",
            "tt:k=64,dims=4x8x16", "--compress-sync", "sketch-mean"]
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin",
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("[mesh] {'pod': 2, 'data': 2, 'model': 1} "
                            "backend=gloo device=cpu") == 1
    assert out.stdout.count("[train] finished at step 3 (params=78144)") == 1
