"""The reference's production mesh shape, (pod, data, model), on gloo
ranks: the train, prefill and serve steps with a model axis beside the
pod axis, and checkpoints of pod x data meshes and of meshes with a model
axis, against the reference.

The reference's mesh paths fail under the installed jax (ROADMAP.md,
"Reference caveats"), so, as `tests/test_torch_pod_data.py` does, the
ranks (`tests/torch_dist_workers.py`) are held against the composition
the reference's step runs, jitted without a mesh, with the reference's
operators carried across:

* on (2, 1, 2), four ranks, batch 4, seq 16, fp32 compute, lr 1e-2,
  clip 1.0, three steps: reduced llama3.2-3b uncompressed (FSDP over
  'pod', TP/SP over 'model') against the global batch's
  `value_and_grad(loss_fn)` and `adamw.update`; llama3.2-3b and
  mixtral-8x22b (expert parallelism beside the pod collective, the
  reference's `groups // npod` dispatch groups) with a `sketch-mean`
  compressor against each pod's rows through `value_and_grad(loss_fn)`,
  `compress_per_pod` and `adamw.update` (mixtral at a capacity factor of
  1.25, where the dispatch groups drop tokens); mamba2-1.3b
  uncompressed. Step
  1's loss is the reference's `loss_fn` on the same params carried across
  through numpy. Bounds as `test_torch_pod_data.py`'s pod x data ones
  (`_hold`): the loss and the clip's norm 1e-5 relative, m, v and the EF
  rows 1e-4 of each leaf's largest entry a step taken, the params 0.01 lr
  where the reference's sqrt(v_hat) stayed above 100 eps, 2 lr a step
  everywhere;
* the prefill step and 8 serve steps of reduced llama3.2-3b on (2, 1, 2)
  against the reference's `prefill` / `decode_step` (`check_serving`:
  logits 1e-4, tokens equal where clear);
* checkpoints with a dense EF, a crash and a restart, the final state
  bit-equal to the uninterrupted run, on (2, 2, 1) (compressed), (1, 2)
  (`fused_update=True`) and (2, 1, 2) (compressed). The (2, 1, 2) files
  are read by `repro.ckpt.checkpointer.restore` with the reference's
  example tree (the EF `(npod, ...)`); a sketched record of that run is
  the reference codec's encode of the stacked rows and decodes like it
  (within 1e-5 of the largest entry, `tests/test_torch_ckpt.py`'s
  tolerance); the checkpoint restores onto a (1, 2, 2) mesh of the same
  ranks through `respec_pod_ef` (the rows' fixed-order sum, bit for bit);
* the train CLI on eight ranks, `--mesh 2x2x2` (the reference's CLI
  mesh) with `--compress ... --compress-sync sketch-mean --ckpt-dir
  --sketch-ef-ckpt --crash-at 2`: it crashes, resumes and finishes.
"""
import dataclasses
import multiprocessing
import types
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import rp as jrp
from repro.ckpt import checkpointer as jck
from repro.ckpt.sketched import SketchedTreeCodec as JCodec
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.sketch import SketchConfig as JSketchConfig
from repro.launch.steps import moe_groups_for as jmoe_groups_for
from repro.models import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.optim.compress import SketchCompressor as JCompressor
from repro_torch.ckpt import CKPT_KEY, SketchedTreeCodec, checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.launch import fsdp, steps
from repro_torch.models import build_model

from test_torch_pod_data import (BATCH, LR, SEQ, SKETCH, STEPS, _hold,
                                 _ops, _record, _rel, _setup)
from test_torch_tp import _serve_reference, check_serving
from torch_dist_workers import start_ranks

MESH = ((2, 1, 2), ("pod", "data", "model"))
TRAIN = {"llama": ("llama3.2-3b", ("uncompressed", "compressed")),
         "mixtral": ("mixtral-8x22b", ("compressed",)),
         "mamba2": ("mamba2-1.3b", ("uncompressed",))}
# mixtral's capacity factor: the reduced config's 4.0 drops no token, so
# the dispatch groups would not change the loss; at 1.25 a pod's rows
# lose 5.740 in 1 group, 5.798 in 2 (the reference's loss_fn)
CAPACITY = {"mixtral": 1.25}
# name: (mesh shape, names, fused)
CKPT = {"pod_data": ((2, 2, 1), ("pod", "data", "model"), False),
        "fused_model": ((1, 2), ("data", "model"), True),
        "pod_model": (MESH[0], MESH[1], False)}
CKPT_STEPS, CRASH_AT = 3, 2
TOL = 1e-5          # the sketched record against the reference's codec
TIMEOUT = 240.0     # seconds a case's ranks may take


def _stand_in(shape, names):
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


def _reference(arch, modes, capacity=None):
    """The reference's compositions of an arch on (2, 1, 2): the global
    batch's steps (G MoE groups, as `moe_groups_for` gives them on the
    mesh) and each pod's rows through `compress_per_pod` (G // npod
    groups, the reference's pod branch); an MoE capacity factor of
    `capacity` where given."""
    jmodel, params0, opt0, _, batches = _setup(arch)
    if capacity:
        cfg = jreduced(jget_config(arch))
        jmodel = jbuild_model(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity)))
    G = jmoe_groups_for(jget_config(arch), _stand_in(*MESH), BATCH)
    cfg = jadamw.AdamWConfig()

    def loss_grad(groups):
        return jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss_fn(
            p, b, compute_dtype=jnp.float32, moe_groups=groups)))
    update = jax.jit(lambda p, g, o: jadamw.update(p, g, o,
                                                   jnp.float32(LR), cfg))
    jcomp = JCompressor(JSketchConfig(**SKETCH), sync="sketch-mean")
    per_pod = jax.jit(lambda g, e, step: jcomp.compress_per_pod(
        g, {"residual": e}, step=step)[:2])
    out = {}
    for mode in modes:
        params, opt = params0, opt0
        ef = jax.tree.map(lambda p: jnp.zeros((2,) + p.shape, jnp.float32),
                          params)
        lg = loss_grad(G if mode == "uncompressed" else max(1, G // 2))
        runs = []
        for b in batches:
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            if mode == "compressed":
                half = BATCH // 2
                pods = [lg(params, {k: v[p * half:(p + 1) * half]
                                    for k, v in jb.items()})
                        for p in range(2)]
                loss = (pods[0][0] + pods[1][0]) / 2
                g_pp = jax.tree.map(lambda a, c: jnp.stack([a, c]),
                                    pods[0][1], pods[1][1])
                g, est = per_pod(g_pp, ef, opt["count"])
                ef = est["residual"]
            else:
                loss, g = lg(params, jb)
            params, opt, met = update(params, g, opt)
            _record(runs, loss, params, opt,
                    grad_norm=float(met["grad_norm"]))
            runs[-1]["ef"] = [np.asarray(x) for x in jax.tree.leaves(ef)]
        out[mode] = runs
    return out


def _ckpt_ops():
    """The reference's operators for the checkpoint codec's seeds."""
    jcfg = JSketchConfig(**SKETCH)
    out = {}
    for s in range(CKPT_STEPS + 1):
        jop = jrp.make_projector(jcfg.spec(), jax.random.fold_in(
            jax.random.PRNGKey(CKPT_KEY), s))
        out[CKPT_KEY * 1_000_003 + s] = ("tt", [np.asarray(c)
                                                for c in jop.cores])
    return out


def _ckpt_payload(tmp, name, ops):
    _, _, fused = CKPT[name]
    _, _, _, state, _ = _setup("llama3.2-3b")
    pl = {"arch": "llama3.2-3b", "state": state, "seq": SEQ,
          "batch": BATCH, "lr": LR, "ops": ops, "cfg": SKETCH,
          "steps": CKPT_STEPS, "crash_at": CRASH_AT, "async": True,
          "fused": fused, "dir": str(tmp / "ckpt"),
          "plain_dir": str(tmp / "plain")}
    if name == "pod_model":
        pl.update(sketched_dir=str(tmp / "sketched"), respec=True)
    return pl


def _cli_argv(tmp):
    return ["--arch", "llama3.2-3b", "--reduced", "--mesh", "2x2x2",
            "--device", "cpu", "--steps", "3", "--batch", "4", "--seq",
            "16", "--compress", "tt:k=64,dims=4x8x16", "--compress-sync",
            "sketch-mean", "--ckpt-dir", str(tmp / "ck"), "--ckpt-every",
            "1", "--sketch-ef-ckpt"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's ranks, started together (the (2, 1, 2) ones once the
    reference's llama serving is made), and the reference's train steps
    computed meanwhile in a pool of processes."""
    ops = _ops()
    ops.update(_ckpt_ops())
    started = {}
    for name, (shape, names, _) in CKPT.items():
        if name == "pod_model":     # on the (2, 1, 2) ranks below
            continue
        tmp = tmp_path_factory.mktemp(name)
        pl = _ckpt_payload(tmp, name, ops)
        started[name] = (pl, start_ranks(
            "mesh_ckpt", int(np.prod(shape)), tmp, pl, shape=shape,
            names=names, timeout=TIMEOUT))
    cli = tmp_path_factory.mktemp("cli")
    started["cli"] = (None, start_ranks(
        "cli_resume", 8, cli, {"argv": _cli_argv(cli), "crash_at": 2},
        shape=(8,), names=("data",), timeout=TIMEOUT))
    serve = _serve_reference("llama3.2-3b")
    train = []
    for name, (arch, modes) in TRAIN.items():
        _, _, _, state, batches = _setup(arch)
        train.append({"name": name, "arch": arch, "modes": list(modes),
                      "capacity": CAPACITY.get(name), "state": state,
                      "batches": batches})
    tmp = tmp_path_factory.mktemp("pod_model")
    ckpt = _ckpt_payload(tmp, "pod_model", ops)
    started["pod_model"] = (ckpt, start_ranks(
        "pod_model", 4, tmp,
        {"seq": SEQ, "batch": BATCH, "lr": LR, "ops": ops, "cfg": SKETCH,
         "train": train, "ckpt": {k: v for k, v in ckpt.items()
                                  if k not in ("ops", "cfg")},
         "serve": [{"name": "llama", "arch": "llama3.2-3b",
                    **{k: serve[k] for k in ("params", "tokens", "cache",
                                             "feed")}}]},
        shape=MESH[0], names=MESH[1], timeout=TIMEOUT))
    jobs = [(arch, modes, CAPACITY.get(name))
            for name, (arch, modes) in TRAIN.items()]
    with ProcessPoolExecutor(len(jobs), mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        refs = dict(zip(TRAIN, pool.map(_reference, *zip(*jobs))))
    got = {name: (pl, fin()) for name, (pl, fin) in started.items()}
    return got, refs, serve


CASES = [(n, m) for n, (_, modes) in TRAIN.items() for m in modes]


@pytest.mark.parametrize("case,mode", CASES)
def test_pod_model_step_matches_reference_composition(runs, case, mode):
    """Every rank's steps against the reference's composition; the ranks
    of one pod hold the same whole state, the EF rows their pod's."""
    got, refs, _ = runs
    want = refs[case][mode]
    ranks = got["pod_model"][1]
    firm = [True] * len(want[0]["v"])
    for i in range(STEPS):
        for o in ranks:
            r = o["train"][case][mode]["runs"][i]
            _hold(r, want[i], i, firm, moments=1e-4 * (i + 1))
            if mode == "compressed":
                pod = o["coordinate"]["pod"]
                for a, b in zip(r["ef"], want[i]["ef"]):
                    assert _rel(a, b[pod]) <= 1e-4 * (i + 1), "ef"
        firm = [f & (np.sqrt(v / (1.0 - 0.95 ** (i + 1))) > 100 * 1e-8)
                for f, v in zip(firm, want[i]["v"])]
        first = ranks[0]["train"][case][mode]["runs"][i]
        for o in ranks[1:]:
            r = o["train"][case][mode]["runs"][i]
            for part in ("params", "m", "v"):
                for a, b in zip(r[part], first[part]):
                    assert torch.equal(a, b), part


def _blocks(arch, compressed):
    """A rank's shapes of its blocks of the params on (2, 1, 2)."""
    model = build_model(reduced(get_config(arch)))
    mesh = _stand_in(*MESH)
    specs = fsdp._flat_specs(steps.state_specs(
        model, mesh, compressed=compressed)["params"])
    out = []
    for spec, leaf in zip(specs.values(), fsdp._flat_specs(
            model.param_shapes()).values()):
        s = list(leaf.shape)
        for d in fsdp.shard_dims(spec, mesh):
            s[d] //= fsdp._size(mesh, fsdp._axes(spec[d]))
        out.append(tuple(s))
    return out, [tuple(t.shape) for t in
                 fsdp._flat_specs(model.param_shapes()).values()]


@pytest.mark.parametrize("case", list(TRAIN))
def test_pod_model_ranks_hold_their_blocks(runs, case):
    """Uncompressed: blocks over 'pod' (FSDP) and 'model'; compressed:
    blocks over 'model' alone (data is 1: the params replicate across the
    pods, the reference's `fsdp_axes=("data",)`), the EF row whole and the
    pods' rows apart."""
    got, _, _ = runs
    arch, modes = TRAIN[case]
    for mode in modes:
        blocks, whole = _blocks(arch, mode == "compressed")
        split = [sum(x < y for x, y in zip(b, w))
                 for b, w in zip(blocks, whole)]
        # a leaf split over both 'pod' and 'model' only without the
        # compressor, whose params replicate across the pods
        assert max(split) == (1 if mode == "compressed" else 2), mode
        for o in got["pod_model"][1]:
            held = o["train"][case][mode]["held"]
            assert held == blocks, mode
            for r in o["train"][case][mode]["runs"]:
                assert [tuple(t.shape) for t in r["ef"]] == (
                    whole if mode == "compressed" else [])
    if "compressed" in modes:
        by = {(o["coordinate"]["pod"], o["coordinate"]["model"]): o
              for o in got["pod_model"][1]}
        for m in range(2):
            a = by[0, m]["train"][case]["compressed"]["runs"][-1]["ef"]
            b = by[1, m]["train"][case]["compressed"]["runs"][-1]["ef"]
            assert not torch.equal(a[0], b[0])
            c = by[0, 1 - m]["train"][case]["compressed"]["runs"][-1]["ef"]
            for x, y in zip(a, c):      # a pod's ranks: the same bits
                assert torch.equal(x, y)


def test_pod_model_ledger(runs):
    """Compressed: the `compress` all_reduce over 'pod' moves
    `wire_bytes`, the model-split gradients are gathered over 'model'
    (`grad_model_gather`), the loss is taken over every rank.
    Uncompressed: the params are gathered and the gradients
    reduce-scattered over 'pod' (the data axes) beside the model axis's
    collectives."""
    got, _, _ = runs
    for o in got["pod_model"][1]:
        for case in ("llama", "mixtral"):
            for r in o["train"][case]["compressed"]["runs"]:
                rows = {row["tag"]: row for row in r["ledger"]}
                assert rows["compress"]["bytes"] == float(r["wire_bytes"]) > 0
                assert rows["compress"]["axes"] == ["pod"]
                assert rows["grad_model_gather"]["axes"] == ["model"]
                assert rows["loss"]["axes"] == ["pod", "data", "model"]
                assert "param_gather" not in rows
        for case in ("llama", "mamba2"):
            rows = {row["tag"]: row for row in o["train"][case][
                "uncompressed"]["runs"][-1]["ledger"]}
            assert "compress" not in rows
            assert rows["grad_reduce"]["op"] == "reduce_scatter"
            assert rows["grad_reduce"]["axes"] == ["pod", "data"]
            assert rows["param_gather"]["axes"] == ["pod", "data"]
            assert "tp_reduce" in rows or "tp_cols" in rows


def test_pod_model_serving_matches_the_reference(runs):
    """The prefill and serve steps on (2, 1, 2): each pod its half of the
    rows (the cache's batch dim over ('pod', 'data'), its KV heads over
    'model'), every rank all the rows' logits and tokens."""
    got, _, serve = runs
    check_serving([o["serve"]["llama"] for o in got["pod_model"][1]], serve,
                  "heads")
    for o in got["pod_model"][1]:
        k = o["serve"]["llama"]["cache"]["k"]
        assert k[1] == serve["cache"]["k"].shape[1] // 2
        assert k[2] == serve["cache"]["k"].shape[2] // 2


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _ckpt(got, name):
    pl, ranks = got[name]
    return pl, [o["ckpt"] for o in ranks] if name == "pod_model" else ranks


@pytest.mark.parametrize("name", list(CKPT))
def test_checkpoint_crash_restart_is_bit_equal(runs, name):
    """The restarted run's blocks and EF rows equal the uninterrupted
    run's bit for bit, and the last checkpoint restores (each rank its
    blocks, `restore(shardings=)`) to them; on a pod mesh its EF is the
    pods' rows stacked."""
    pl, out = _ckpt(runs[0], name)
    shape, names, _ = CKPT[name]
    npod = dict(zip(names, shape)).get("pod", 1)
    for o in out:
        assert (o["restarts"], o["final_step"]) == (1, CKPT_STEPS)
        _equal(o["resumed"], o["plain"])
        if npod == 1:
            _equal(o["restored"], o["plain"])
            continue
        # the leaves in sorted-key order: the EF's n (the rows stacked by
        # pod), the count, then m, v and params (n each)
        n = len(o["restored"]) // 4
        by_pod = {p["coordinate"]["pod"]: p for p in out}
        for i in range(n):
            want = torch.stack([by_pod[p]["plain"][i] for p in range(npod)])
            assert torch.equal(o["restored"][i], want)
        _equal(o["restored"][n:], o["plain"][n:])


def _jexample():
    """The reference's example tree of a (2, 1, 2) checkpoint: params,
    opt, and the EF with a leading pod dim."""
    jmodel, params, _, _, _ = _setup("llama3.2-3b")
    shapes = jax.eval_shape(lambda: params)
    return {"params": shapes,
            "opt": {"m": shapes, "v": shapes,
                    "count": jax.ShapeDtypeStruct((), jnp.int32)},
            "ef": {"residual": jax.tree.map(lambda s: jax.ShapeDtypeStruct(
                (2,) + s.shape, s.dtype), shapes)}}


def test_the_reference_reads_a_pod_model_checkpoint(runs):
    """`repro.ckpt.checkpointer.restore` reads the (2, 1, 2) run's files
    with the reference's example tree: whole params and moments equal to
    the run's, the EF rows stacked by pod; the manifest records npod."""
    pl, out = _ckpt(runs[0], "pod_model")
    got, step = jck.restore(pl["plain_dir"], _jexample())
    assert step == CKPT_STEPS
    assert checkpointer.read_manifest(pl["plain_dir"], step)["extra"][
        "npod"] == 2
    whole = jax.tree.leaves({k: got[k] for k in ("opt", "params")})
    assert len(whole) == len(out[0]["whole"]) - len(jax.tree.leaves(
        got["ef"]))
    n = len(jax.tree.leaves(got["ef"]))
    for a, b in zip(whole, out[0]["whole"][n:]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    by_pod = {o["coordinate"]["pod"]: o for o in out}
    for i, leaf in enumerate(jax.tree.leaves(got["ef"])):
        want = np.stack([by_pod[p]["plain"][i].numpy() for p in range(2)])
        np.testing.assert_array_equal(np.asarray(leaf), want)


def _meta_like(tree):
    return {k: _meta_like(v) if isinstance(v, dict) else torch.empty(
        v.shape, dtype=torch.int64 if v.shape == () else torch.float32,
        device="meta") for k, v in tree.items()}


def test_sketched_pod_model_record_is_the_reference_codecs(runs,
                                                           monkeypatch):
    """The (2, 1, 2) run's sketched record: the reference codec's encode
    of the stacked rows (its `n_buckets`, its `y` within TOL), decoding
    like the reference's decode of the same `y`; each rank restored its
    pod's row of that decode, and its blocks of the params unchanged."""
    from repro_torch import rp
    from repro_torch.core import from_numpy_operator
    pl, out = _ckpt(runs[0], "pod_model")
    made = {s: from_numpy_operator(f, a, "cpu")
            for s, (f, a) in _ckpt_ops().items()}
    monkeypatch.setattr(rp, "make_projector",
                        lambda spec, seed=0, *, device=None: made[seed])
    jshapes = _jexample()["ef"]
    jcodec = JCodec(JSketchConfig(**SKETCH), jshapes)
    manifest = checkpointer.read_manifest(pl["sketched_dir"], 1)
    meta = manifest["extra"]["sketched_ef"]
    assert manifest["extra"]["npod"] == 2
    assert meta["n_buckets"] == jcodec.meta()["n_buckets"]
    codec = SketchedTreeCodec.from_meta(meta, _meta_like(jshapes),
                                        device="cpu")
    example = _meta_like({k: v for k, v in _jexample().items()
                          if k != "ef"})
    example["ef"] = codec.record_shapes()
    rec = checkpointer.restore(pl["sketched_dir"], example, 1)[0]["ef"]
    by_pod = {o["coordinate"]["pod"]: o for o in out}
    leaves, treedef = jax.tree.flatten(jshapes)
    stacked = jax.tree.unflatten(treedef, [jnp.asarray(np.stack(
        [by_pod[p]["sketched"]["live"][i].numpy() for p in range(2)]))
        for i in range(len(leaves))])
    jrec = jcodec.encode(stacked, step=1)
    y, jy = rec["y"].numpy(), np.asarray(jrec["y"])
    assert y.shape == jy.shape
    assert np.abs(y - jy).max() <= TOL * np.abs(jy).max()
    want = jcodec.decode({"y": jnp.asarray(y), "seed": jrec["seed"],
                          "step": jrec["step"]})
    for i, b in enumerate(jax.tree.leaves(want)):
        b = np.asarray(b)
        top = np.abs(b).max()
        for o in out:
            s = o["sketched"]
            assert s["step"] == 1 and s["params_equal"]
            assert np.abs(s["restored"][i].numpy()
                          - b[o["coordinate"]["pod"]]).max() <= TOL * top


def test_restore_at_another_pod_count_respecs_the_rows(runs):
    """The (2, 1, 2) checkpoint onto (1, 2, 2), the same four ranks: the
    one pod's EF is the two rows' fixed-order sum (`respec_pod_ef`, bit
    for bit), the params and moments the saved ones."""
    pl, out = _ckpt(runs[0], "pod_model")
    by_pod = {o["coordinate"]["pod"]: o for o in out}
    for o in out:
        r = o["respec"]
        assert r["step"] == CKPT_STEPS
        n = len(r["ef"])
        for i in range(n):
            want = by_pod[0]["plain"][i] + by_pod[1]["plain"][i]
            assert torch.equal(r["ef"][i], want)
        _equal(r["whole"][n:], o["whole"][n:])


def test_train_cli_on_the_reference_mesh_resumes(runs):
    """`--mesh 2x2x2` on eight ranks: the first launch checkpoints steps
    1 and 2 and crashes at step 2; the second resumes from step 2 and
    finishes step 3."""
    _, out = runs[0]["cli"]
    first = out[0]
    assert first["error"] == "injected fault at step 2"
    assert "[mesh] {'pod': 2, 'data': 2, 'model': 2}" in first["first"]
    assert "[ckpt] sketched EF records" in first["first"]
    assert "[resume] restored step 2" in first["second"]
    assert "[train] finished at step 3" in first["second"]
    for o in out[1:]:       # rank 0 alone prints
        assert o["first"] == o["second"] == ""
