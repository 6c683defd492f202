"""The data-mesh (FSDP) train step of repro_torch against repro's mesh-free
composition.

The reference's FSDP is a jitted step laid out by its sharding specs,
whose mesh paths fail under this sandbox's jax (ROADMAP.md, "Reference
caveats"). So, as ROADMAP's "How a slice lands" prescribes, the port's
data-mesh step, on 2 and 4 gloo ranks (`tests/torch_dist_workers.py`),
is held against the reference's mesh-free composition on the global
batch: `value_and_grad` of `loss_fn(moe_groups=G)` (G from the
reference's `moe_groups_for` on a stand-in mesh of the same shape),
`compress` without a mesh where the step compresses, `adamw.update` with
its default clip of 1.0. Reduced llama3.2-3b (tied embedding) and
mixtral-8x22b (G = 2) on 2 ranks with a batch of 4 (two rows a rank),
and mixtral on 4 ranks with a batch of 2 that the data size does not
divide (the batch replicated, G = 2 groups on every rank); two steps each,
uncompressed and with `tt:k=64,rank=2` over 4x8x16 buckets. fp32
compute. Bounds: the loss and the clip's norm 1e-5 relative, every leaf
of m, v and the EF 1e-4 of its largest entry (those of
`tests/test_torch_collective.py`). AdamW's step m / (sqrt(v) + eps)
moves with the summation order where sqrt(v) is near eps (the rows of an
embedding that the batch does not touch, the experts that get no token,
and at k=64 the sketched estimate's small entries), so the params are
held to 0.01 lr where the reference's sqrt(v_hat) stayed above 100 eps
at every step (measured: at most 0.0043 lr), to 2 lr a step everywhere
(a flipped step; measured: 0.96 lr, on mixtral's untied embedding), and
to 1e-4 of the largest entry on 99.9% of each leaf. Every rank holds only
its blocks of params, m and v (the EF whole) and ends with the same
bits. Under remat='dots' llama's steps give the same bits as under
'nothing'. The clip norm counts a replicated leaf once. A data-mesh
checkpoint, written by rank 0 in whole leaves, is read back bit for bit
by the reference's `restore`; `restore(shardings=)` hands each rank its
block; a crash-restart through `train_loop.run(mesh=)` is bit-equal to
the uninterrupted run; and the train CLI runs on `--mesh 2x1` under
`torch.distributed.run`.
"""
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
from repro.ckpt import checkpointer as jcheckpointer
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.sketch import SketchConfig as JSketchConfig
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.steps import moe_groups_for as jmoe_groups_for
from repro.models import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.optim.compress import SketchCompressor as JCompressor
from repro_torch.ckpt import checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.launch import fsdp, steps
from repro_torch.models import build_model

from torch_dist_workers import _rand_like, start_ranks

REPO = Path(__file__).resolve().parents[1]
SKETCH = dict(family="tt", k=64, rank=2, dims=(4, 8, 16), bucket_elems=512)
KEY = 0x5EED
SEQ, STEPS, LR = 16, 2, 1e-2
# name: (arch, ranks, global batch)
CASES = {"llama-2": ("llama3.2-3b", 2, 4),
         "mixtral-2": ("mixtral-8x22b", 2, 4),
         "mixtral-4-replicated": ("mixtral-8x22b", 4, 2)}
MODES = (None, SKETCH)


def _stand_in(world):
    return types.SimpleNamespace(shape={"data": world, "model": 1},
                                 axis_names=("data", "model"))


def _ops(steps_) -> dict:
    """{port seed: the reference's operator arrays} for `steps_`."""
    jcfg = JSketchConfig(**SKETCH)
    out = {}
    for s in steps_:
        jop = jrp.make_projector(jcfg.spec(), jax.random.fold_in(
            jax.random.PRNGKey(KEY), s))
        out[KEY * 1_000_003 + s] = ("tt", [np.asarray(c) for c in jop.cores])
    return out


def _initial(jmodel):
    params = jmodel.init(jax.random.PRNGKey(0))
    opt = jadamw.init_state(params, jadamw.AdamWConfig())
    zeros = jax.tree.map(lambda p: np.zeros(p.shape, np.float32), params)
    return params, opt, jax.tree.map(np.asarray, {
        "params": params, "opt": opt, "ef": {"residual": zeros}})


def _reference(arch, world, batch):
    """The mesh-free composition's steps, a mode at a time."""
    jmodel = jbuild_model(jreduced(jget_config(arch)))
    jparams, jopt, state = _initial(jmodel)
    G = jmoe_groups_for(jmodel.cfg, _stand_in(world), batch)
    data = JSyntheticLM(JDataConfig(vocab=256, seq_len=SEQ,
                                    global_batch=batch))
    batches = [{k: np.asarray(v) for k, v in data.batch(i).items()}
               for i in range(STEPS)]
    loss_grad = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss_fn(
        p, b, compute_dtype=jnp.float32, moe_groups=G)))
    cfg = jadamw.AdamWConfig()
    update = jax.jit(lambda p, g, o: jadamw.update(p, g, o,
                                                   jnp.float32(LR), cfg))
    jcomp = JCompressor(JSketchConfig(**SKETCH))
    compress = jax.jit(lambda g, e, step: jcomp.compress(
        g, {"residual": e}, step=step)[:2])
    want = []
    for mode in MODES:
        params, opt = jparams, jopt
        ef = jax.tree.map(jnp.zeros_like, jparams)
        runs = []
        for b in batches:
            loss, g = loss_grad(params, {k: jnp.asarray(v)
                                         for k, v in b.items()})
            if mode is not None:
                g, est = compress(g, ef, opt["count"])
                ef = est["residual"]
            params, opt, met = update(params, g, opt)
            runs.append({"loss": float(loss),
                         "grad_norm": float(met["grad_norm"]),
                         **{k: [np.asarray(x) for x in jax.tree.leaves(t)]
                            for k, t in (("params", params), ("m", opt["m"]),
                                         ("v", opt["v"]), ("ef", ef))}})
        want.append(runs)
    return state, batches, G, want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's ranks (llama's also under remat='dots') and the
    reference's steps."""
    started = {}
    refs = {}
    ops = _ops(range(STEPS))
    for name, (arch, world, batch) in CASES.items():
        state, batches, G, want = _reference(arch, world, batch)
        refs[name] = (G, want)
        started[name] = start_ranks(
            "fsdp", world, tmp_path_factory.mktemp(name),
            {"arch": arch, "state": state, "batches": batches, "seq": SEQ,
             "batch": batch, "lr": LR, "ops": ops, "modes": list(MODES) + (
                 ["dots"] if name == "llama-2" else [])},
            shape=(world, 1), names=("data", "model"))
    return {name: (fin(), refs[name]) for name, fin in started.items()}


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("mode", [0, 1], ids=["uncompressed", "compressed"])
@pytest.mark.parametrize("case", list(CASES))
def test_data_mesh_step_matches_reference_composition(runs, case, mode):
    out, (G, want) = runs[case]
    assert G == 2 if "mixtral" in case else G == 1
    firm = [True] * len(want[mode][0]["v"])
    for i in range(STEPS):
        w = want[mode][i]
        # the entries whose AdamW denominator sqrt(v_hat) has stayed far
        # above eps at every step so far
        c2 = 1.0 - 0.95 ** (i + 1)
        firm = [f & (np.sqrt(v / c2) > 100 * 1e-8)
                for f, v in zip(firm, w["v"])]
        for o in out:
            got = o["modes"][mode]["runs"][i]
            assert got["loss"] == pytest.approx(w["loss"], rel=1e-5)
            assert got["grad_norm"] == pytest.approx(w["grad_norm"],
                                                     rel=1e-5)
            for a, b, f in zip(got["params"], w["params"], firm):
                d = np.abs(a.numpy() - b)
                assert d[f].max(initial=0.0) <= 1e-2 * LR
                assert d.max() <= 2 * (i + 1) * LR
                assert (d <= 1e-4 * np.abs(b).max()).mean() >= 0.999
            for part in ("m", "v") + (("ef",) if mode else ()):
                for a, b in zip(got[part], w[part]):
                    assert _rel(a, b) <= 1e-4, part
            for part in ("params", "m", "v", "ef"):
                for a, b in zip(got[part], out[0]["modes"][mode]["runs"][i][
                        part]):
                    assert torch.equal(a, b)     # the same bits everywhere


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_its_blocks(runs, case):
    arch, world, _ = CASES[case]
    model = build_model(reduced(get_config(arch)))
    stand = _stand_in(world)
    specs = fsdp._flat_specs(steps.state_specs(model, stand)["params"])
    whole = [tuple(t.shape) for t in
             fsdp._flat_specs(model.param_shapes()).values()]
    blocks, sharded = [], 0
    for shape, spec in zip(whole, specs.values()):
        d = fsdp.shard_dim(spec, stand)
        if d is not None:
            sharded += 1
            shape = shape[:d] + (shape[d] // world,) + shape[d + 1:]
        blocks.append(shape)
    assert sharded >= len(whole) - 3      # all but the norms
    out, _ = runs[case]
    for o in out:
        for mode in (0, 1):
            held = o["modes"][mode]["held"]
            assert held["params"] == blocks
            assert held["m"] == blocks and held["v"] == blocks
        assert o["modes"][0]["held"]["ef"] == []
        assert o["modes"][1]["held"]["ef"] == whole    # the reference's P()


def test_ledger_of_a_step(runs):
    """llama (tied, 2 layers, 7 sharded leaves a layer): 14 layer slices
    gathered twice (the forward and the recompute under remat) and the
    embedding twice (the lookup and the unembedding); one reduce of each
    gather's gradient; one all_reduce of the replicated norms' gradients
    (norm1, norm2, final_norm: 320 floats), the loss and the norm. The
    compressed step all-reduces each gradient whole and gathers each
    leaf's sketch and reconstruction blocks."""
    out, _ = runs["llama-2"]
    for o in out:
        for mode, (reduce_op, tags) in enumerate((
                ("reduce_scatter", {"grad_norm"}),
                ("all_reduce", {"sketch", "unsketch"}))):
            rows = {r["tag"]: r for r in o["modes"][mode]["runs"][-1][
                "ledger"]}
            assert set(rows) == {"param_gather", "grad_reduce",
                                 "grad_replicated", "loss"} | tags
            assert rows["param_gather"]["calls"] == 30
            assert rows["grad_reduce"]["calls"] == 16
            assert rows["grad_reduce"]["op"] == reduce_op
            assert rows["grad_replicated"]["bytes"] == 320 * 4
            assert rows["loss"]["calls"] == 1


def test_remat_dots_on_a_data_mesh_equals_nothing(runs):
    """Under remat='dots' the layers' gathers run again in the backward
    (the selective checkpoint recomputes them) and the steps give the
    same bits as under 'nothing'."""
    out, _ = runs["llama-2"]
    for o in out:
        for dots, plain in zip(o["modes"][2]["runs"], o["modes"][0]["runs"]):
            assert dots["loss"] == plain["loss"]
            for part in ("params", "m", "v"):
                for a, b in zip(dots[part], plain[part]):
                    assert torch.equal(a, b)
            assert [(r["tag"], r["calls"]) for r in dots["ledger"]] == [
                (r["tag"], r["calls"]) for r in plain["ledger"]]


@pytest.mark.parametrize("case", list(CASES))
def test_clip_norm_counts_a_replicated_leaf_once(runs, case):
    arch, world, _ = CASES[case]
    model = build_model(reduced(get_config(arch)))
    tree = _rand_like(model.param_shapes(), torch.Generator().manual_seed(7))
    rep = sum(float(torch.sum(t * t)) for p, t in
              fsdp._flat_specs(tree).items() if "norm" in p)
    out, _ = runs[case]
    for o in out:
        assert o["norm"] == pytest.approx(o["whole_norm"], rel=1e-6)
        once_a_rank = (o["whole_norm"] ** 2 + (world - 1) * rep) ** 0.5
        # counted once a rank, the norm would lie far outside the bound
        assert abs(o["norm"] - once_a_rank) > 100 * 1e-6 * o["norm"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    jmodel = jbuild_model(jreduced(jget_config("llama3.2-3b")))
    _, _, state = _initial(jmodel)
    tmp = tmp_path_factory.mktemp("fsdp_ckpt")
    out = start_ranks(
        "fsdp_ckpt", 2, tmp,
        {"arch": "llama3.2-3b", "state": state, "seq": SEQ, "batch": 4,
         "lr": LR, "cfg": SKETCH, "ops": _ops(range(4)), "steps": 4,
         "crash_at": 3, "dir": str(tmp / "ck"), "async": True},
        shape=(2, 1), names=("data", "model"))()
    return out, state, tmp / "ck"


def test_crash_restart_on_a_data_mesh_is_bit_equal(ckpt):
    out, _, _ = ckpt
    for o in out:
        assert (o["restarts"], o["final_step"]) == (1, 4)
        assert len(o["resumed"]) == len(o["plain"])
        for a, b in zip(o["resumed"], o["plain"]):
            assert torch.equal(a, b)


def test_reference_reads_the_data_mesh_checkpoint(ckpt):
    out, state, ck = ckpt
    got, step = jcheckpointer.restore(ck, state)
    assert step == 4
    for a, b in zip(jax.tree.leaves(got), out[0]["whole"]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_sharded_restore_gives_each_rank_its_block(ckpt):
    out, _, _ = ckpt
    model = build_model(reduced(get_config("llama3.2-3b")))
    stand = _stand_in(2)
    specs = list(fsdp._flat_specs(steps.state_specs(
        model, stand, {"ef": None})).values())
    for r, o in enumerate(out):
        assert o["restored_step"] == 4
        for blk, whole, res, spec in zip(o["restored"], out[0]["whole"],
                                         o["resumed"], specs):
            d = fsdp.shard_dim(spec, stand)
            want = whole if d is None else whole.chunk(2, d)[r]
            assert torch.equal(blk, want)
            assert torch.equal(blk, res)


def test_sharded_restore_checks_its_specs(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(4, 3), "b": torch.ones(5)}
    checkpointer.save(tmp_path, 1, tree)
    grp = types.SimpleNamespace(size=2, index=1)
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 1},
                                 axis_names=("data", "model"),
                                 group=lambda axes: grp)
    example = {"a": torch.empty(2, 3), "b": torch.empty(5)}
    got, _ = checkpointer.restore(tmp_path, example,
                                  shardings={"a": (("data",), None),
                                             "b": (None,)}, mesh=mesh)
    assert torch.equal(got["a"], tree["a"][2:])
    assert torch.equal(got["b"], tree["b"])
    with pytest.raises(checkpointer.CheckpointError, match="shardings tree"):
        checkpointer.restore(tmp_path, example,
                             shardings={"a": (("data",), None)}, mesh=mesh)
    with pytest.raises(checkpointer.CheckpointError, match="mesh="):
        checkpointer.restore(tmp_path, example, shardings={"a": (None,)})


def test_train_cli_on_a_data_mesh(tmp_path):
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
            "--arch", "llama3.2-3b", "--reduced", "--mesh", "2x1",
            "--dist-backend", "gloo", "--device", "cpu", "--steps", "4",
            "--batch", "4", "--seq", "16", "--compress",
            "tt:k=64,dims=4x8x16", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "2", "--sketch-ef-ckpt"]
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin",
           "OMP_NUM_THREADS": "1"}
    crash = subprocess.run(argv + ["--crash-at", "3"], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=300)
    assert crash.returncode != 0 and "injected fault at step 3" in \
        crash.stderr
    out = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("[mesh] {'data': 2, 'model': 1} "
                            "backend=gloo device=cpu") == 1
    assert "[resume] restored step 2" in out.stdout
    assert out.stdout.count("[train] finished at step 4 (params=78144)") == 1
    extra = checkpointer.read_manifest(tmp_path / "ck", 4)["extra"]
    assert "sketched_ef" in extra
