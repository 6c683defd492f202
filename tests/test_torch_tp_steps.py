"""The train step on (data, model) meshes (the decoder family) against the
reference's mesh-free composition, and the train CLI on them.

As `tests/test_torch_fsdp.py` and `tests/test_torch_pod_data.py` do for
the data axis, the ranks (gloo processes, `tests/torch_dist_workers.py`'s
`tp_steps`) are held against the composition the reference's step runs,
jitted without a mesh, with the reference's operators carried across:
`value_and_grad(loss_fn)` of the global batch (G MoE groups as the
reference's `moe_groups_for` gives them on the mesh), `compress` where
the step compresses, `adamw.update` (clip 1.0); or, for
`fused_update=True`, `adamw.update_sketched` on the whole trees (K4 in
interpret mode, clip None). Reduced llama3.2-3b (tied embedding) and
mixtral-8x22b (untied, 4 experts: expert parallelism), batch 4, seq 16,
fp32 compute, lr 1e-2, three steps: on (1, 2) uncompressed and
compressed, on (2, 2) those and fused (K4's two-dim block form). Bounds
as `test_torch_pod_data.py`'s pod x data ones (`_hold`): the loss and
the clip's norm 1e-5 relative, m, v and the EF 1e-4 of each leaf's
largest entry a step taken (the model axis sums the products in another
order, and the noise compounds: measured 1.4e-4 in mixtral's v after
three steps), the params 0.01 lr where the reference's sqrt(v_hat)
stayed above 100 eps. The reference's compositions run in a pool of
processes beside the ranks.
Each rank holds its two-dim blocks of params, m and v (the EF whole),
the whole params, m, v and EF are the same bits on every rank, and a step
dispatches one K1 and one K2 a leaf when compressed, one K1 and one K4
(its block form) when fused. `cast_params_once` halves the ledger's
`param_gather` bytes and keeps llama's loss within bf16's 3e-2 of the
reference's fp32 one. The train CLI runs `--mesh 1x2` and `--mesh 2x2`
under `torch.distributed.run`.
"""
import multiprocessing
import subprocess
import sys
import types
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.sketch import SketchConfig as JSketchConfig
from repro.launch.steps import moe_groups_for as jmoe_groups_for
from repro.optim import adamw as jadamw
from repro.optim.compress import SketchCompressor as JCompressor
from repro_torch.configs import get_config, reduced
from repro_torch.launch import fsdp, sharding
from repro_torch.models import build_model

from test_torch_pod_data import (BATCH, LR, SEQ, SKETCH, STEPS, _fused_reference,
                                 _hold, _ops, _record, _rel, _setup)
from test_torch_tp import _serve_reference, check_serving
from torch_dist_workers import start_ranks

REPO = Path(__file__).resolve().parents[1]
# name: (arch, mesh shape, modes)
CASES = {"llama-1x2": ("llama3.2-3b", (1, 2), ("uncompressed", "compressed")),
         "mixtral-1x2": ("mixtral-8x22b", (1, 2),
                         ("uncompressed", "compressed")),
         "llama-2x2": ("llama3.2-3b", (2, 2),
                       ("uncompressed", "compressed", "fused", "cast")),
         "mixtral-2x2": ("mixtral-8x22b", (2, 2),
                         ("uncompressed", "compressed", "fused"))}
NAMES = ("data", "model")
BF16_TOL = 3e-2
SERVE_ON = "llama-2x2"      # the case whose ranks also run the serving steps


def _stand_in(shape):
    return types.SimpleNamespace(shape=dict(zip(NAMES, shape)),
                                 axis_names=NAMES)


def _reference(arch, G):
    """The uncompressed and compressed compositions, three steps each."""
    jmodel, params0, opt0, _, batches = _setup(arch)
    cfg = jadamw.AdamWConfig()
    loss_grad = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss_fn(
        p, b, compute_dtype=jnp.float32, moe_groups=G)))
    update = jax.jit(lambda p, g, o: jadamw.update(p, g, o,
                                                   jnp.float32(LR), cfg))
    jcomp = JCompressor(JSketchConfig(**SKETCH))
    compress = jax.jit(lambda g, e, step: jcomp.compress(
        g, {"residual": e}, step=step)[:2])
    out = {}
    for mode in ("uncompressed", "compressed"):
        params, opt = params0, opt0
        ef = jax.tree.map(jnp.zeros_like, params)
        runs = []
        for b in batches:
            loss, g = loss_grad(params, {k: jnp.asarray(v)
                                         for k, v in b.items()})
            if mode == "compressed":
                g, est = compress(g, ef, opt["count"])
                ef = est["residual"]
            params, opt, met = update(params, g, opt)
            _record(runs, loss, params, opt,
                    grad_norm=float(met["grad_norm"]))
            runs[-1]["ef"] = [np.asarray(x) for x in jax.tree.leaves(ef)]
        out[mode] = runs
    return out


def _reference_job(arch, shape):
    """The reference's steps of an arch on a mesh shape (the fused ones on
    (2, 2)), run in a process of a pool beside the others."""
    G = jmoe_groups_for(jget_config(arch), _stand_in(shape), BATCH)
    out = _reference(arch, G)
    if shape == (2, 2):
        out["fused"] = _fused_reference(arch, G)
    return out


def _cli(mesh, tmp):
    n = int(np.prod([int(x) for x in mesh.split("x")]))
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(n), "-m", "repro_torch.launch.train",
            "--arch", "llama3.2-3b", "--reduced", "--mesh", mesh,
            "--dist-backend", "gloo", "--device", "cpu", "--steps", "3",
            "--batch", "4", "--seq", "16", "--compress", "tt:k=64,dims=4x8x16"]
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp), "TMPDIR": str(tmp), "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks of every case and the CLI runs, started together (the
    serving case's once the reference's llama serve is made), and the
    reference's steps computed meanwhile in a pool of processes."""
    ops = _ops()

    def start(name, **extra):
        arch, shape, modes = CASES[name]
        _, _, _, state, batches = _setup(arch)
        return start_ranks(
            "tp_steps", int(np.prod(shape)), tmp_path_factory.mktemp(name),
            {"arch": arch, "state": state, "batches": batches, "seq": SEQ,
             "batch": BATCH, "lr": LR, "ops": ops, "cfg": SKETCH,
             "modes": list(modes), **extra}, shape=shape, names=NAMES)

    started = {name: start(name) for name in CASES if name != SERVE_ON}
    cli = {m: _cli(m, tmp_path_factory.mktemp(f"cli{m}"))
           for m in ("1x2", "2x2")}
    serve = _serve_reference(CASES[SERVE_ON][0])
    started[SERVE_ON] = start(SERVE_ON, serve=[{
        "name": "llama", "arch": CASES[SERVE_ON][0],
        **{k: serve[k] for k in ("params", "tokens", "cache", "feed")}}])
    jobs = sorted({(a, s) for a, s, _ in CASES.values()})
    with ProcessPoolExecutor(len(jobs), mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        refs = dict(zip(jobs, pool.map(_reference_job, *zip(*jobs))))
    got = {name: fin() for name, fin in started.items()}
    outs = {m: p.communicate(timeout=240) for m, p in cli.items()}
    return (got, refs, {m: (cli[m].returncode, outs[m][0]) for m in cli},
            serve)


MODE_CASES = [(n, m) for n, (_, _, modes) in CASES.items() for m in modes
              if m != "cast"]


@pytest.mark.parametrize("case,mode", MODE_CASES)
def test_model_mesh_step_matches_reference_composition(runs, case, mode):
    got, refs, _, _ = runs
    arch, shape, _ = CASES[case]
    want = refs[(arch, shape)][mode]
    firm = [True] * len(want[0]["v"])
    first = got[case][0][mode]["runs"]
    for i in range(STEPS):
        # the moments and the EF to 1e-4 a step taken, as on the pod x
        # data mesh: the model axis sums the products in another order
        firm = _hold(first[i], want[i], i, firm, moments=1e-4 * (i + 1))
        if mode != "uncompressed":
            for a, b in zip(first[i]["ef"], want[i]["ef"]):
                assert _rel(a, b) <= 1e-4 * (i + 1), "ef"
        for o in got[case][1:]:   # the residual's bits too
            for part in ("params", "m", "v", "ef"):
                for a, b in zip(o[mode]["runs"][i][part], first[i][part]):
                    assert torch.equal(a, b), part


def _blocks(arch, shape):
    """Each rank's shapes of its two-dim blocks of the params."""
    model = build_model(reduced(get_config(arch)))
    mesh = _stand_in(shape)
    specs = fsdp._flat_specs(sharding.param_specs(
        model.cfg, model.param_axes(), mesh, model.param_shapes()))
    out = []
    for (p, spec), leaf in zip(specs.items(), fsdp._flat_specs(
            model.param_shapes()).values()):
        s = list(leaf.shape)
        for d in fsdp.shard_dims(spec, mesh):
            s[d] //= fsdp._size(mesh, fsdp._axes(spec[d]))
        out.append(tuple(s))
    return out, [tuple(t.shape) for t in
                 fsdp._flat_specs(model.param_shapes()).values()]


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_hold_two_dim_blocks_and_launch_a_kernel_a_leaf(runs, case):
    got, _, _, _ = runs
    arch, shape, modes = CASES[case]
    blocks, whole = _blocks(arch, shape)
    n = len(whole)
    if shape == (2, 2):
        assert any(b[1] < w[1] and b[2] < w[2]
                   for b, w in zip(blocks, whole) if len(b) == 3)
    for o in got[case]:
        for mode in modes:
            assert o[mode]["held"] == blocks, mode
            for r in o[mode]["runs"]:
                if mode != "uncompressed" and mode != "cast":
                    assert [tuple(t.shape) for t in r["ef"]] == whole
                want = {"compressed": {"dense": n, "sketch": n},
                        "fused": {"dense": n, "fused-update": n}}.get(mode,
                                                                      {})
                assert r["dispatches"] == want, mode
                if mode == "fused":
                    assert r["calls"] == {"fused_update_block": n,
                                          "fused_update_buckets": 0}


def test_cast_params_once_halves_the_gathers(runs):
    got, refs, _, _ = runs
    want = refs[("llama3.2-3b", (2, 2))]["uncompressed"]
    for o in got["llama-2x2"]:
        for i, (cast, plain) in enumerate(zip(o["cast"]["runs"],
                                              o["uncompressed"]["runs"])):
            rows = {m: {r["tag"]: r for r in run["ledger"]}
                    for m, run in (("cast", cast), ("plain", plain))}
            assert rows["cast"]["param_gather"]["bytes"] * 2 == \
                rows["plain"]["param_gather"]["bytes"]
            assert rows["cast"]["param_gather"]["calls"] == \
                rows["plain"]["param_gather"]["calls"]
            assert cast["loss"] == pytest.approx(want[i]["loss"],
                                                 rel=BF16_TOL)


def test_model_mesh_ledger(runs):
    """On (1, 2) the model axis's tags appear beside the loss's, and no
    data-axis gather; under sequence parallelism the replicated leaves'
    partial gradients are summed over 'model' (`grad_model`)."""
    got, _, _, _ = runs
    for case in ("llama-1x2", "mixtral-1x2"):
        for o in got[case]:
            rows = {r["tag"]: r for r in o["uncompressed"]["runs"][-1][
                "ledger"]}
            assert {"tp_gather", "tp_reduce", "tp_grad", "grad_model",
                    "loss"} <= set(rows)
            assert "param_gather" not in rows
            assert rows["grad_model"]["axes"] == ["model"]
            rows = {r["tag"]: r for r in o["compressed"]["runs"][-1][
                "ledger"]}
            assert rows["grad_model_gather"]["op"] == "all_gather"


def test_mesh_serving_with_a_data_axis_matches_the_reference(runs):
    """The prefill and serve steps on (2, 2): each data rank its half of
    the rows (the cache's batch dim over 'data', its KV heads over
    'model'), every rank all the rows' logits and tokens."""
    got, _, _, serve = runs
    check_serving([o["serve"]["llama"] for o in got[SERVE_ON]], serve,
                  "heads")


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_train_cli_on_a_model_mesh(runs, mesh):
    rc, out = runs[2][mesh]
    assert rc == 0, out[-3000:]
    assert f"'model': {mesh.split('x')[1]}" in out
    assert "loss" in out
