"""Rank programs for the port's multi-process CPU tests (not a test file).

`run_ranks` spawns `world` processes (the `spawn` start method), each
joining a gloo process group through a `file://` store in a temporary
directory (never a fixed port: several test workers run at once),
building a `launch.mesh.Mesh` and running one scenario of this module
on it. Each rank's result (tensors, numbers, strings) comes back through
`torch.save` in the same directory. This module imports torch and the
port only, so a rank starts without JAX; the tests compute the
reference's side in the parent and pass it over as numpy, the
reference's operators included (`carry_ops` installs them as the port's
`rp.make_projector`, as `tests/test_torch_train.py` does in-process).
"""
from __future__ import annotations

import functools
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run_ranks(scenario: str, world: int, tmp, payload: dict, *,
              shape, names, timeout: float = 240.0) -> list:
    """Run `scenario` on `world` gloo ranks of a mesh (`shape`, `names`);
    returns each rank's result, in rank order. A rank that raises fails
    the call with its traceback; so does one that outlives `timeout`."""
    return start_ranks(scenario, world, tmp, payload, shape=shape,
                       names=names, timeout=timeout)()


def start_ranks(scenario: str, world: int, tmp, payload: dict, *,
                shape, names, timeout: float = 240.0):
    """`run_ranks` without the wait: starts the ranks and returns the
    function that waits for them and returns their results (the parent
    computes the reference's side meanwhile)."""
    tmp = os.fspath(tmp)
    os.makedirs(tmp, exist_ok=True)
    store = os.path.join(tmp, f"store_{scenario}_{world}_{time.time_ns()}")
    ctx = mp.start_processes(
        _rank_main, args=(world, store, tuple(shape), tuple(names), scenario,
                          payload, tmp),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout

    def finish() -> list:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError(f"{scenario} on {world} ranks did not "
                                     f"end within {timeout:.0f} s")
        out = []
        for r in range(world):
            res = torch.load(os.path.join(tmp, f"{scenario}_{r}.pt"),
                             weights_only=False)
            if isinstance(res, dict) and "__error__" in res:
                raise AssertionError(f"rank {r}: {res['__error__']}")
            out.append(res)
        return out

    return finish


def _rank_main(rank, world, store, shape, names, scenario, payload, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh(shape, names, device="cpu")
        try:
            res = SCENARIOS[scenario](mesh, payload)
        except Exception:   # reported to the parent, which fails the test
            res = {"__error__": traceback.format_exc()}
        torch.save(res, os.path.join(tmp, f"{scenario}_{rank}.pt"))
    finally:
        if dist.is_initialized():   # the train CLI destroys it itself
            dist.destroy_process_group()


def carry_ops(ops: dict) -> None:
    """The port's `rp.make_projector` hands out the reference's operator
    arrays `ops[seed] = (family, [arrays])` for those seeds."""
    from repro_torch import rp
    from repro_torch.core import from_numpy_operator

    @functools.lru_cache(maxsize=None)
    def cached(seed):
        family, arrays = ops[seed]
        return from_numpy_operator(family, arrays, "cpu")

    def make(spec, seed=0, *, device=None):
        return cached(int(seed))

    rp.make_projector = make


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


# ---------------------------------------------------------------------------
# scenarios: (mesh, payload) -> result
# ---------------------------------------------------------------------------

def shard_scenario(mesh, pl):
    """rp.shard on one rank: its blocks, dispatch counts, the whole-tree
    sketch, the int8 quantizer twice, and the collective ledger."""
    from repro_torch import rp
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.rp import shard
    carry_ops(pl["ops"])
    op = rp.make_projector(None, pl["seed"])
    spec = (pl["axes"],)
    res = {}
    with rp.dispatch_stats() as st:
        res["block"] = shard.project_sharded(op, _t(pl["x"]), mesh=mesh,
                                             spec=spec)
    res["project_calls"] = sum(st.breakdown.values())
    with rp.dispatch_stats() as st:
        res["recon"] = shard.reconstruct_sharded(op, _t(pl["y"]), mesh=mesh,
                                                 spec=spec)
    res["reconstruct_calls"] = sum(st.breakdown.values())
    res["default_spec_block"] = shard.project_sharded(op, _t(pl["x"]),
                                                      mesh=mesh)
    try:
        shard.project_sharded(op, _t(pl["x"])[:pl["odd"]], mesh=mesh,
                              spec=spec)
        res["odd_error"] = None
    except ValueError as e:
        res["odd_error"] = str(e)
    cfg = SketchConfig(**pl["cfg"])
    shard.collective_ledger().reset()
    with rp.dispatch_stats() as st:
        res["tree_sketch"] = shard.sketch_tree_sharded(
            cfg, _t(pl["tree"]), pl["seed"], mesh=mesh)
    res["tree_calls"] = sum(st.breakdown.values())
    res["tree_ledger"] = shard.collective_ledger().table()
    group = mesh.group(pl["axes"])
    ys = _t(pl["ys"])[group.index]
    for per_row in (True, False):
        runs = []
        for _ in range(2):
            q, s = shard.quantize_for_psum(ys, group, group.size,
                                           per_row=per_row)
            runs.append((q, s, shard.dequantize_psum(
                shard.all_reduce(q, group), s, group.size)))
        res[f"int8_{per_row}"] = runs
    res["coordinate"] = mesh.coordinate
    res["index"] = group.index
    return res


def collective_scenario(mesh, pl):
    """compress_collective on this rank's pod row under every (sync,
    wire), each twice (the second call's ledger and bits are kept), and
    the one-tree-per-pod refusal."""
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.optim.compress import SketchCompressor
    from repro_torch.rp import shard
    carry_ops(pl["ops"])
    cfg = SketchConfig(**pl["cfg"])
    p = mesh.group("pod").index
    g = {k: _t(v[p]) for k, v in pl["grads"].items()}
    e = {"residual": {k: _t(v[p]) for k, v in pl["resid"].items()}}
    res = {}
    for sync in ("sketch-mean", "local-mean"):
        for wire in ("fp32", "int8"):
            comp = SketchCompressor(cfg, sync=sync, wire=wire)
            first = comp.compress_collective(g, e, step=pl["step"],
                                             mesh=mesh)
            shard.collective_ledger().reset()
            out, state, met = comp.compress_collective(g, e, step=pl["step"],
                                                       mesh=mesh)
            sk = comp._sketcher(g)
            res[sync, wire] = {
                "g": out, "resid": state["residual"], "first_g": first[0],
                "wire_bytes": comp.wire_bytes(sk),
                "metric": float(met["wire_bytes"]),
                "ledger": shard.collective_ledger().table()}
    bad = dict(g)
    if p == 1:
        bad["w"] = torch.zeros(g["w"].numel() + 1)
    try:
        SketchCompressor(cfg).compress_collective(
            bad, {"residual": {k: torch.zeros_like(v)
                               for k, v in bad.items()}},
            step=pl["step"], mesh=mesh)
        res["mismatch_error"] = None
    except ValueError as err:
        res["mismatch_error"] = str(err)
    return res


def train_scenario(mesh, pl):
    """The reduced llama3.2-3b pod step: 3 steps a sync mode ("none": no
    compressor) from the reference's initial state; losses, params and
    this rank's EF row."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import schedule
    from repro_torch.optim.compress import SketchCompressor
    from repro_torch.rp import shard
    carry_ops(pl["ops"])
    model = build_model(reduced(get_config("llama3.2-3b")))
    data = SyntheticLM(DataConfig(vocab=256, seq_len=pl["seq"],
                                  global_batch=pl["batch"]))
    res = {}
    for sync in pl["syncs"]:
        comp = (None if sync == "none" else
                SketchCompressor(SketchConfig(**pl["cfg"]), sync=sync))
        state = steps.from_numpy_state(model, pl["state"], device="cpu")
        step_fn = steps.build_train_step(
            model, ShapeSpec("t", pl["seq"], pl["batch"], "train"),
            mesh=mesh, compressor=comp, device="cpu",
            lr_fn=functools.partial(schedule.constant, peak_lr=pl["lr"]),
            compute_dtype=torch.float32)
        runs = []
        for i in range(pl["steps"]):
            shard.collective_ledger().reset()
            state, met = step_fn(state, data.batch(i))
            runs.append({"loss": float(met["loss"]),
                         "grad_norm": float(met["grad_norm"]),
                         "params": [t.clone() for t in
                                    tree_leaves(state["params"])],
                         "ef": [t.clone() for t in
                                tree_leaves(state["ef"]["residual"])]
                         if comp is not None else [],
                         "ledger": shard.collective_ledger().table()})
        res[sync] = runs
    return res


def vlm_pod_scenario(mesh, pl):
    """The reduced qwen2-vl pod step without a compressor (one dense
    all_reduce of the gradient): each rank takes its pod's rows of the
    payload's global batch, positions3 on its dim 1; one step from the
    payload's state at fp32 compute; the loss, params, m and v."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import schedule
    model = build_model(reduced(get_config("qwen2-vl-2b")))
    B, S = pl["batch"]["tokens"].shape
    state = steps.from_numpy_state(model, pl["state"], device="cpu")
    step_fn = steps.build_train_step(
        model, ShapeSpec("t", S, B, "train"), mesh=mesh, device="cpu",
        lr_fn=functools.partial(schedule.constant, peak_lr=pl["lr"]),
        compute_dtype=torch.float32)
    state, met = step_fn(state, pl["batch"])
    return {"loss": float(met["loss"]),
            **{k: [t.clone() for t in tree_leaves(tree)] for k, tree in (
                ("params", state["params"]), ("m", state["opt"]["m"]),
                ("v", state["opt"]["v"]))}}


def resume_scenario(mesh, pl):
    """resume_elastic of one checkpoint with and without the mesh."""
    from repro_torch.ckpt import resume_elastic
    example = pl["example"]
    got, step = resume_elastic(pl["dir"], _meta(example), npod_new=pl["new"],
                               mesh=mesh, device="cpu")
    plain, _ = resume_elastic(pl["dir"], _meta(example), npod_new=pl["new"],
                              device="cpu")
    return {"mesh": got, "plain": plain, "step": step}


def cli_scenario(mesh, pl):
    """`train.main(argv)` on this rank's group; the error it raises, or
    None."""
    from repro_torch.launch import train
    os.environ["WORLD_SIZE"] = str(dist.get_world_size())
    try:
        train.main(pl["argv"])
    except (NotImplementedError, ValueError, RuntimeError) as err:
        return {"error": f"{type(err).__name__}: {err}"}
    return {"error": None}


def _pod_setup(mesh, pl):
    """The reduced llama3.2-3b pod step (sketch-mean, fp32 compute) and
    its initial state (the payload's params and moments, a zero EF row),
    with the payload's operators carried across."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import schedule
    from repro_torch.optim.compress import SketchCompressor
    carry_ops(pl["ops"])
    npod = mesh.shape["pod"]
    model = build_model(reduced(get_config("llama3.2-3b")))
    comp = SketchCompressor(SketchConfig(**pl["cfg"]), sync="sketch-mean")
    step_fn = steps.build_train_step(
        model, ShapeSpec("t", pl["seq"], npod, "train"), mesh=mesh,
        compressor=comp, device="cpu", compute_dtype=torch.float32,
        lr_fn=functools.partial(schedule.constant, peak_lr=1e-2))
    data = SyntheticLM(DataConfig(vocab=256, seq_len=pl["seq"],
                                  global_batch=npod))

    def fresh():
        state = steps.from_numpy_state(model, pl["state"], device="cpu")
        state["ef"] = comp.init_state(state["params"])
        return state
    return comp, step_fn, data, fresh


def _leaves(state):
    from repro_torch.core.tree import tree_leaves
    return {part: [t.clone() for t in tree_leaves(state[part])]
            for part in ("params", "opt", "ef")}


def pod_ckpt_scenario(mesh, pl):
    """The pod train loop twice from one state: uninterrupted, and with
    checkpoints every 2 steps and a crash (on every rank) at
    `crash_at`, restarted from the directory; with `sketched`, the EF
    goes as one record of the stacked rows (`for_pod_rows`). Returns
    both final states' leaves, the restart report, and this rank's EF row
    restored twice from the final checkpoint; with `resume_dir`, also
    `resume_pod_rank` of that directory's checkpoint onto this mesh
    (this rank's step and EF row)."""
    from repro_torch.ckpt import SketchedTreeCodec, resume_pod_rank
    from repro_torch.core.tree import tree_leaves
    from repro_torch.runtime import train_loop
    from repro_torch.runtime.resilience import FaultInjector, \
        run_with_restarts
    comp, step_fn, data, fresh = _pod_setup(mesh, pl)
    npod, total = mesh.shape["pod"], pl["steps"]
    plain, _ = train_loop.run(step_fn, fresh(), data, train_loop.LoopConfig(
        total_steps=total, npod=npod, log_every=100), mesh=mesh,
        log=lambda *_: None)
    codec = (SketchedTreeCodec.for_pod_rows(comp.cfg, fresh()["ef"], npod)
             if pl["sketched"] else None)
    final = {}

    def attempt(injector):
        final["state"], step = train_loop.run(
            step_fn, fresh(), data, train_loop.LoopConfig(
                total_steps=total, ckpt_dir=pl["dir"], ckpt_every=2,
                npod=npod, log_every=100, async_ckpt=pl["async"]),
            injector=injector, ef_codec=codec, mesh=mesh,
            log=lambda *_: None)
        return step

    report = run_with_restarts(attempt, max_restarts=1,
                               injector=FaultInjector({pl["crash_at"]}))
    restored = [resume_pod_rank(pl["dir"], fresh(), mesh)[0]["ef"]
                for _ in range(2)]
    out = {"plain": _leaves(plain), "resumed": _leaves(final["state"]),
           "restarts": report.restarts, "final_step": report.final_step,
           "restored_ef": [[t.clone() for t in tree_leaves(r)]
                           for r in restored]}
    if pl.get("resume_dir"):
        state, step = resume_pod_rank(pl["resume_dir"], fresh(), mesh)
        out["elastic"] = (step, tree_leaves(state["ef"]))
    return out


def pod_sigterm_scenario(mesh, pl):
    """SIGTERM to one rank alone inside step 1: every rank saves at step
    2 and leaves the loop. Returns the final step and this rank's EF
    row."""
    import signal
    from repro_torch.runtime import train_loop
    _, step_fn, data, fresh = _pod_setup(mesh, pl)

    def step(state, batch):
        if mesh.rank == pl["signalled"] and int(state["opt"]["count"]) == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return step_fn(state, batch)

    logs = []
    state, final = train_loop.run(
        step, fresh(), data, train_loop.LoopConfig(
            total_steps=pl["steps"], ckpt_dir=pl["dir"], ckpt_every=100,
            npod=mesh.shape["pod"], log_every=100, async_ckpt=False),
        mesh=mesh, log=logs.append)
    return {"final_step": final, "ef": _leaves(state)["ef"], "logs": logs}


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    shape, dtype = tree
    return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")


SCENARIOS = {"shard": shard_scenario, "collective": collective_scenario,
             "train": train_scenario, "resume": resume_scenario,
             "cli": cli_scenario, "pod_ckpt": pod_ckpt_scenario,
             "pod_sigterm": pod_sigterm_scenario,
             "vlm_pod": vlm_pod_scenario}
