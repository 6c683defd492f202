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
        mesh = make_mesh(shape, names, device=payload.get("device", "cpu"),
                         backend="gloo")
        try:
            res = SCENARIOS[scenario](mesh, payload)
        except Exception:   # reported to the parent, which fails the test
            res = {"__error__": traceback.format_exc()}
        torch.save(res, os.path.join(tmp, f"{scenario}_{rank}.pt"))
    finally:
        if dist.is_initialized():   # the train CLI destroys it itself
            dist.destroy_process_group()


def carry_ops(ops: dict, device="cpu") -> None:
    """The port's `rp.make_projector` hands out the reference's operator
    arrays `ops[seed] = (family, [arrays])` for those seeds, on
    `device`."""
    from repro_torch import rp
    from repro_torch.core import from_numpy_operator

    @functools.lru_cache(maxsize=None)
    def cached(seed):
        family, arrays = ops[seed]
        return from_numpy_operator(family, arrays, device)

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


def _fsdp_step(mesh, pl, cfg, remat="nothing", sync="local-mean",
               compute_dtype=torch.float32, **kw):
    """The reduced model's data-mesh train step (fp32 compute unless
    `compute_dtype`, constant lr, the payload's clip, `remat`, an MoE
    capacity factor of the payload's `capacity` where it names one),
    through a compressor of `cfg` (its pod `sync`) when given."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import AdamWConfig, schedule
    from repro_torch.optim.compress import SketchCompressor
    arch = reduced(get_config(pl["arch"]))
    if pl.get("capacity"):
        arch = dataclasses.replace(arch, moe=dataclasses.replace(
            arch.moe, capacity_factor=pl["capacity"]))
    model = build_model(arch)
    comp = (None if cfg is None else
            SketchCompressor(SketchConfig(**cfg), sync=sync))
    return model, steps.build_train_step(
        model, ShapeSpec("t", pl["seq"], pl["batch"], "train"), mesh=mesh,
        compressor=comp, compute_dtype=compute_dtype,
        opt=AdamWConfig(clip_norm=pl.get("clip", 1.0)),
        lr_fn=functools.partial(schedule.constant, peak_lr=pl["lr"]),
        remat=remat, **kw)


def fsdp_scenario(mesh, pl):
    """The data-mesh train step (FSDP) on the payload's reduced model from
    the payload's whole state (`shard_state`), once a mode (None: no
    compressor, else a SketchConfig dict; the payload's operators carried
    across; "dots": no compressor under remat='dots'): per step the loss,
    the clip's norm, the whole params, m, v (gathered back with
    `unshard_state`) and EF, and the collective ledger; the shapes this
    rank holds. Then `Sharded.global_norm` of a seeded tree's blocks
    beside the whole tree's norm."""
    from repro_torch import kernels
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import _sweep
    from repro_torch.launch import fsdp, steps
    from repro_torch.optim import adamw
    from repro_torch.rp import shard
    if "ops" in pl:
        carry_ops(pl["ops"], mesh.device)
    out = {"modes": []}
    for mode in pl["modes"]:
        cfg = None if mode == "dots" else mode
        model, step_fn = _fsdp_step(mesh, pl, cfg, remat="dots"
                                    if mode == "dots" else "nothing")
        whole = steps.from_numpy_state(model, pl["state"],
                                       device=mesh.device)
        if cfg is None:
            whole.pop("ef", None)
        state = steps.shard_state(model, whole, mesh)
        held = {part: [tuple(t.shape) for t in tree_leaves(tree)]
                for part, tree in (("params", state["params"]),
                                   ("m", state["opt"]["m"]),
                                   ("v", state["opt"]["v"]),
                                   ("ef", state.get("ef", {})))}
        runs = []
        for batch in pl["batches"]:
            shard.collective_ledger().reset()
            kernels.reset_launch_counts()
            state, met = step_fn(state, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
            led = shard.collective_ledger().table()
            full = steps.unshard_state(model, state, mesh)
            host = lambda tree: [t.cpu().clone()  # noqa: E731
                                 for t in tree_leaves(tree)]
            runs.append({
                "loss": float(met["loss"]),
                "grad_norm": float(met["grad_norm"]),
                "params": host(full["params"]), "m": host(full["opt"]["m"]),
                "v": host(full["opt"]["v"]), "ef": host(full.get("ef", {})),
                "ledger": led,
                "launches": [_sweep.sweep_project.launches,
                             _sweep.sweep_reconstruct.launches]})
        out["modes"].append({"held": held, "runs": runs})
    specs = steps.state_specs(model, mesh)["params"]
    gen = torch.Generator().manual_seed(7)
    tree = _rand_like(model.param_shapes(), gen)
    layout = fsdp.Sharded(mesh, specs)
    out["norm"] = float(layout.global_norm(layout.blocks(tree)))
    out["whole_norm"] = float(adamw.global_norm(tree))
    return out


def _rand_like(tree, gen):
    if isinstance(tree, dict):
        return {k: _rand_like(v, gen) for k, v in sorted(tree.items())}
    return torch.randn(tree.shape, generator=gen) * 3.0


def fsdp_ckpt_scenario(mesh, pl):
    """The data-mesh train loop (compressed, dense EF) twice from one
    state: uninterrupted, and with checkpoints every 2 steps and a crash
    at `crash_at`, restarted from the directory. Returns both final
    states' blocks, the whole final state, the restart report, and this
    rank's blocks of the final checkpoint through
    `restore(shardings=)`."""
    from repro_torch.ckpt import checkpointer
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.runtime import train_loop
    from repro_torch.runtime.resilience import FaultInjector, \
        run_with_restarts
    carry_ops(pl["ops"])
    model, step_fn = _fsdp_step(mesh, pl, pl["cfg"])
    data = SyntheticLM(DataConfig(vocab=256, seq_len=pl["seq"],
                                  global_batch=pl["batch"]))

    def fresh():
        whole = steps.from_numpy_state(model, pl["state"], device="cpu")
        return steps.shard_state(model, whole, mesh)
    specs = steps.state_specs(model, mesh, fresh())
    total = pl["steps"]
    plain, _ = train_loop.run(step_fn, fresh(), data, train_loop.LoopConfig(
        total_steps=total, log_every=100), mesh=mesh, shardings=specs,
        log=lambda *_: None)
    final = {}

    def attempt(injector):
        final["state"], step = train_loop.run(
            step_fn, fresh(), data, train_loop.LoopConfig(
                total_steps=total, ckpt_dir=pl["dir"], ckpt_every=2,
                log_every=100, async_ckpt=pl["async"]),
            injector=injector, mesh=mesh, shardings=specs,
            log=lambda *_: None)
        return step

    report = run_with_restarts(attempt, max_restarts=1,
                               injector=FaultInjector({pl["crash_at"]}))
    restored, step = checkpointer.restore(pl["dir"], fresh(),
                                          shardings=specs, mesh=mesh)

    def leaves(state):
        return [t.clone() for t in tree_leaves(state)]
    return {"plain": leaves(plain), "resumed": leaves(final["state"]),
            "whole": leaves(steps.unshard_state(model, final["state"],
                                                mesh)),
            "restored": leaves(restored), "restored_step": step,
            "restarts": report.restarts, "final_step": report.final_step}


def _counting(names):
    """Wrap `repro_torch.kernels.<name>` (the names `adamw.update_sketched`
    imports at each call) with call counters; returns the counts."""
    from repro_torch import kernels
    counts = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(kernels, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)
        setattr(kernels, name, wrapped)
    return counts


def _dispatches(stats) -> dict:
    """{structure: calls} of a `rp.dispatch_stats()` scope: 'dense' the
    sketches (K1), 'sketch' the reconstructions (K2), 'fused-update' K4."""
    out: dict = {}
    for (_, structure, _, _), n in stats.breakdown.items():
        out[structure] = out.get(structure, 0) + n
    return out


def fsdp_fused_scenario(mesh, pl):
    """The data-mesh train step with `fused_update=True` (clip None) on
    the payload's reduced model from the payload's whole state
    (`shard_state`): per step the loss, the whole params, m, v (gathered
    with `unshard_state`) and EF, this rank's EF, the collective ledger,
    the kernel dispatches by structure and the K4 calls by form; the
    shapes this rank holds."""
    from repro_torch import rp
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import steps
    from repro_torch.rp import shard
    carry_ops(pl["ops"])
    calls = _counting(("fused_update_block", "fused_update_buckets"))
    model, step_fn = _fsdp_step(mesh, pl, pl["cfg"], fused_update=True)
    whole = steps.from_numpy_state(model, pl["state"], device="cpu")
    state = steps.shard_state(model, whole, mesh)
    held = {part: [tuple(t.shape) for t in tree_leaves(tree)]
            for part, tree in (("params", state["params"]),
                               ("m", state["opt"]["m"]),
                               ("v", state["opt"]["v"]),
                               ("ef", state["ef"]))}
    runs = []
    for batch in pl["batches"]:
        shard.collective_ledger().reset()
        before = dict(calls)
        with rp.dispatch_stats() as st:
            state, met = step_fn(state, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
        led = shard.collective_ledger().table()
        full = steps.unshard_state(model, state, mesh)
        runs.append({
            "loss": float(met["loss"]),
            "params": [t.clone() for t in tree_leaves(full["params"])],
            "m": [t.clone() for t in tree_leaves(full["opt"]["m"])],
            "v": [t.clone() for t in tree_leaves(full["opt"]["v"])],
            "ef": [t.clone() for t in tree_leaves(full["ef"])],
            "ledger": led, "dispatches": _dispatches(st),
            "calls": {k: calls[k] - before[k] for k in calls}})
    return {"held": held, "runs": runs}


def pod_data_scenario(mesh, pl):
    """The reduced llama3.2-3b train step on a (pod, data, 1) mesh, once a
    mode ("compressed": a sketch-mean compressor of `cfg`, the payload's
    operators carried across; "uncompressed"), from the payload's whole
    state (`shard_state`), clip 1.0, fp32 compute: per step the loss, the
    clip's norm, the whole params, m and v (`unshard_state`), this rank's
    blocks and EF, the ledger, and the compressor's `wire_bytes`; the
    shapes this rank holds."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import steps
    from repro_torch.rp import shard
    carry_ops(pl["ops"])
    out = {"coordinate": mesh.coordinate}
    for mode in pl["modes"]:
        compressed = mode == "compressed"
        model, step_fn = _fsdp_step(mesh, pl, pl["cfg"] if compressed
                                    else None, sync="sketch-mean")
        whole = steps.from_numpy_state(model, pl["state"], device="cpu")
        if not compressed:
            whole.pop("ef", None)
        state = steps.shard_state(model, whole, mesh)
        held = {part: [tuple(t.shape) for t in tree_leaves(tree)]
                for part, tree in (("params", state["params"]),
                                   ("m", state["opt"]["m"]),
                                   ("ef", state.get("ef", {})))}
        runs = []
        for batch in pl["batches"]:
            shard.collective_ledger().reset()
            state, met = step_fn(state, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
            led = shard.collective_ledger().table()
            full = steps.unshard_state(model, state, mesh)
            runs.append({
                "loss": float(met["loss"]),
                "grad_norm": float(met["grad_norm"]),
                "params": [t.clone() for t in tree_leaves(full["params"])],
                "m": [t.clone() for t in tree_leaves(full["opt"]["m"])],
                "v": [t.clone() for t in tree_leaves(full["opt"]["v"])],
                "blocks": [t.clone() for t in tree_leaves(state["params"])],
                "ef": [t.clone() for t in tree_leaves(state.get("ef", {}))],
                "ledger": led, "wire_bytes": met.get("wire_bytes")})
        out[mode] = {"held": held, "runs": runs}
    out["partial"] = _partial_split(mesh)
    if "ckpt_dir" in pl:
        out["ckpt"] = _save_and_restore(mesh, pl)
    return out


def _save_and_restore(mesh, pl):
    """`train_loop.run(mesh=, shardings=)` with a checkpoint directory on
    the mesh (compressed, sketch-mean): one step, saved; then the same
    call again, which restores the step and runs none. The saved and the
    restored states' leaves (this rank's blocks and EF row)."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.runtime import train_loop
    model, step_fn = _fsdp_step(mesh, pl, pl["cfg"], sync="sketch-mean")
    data = SyntheticLM(DataConfig(vocab=256, seq_len=pl["seq"],
                                  global_batch=pl["batch"]))
    state = steps.shard_state(model, steps.from_numpy_state(
        model, pl["state"], device="cpu"), mesh)
    specs = steps.state_specs(model, mesh, state)
    cfg = train_loop.LoopConfig(total_steps=1, ckpt_dir=pl["ckpt_dir"],
                                npod=mesh.shape["pod"], async_ckpt=False)
    out = []
    for _ in range(2):
        state, _ = train_loop.run(step_fn, state, data, cfg, mesh=mesh,
                                  shardings=specs, log=lambda *_: None)
        out.append([t.clone() for t in tree_leaves(state)])
    return out


def _partial_tree():
    """A whole tree, each of 4 ranks' loss weights, and specs that split
    `a` over ('pod', 'data'), `b` over 'pod' alone (as `spec_for` falls
    back to where a dim does not divide), `c` not at all."""
    gen = torch.Generator().manual_seed(3)
    whole = {"a": torch.randn(8, 3, generator=gen),
             "b": torch.randn(4, 3, generator=gen),
             "c": torch.randn(3, generator=gen)}
    xs = [{k: torch.randn(v.shape, generator=gen) for k, v in whole.items()}
          for _ in range(4)]
    specs = {"a": (("pod", "data"), None), "b": (("pod",), None),
             "c": (None,)}
    return whole, xs, specs


def _partial_split(mesh):
    """`fsdp.Sharded` on a (pod, data) mesh with a leaf split over fewer
    axes than the gradient's: each rank's loss sum(leaf * x_rank) through
    the layout's gather; the gradients `finish` returns under
    reduce='scatter' and 'all', and `global_norm` of the whole tree's
    blocks."""
    from repro_torch.launch import fsdp
    whole, xs, specs = _partial_tree()
    keys = sorted(whole)
    out = {}
    for reduce in ("scatter", "all"):
        layout = fsdp.Sharded(mesh, specs, reduce=reduce)
        live = {k: v.clone().requires_grad_(True)
                for k, v in layout.blocks(whole).items()}
        loss = sum((layout(k, live[k]) * xs[mesh.rank][k]).sum()
                   for k in keys)
        grads = dict(zip(keys, torch.autograd.grad(
            loss, [live[k] for k in keys])))
        out[reduce] = layout.finish(grads)
    out["norm"] = float(layout.global_norm(layout.blocks(whole)))
    return out


def _tp_model(case):
    """The reduced model of a model-axis case (its expert count, its dense
    residual FFN, its query heads, its KV heads, its d_ff or its d_model
    overridden where the case names them)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    cfg = reduced(get_config(case["arch"]))
    if case.get("experts"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=case["experts"]))
    if case.get("dense_ff"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dense_residual_ff=case["dense_ff"]))
    for key, field in (("heads", "n_heads"), ("kv_heads", "n_kv_heads"),
                       ("d_ff", "d_ff"), ("d_model", "d_model")):
        if case.get(key):
            cfg = dataclasses.replace(cfg, **{field: case[key]})
    return build_model(cfg)


def tp_grad_scenario(mesh, pl):
    """Each case's loss and gradient on a (data, model) mesh through the
    step's pieces, fp32 compute: the rank's blocks of the payload's whole
    params (`fsdp.shard_tree`), its rows of the batch, the step's
    `fsdp.Sharded` (`steps.grad_view`) and `model.loss_fn` under
    `settings.override(mesh=, **settings)`,
    with `seq_parallel` on and off: the loss summed over the ranks, the
    whole gradient (`unshard_tree`) and, for each leaf the model axis
    does not split, this rank's gradient of it as `finish` leaves it."""
    from repro_torch.core.tree import tree_flatten, tree_unflatten
    from repro_torch.launch import fsdp, sharding, steps
    from repro_torch.models import from_numpy_params, settings
    from repro_torch.rp import shard
    out = {}
    for case in pl["cases"]:
        model = _tp_model(case)
        cfg = model.cfg
        params = from_numpy_params(cfg, case["params"], device="cpu")
        pspecs = sharding.param_specs(cfg, model.param_axes(), mesh,
                                      model.param_shapes())
        blocks, treedef = tree_flatten(fsdp.shard_tree(params, pspecs, mesh))
        dg = mesh.group(("data",))
        rows = {}
        for k, v in case["batch"].items():
            t = torch.from_numpy(np.array(v))
            d = sharding.batch_dim(k)
            if k != "patch_positions" and t.shape[d] % dg.size == 0:
                per = t.shape[d] // dg.size
                t = t.narrow(d, dg.index * per, per)
            rows[k] = t
        res = {}
        for sp in (True, False):
            layout = steps.grad_view(model, mesh, pspecs,
                                     rows["tokens"].shape[1],
                                     seq_parallel=sp)
            live = [t.detach().requires_grad_(True) for t in blocks]
            with torch.enable_grad(), settings.override(
                    mesh=mesh, **case.get("settings", {})):
                loss = model.loss_fn(tree_unflatten(treedef, live), rows,
                                     compute_dtype=torch.float32,
                                     gather=layout, seq_parallel=sp)
                grads = torch.autograd.grad(loss, live)
            grads = layout.finish(tree_unflatten(treedef, list(grads)))
            total = shard.all_reduce(loss.detach().reshape(1), mesh.group(
                ("data", "model")))[0] / dg.size
            rep = {p: g.clone() for p, g, in zip(
                layout.specs, tree_flatten(grads)[0])
                if layout.model_dim[p] is None}
            whole = fsdp.unshard_tree(grads, pspecs, mesh)
            res[sp] = {"loss": float(total),
                       "grads": [t.clone() for t in tree_flatten(whole)[0]],
                       "rep": rep}
        out[case["name"]] = res
    return out


def tp_steps_scenario(mesh, pl):
    """The reduced model's train step on a (data, model) mesh from the
    payload's whole state (`shard_state`), once a mode: "uncompressed",
    "compressed" (the payload's sketch, its operators carried across),
    "fused" (`fused_update=True`, clip None), and "bf16" / "cast" (no
    compressor, bf16 compute, `cast_params_once` off / on): per step the
    loss, the clip's norm, the whole params, m, v (`unshard_state`), this
    rank's EF, the ledger, the kernel dispatches by structure and the K4
    calls by form; the shapes this rank holds. With `serve` in the
    payload, then `tp_serve_scenario` on its cases."""
    from repro_torch import rp
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import steps
    from repro_torch.models import settings
    from repro_torch.rp import shard
    carry_ops(pl["ops"])
    calls = _counting(("fused_update_block", "fused_update_buckets"))
    out = {"coordinate": mesh.coordinate}
    for mode in pl["modes"]:
        sketch = pl["cfg"] if mode in ("compressed", "fused") else None
        kw = {"fused_update": True} if mode == "fused" else {}
        if mode in ("bf16", "cast"):
            kw["compute_dtype"] = torch.bfloat16
        model, step_fn = _fsdp_step(
            mesh, dict(pl, clip=None) if mode == "fused" else pl, sketch,
            **kw)
        whole = steps.from_numpy_state(model, pl["state"], device="cpu")
        if sketch is None:
            whole.pop("ef", None)
        state = steps.shard_state(model, whole, mesh)
        held = [tuple(t.shape) for t in tree_leaves(state["params"])]
        runs = []
        for batch in pl["batches"]:
            shard.collective_ledger().reset()
            before = dict(calls)
            with rp.dispatch_stats() as st, settings.override(
                    cast_params_once=mode == "cast"):
                state, met = step_fn(state, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
            led = shard.collective_ledger().table()
            full = steps.unshard_state(model, state, mesh)
            runs.append({
                "loss": float(met["loss"]),
                "grad_norm": (float(met["grad_norm"]) if "grad_norm" in met
                              else None),
                "params": [t.clone() for t in tree_leaves(full["params"])],
                "m": [t.clone() for t in tree_leaves(full["opt"]["m"])],
                "v": [t.clone() for t in tree_leaves(full["opt"]["v"])],
                "ef": [t.clone() for t in tree_leaves(state.get("ef", {}))],
                "ledger": led, "dispatches": _dispatches(st),
                "calls": {k: calls[k] - before[k] for k in calls}})
        out[mode] = {"held": held, "runs": runs}
    if "serve" in pl:   # the serving cases on the same mesh
        out["serve"] = tp_serve_scenario(mesh, {"cases": pl["serve"]})
    return out


def tp_serve_scenario(mesh, pl):
    """The prefill and serve steps on a (data, model) mesh, per case (the
    reference's whole params, its prefill cache and greedy tokens): the
    mesh prefill's logits, 8 serve steps (the policy's bf16) from the
    cache in bf16 (`shard_cache`) fed the reference's tokens, and the
    same steps at fp32 compute from it in fp32 (their logits); the
    cache's layout."""
    from repro_torch.launch import sharding, steps
    from repro_torch.models import from_numpy_params
    from repro_torch.models.config import ShapeSpec
    out = {}
    for case in pl["cases"]:
        model = _tp_model(case)
        cfg = model.cfg
        params = steps.shard_params(model, from_numpy_params(
            cfg, case["params"], device="cpu"), mesh)
        tokens = torch.from_numpy(case["tokens"])
        B, S = tokens.shape
        pre = steps.build_prefill_step(model, ShapeSpec("p", S, B,
                                                        "prefill"), mesh=mesh)
        logits = pre(params, {"tokens": tokens})

        def cache(arrays, dtype):
            whole = {k: torch.from_numpy(np.array(v)).to(
                torch.int32 if k == "pos" else dtype)
                for k, v in arrays.items()}
            return whole, steps.shard_cache(model, whole, mesh)
        whole, c_bf16 = cache(case["cache"], torch.bfloat16)
        _, c_fp32 = cache(case["cache"], torch.float32)
        layout = {2: "heads", 3: "seq"}.get(next(
            (i for i, e in enumerate(sharding.cache_specs(cfg, whole, mesh)[
                "k"]) if e == "model"), None))
        shape = ShapeSpec("d", whole["k"].shape[3], B, "decode")
        serve = steps.build_serve_step(model, shape, mesh=mesh)
        serve32 = steps.build_serve_step(model, shape, mesh=mesh,
                                         logits=True,
                                         compute_dtype=torch.float32)
        toks, fp32 = [], []
        for i, tok in enumerate(case["feed"]):
            pos = torch.full((B,), S + i, dtype=torch.int32)
            tok = torch.from_numpy(tok)
            nxt, c_bf16 = serve(params, c_bf16, tok, pos)
            toks.append(nxt.clone())
            _, c_fp32, lg = serve32(params, c_fp32, tok, pos)
            fp32.append(lg.clone())
        out[case["name"]] = {"prefill": logits.clone(), "tokens": toks,
                             "logits": fp32, "layout": layout,
                             "cache": {k: tuple(v.shape)
                                       for k, v in c_bf16.items()}}
    return out


def collective_inputs():
    """x (6, 8), w (8, 12) and the cotangent c (6, 12) of the column
    gather's check, xn (6, 16), wn (16,) and cn (6, 16) of the split
    norm's, drawn from a seed."""
    gen = torch.Generator().manual_seed(5)
    return tuple(torch.randn(shape, generator=gen) for shape in (
        (6, 8), (8, 12), (6, 12), (6, 16), (16,), (6, 16)))


def tp_collectives_scenario(mesh, pl):
    """`ModelAxis.cols` and `ModelAxis.stat` on this rank's blocks of
    `collective_inputs`: the column block's product gathered, of which
    the rank uses every other column from its index (the whole of them
    over the ranks); the split norm of its channels times its part of the
    cotangent. The loss summed over the ranks and the gradients put back
    together; and the norm's input gradient again with `_Reduce` (a
    pass-through backward) in `_Stat`'s place."""
    from repro_torch.launch import tp
    from repro_torch.launch.tp import ModelAxis
    from repro_torch.models import layers as nn
    from repro_torch.rp import shard
    axis = ModelAxis(mesh)
    n, i = axis.size, axis.index
    x, w, c, xn, wn, cn = collective_inputs()

    def block(t, dim):
        per = t.shape[dim] // n
        return t.narrow(dim, i * per, per).clone().requires_grad_(True)
    out = {}
    xr = x.clone().requires_grad_(True)
    wr = block(w, 1)
    mine = (torch.arange(c.shape[1]) % n == i).to(c.dtype)
    loss = (axis.cols(axis.enter(xr, False) @ wr) * c * mine).sum()
    gx, gw = torch.autograd.grad(loss, (xr, wr))
    out["cols"] = {"loss": float(shard.all_reduce(loss.detach().reshape(1),
                                                  axis.group)[0]),
                   "x": gx, "w": shard.all_gather_dim(gw, axis.group, 1)}
    for name, fn in (("stat", tp._Stat), ("pass_through", tp._Reduce)):
        tp_stat, tp._Stat = tp._Stat, fn
        try:
            xb, wb = block(xn, 1), block(wn, 0)
            loss = (nn.rms_norm_split(xb, wb, axis, xn.shape[1])
                    * cn.narrow(1, i * xb.shape[1], xb.shape[1])).sum()
            gx, gw = torch.autograd.grad(loss, (xb, wb))
        finally:
            tp._Stat = tp_stat
        out[name] = {"loss": float(shard.all_reduce(
            loss.detach().reshape(1), axis.group)[0]),
            "x": shard.all_gather_dim(gx, axis.group, 1),
            "w": shard.all_gather_dim(gw, axis.group, 0)}
    return out


def tp_family_scenario(mesh, pl):
    """The SSM, hybrid and encoder-decoder families on a (data, model)
    mesh: `tp_grad_scenario` on the payload's `grad` cases, then per
    `serve` case (the whole params, the prompt, whisper's frames, the fed
    tokens and their positions) at fp32 compute: the mesh prefill step's
    logits, the cache from `init_cache` (whisper's cross K/V from the
    mesh's `encode` through `build_cross_cache`, on the rank's heads)
    taken as the rank's block (`shard_cache`), and after each mesh serve
    step its logits and the whole cache put back together from the
    ranks' blocks (`unshard_tree` by `cache_specs`); the cache's layout
    and the shapes this rank holds."""
    from repro_torch.launch import fsdp, sharding, steps
    from repro_torch.models import from_numpy_params, settings
    from repro_torch.models.config import ShapeSpec
    out = {"grad": tp_grad_scenario(mesh, {"cases": pl["grad"]}),
           "serve": {}}
    f32 = torch.float32
    for case in pl["serve"]:
        model = _tp_model(case)
        cfg = model.cfg
        whole = from_numpy_params(cfg, case["params"], device="cpu")
        params = steps.shard_params(model, whole, mesh)
        tokens = torch.from_numpy(case["tokens"])
        B, S = tokens.shape
        batch = {"tokens": tokens}
        if "frames" in case:
            batch["frames"] = torch.from_numpy(case["frames"])
        pre = steps.build_prefill_step(model, ShapeSpec("p", S, B, "prefill"),
                                       mesh=mesh, compute_dtype=f32)
        logits = pre(params, batch)
        cache = model.init_cache(B, case["max_seq"], f32, device="cpu")
        cspecs = sharding.cache_specs(cfg, cache, mesh)
        cache = steps.shard_cache(model, cache, mesh)
        if cfg.family == "encdec":
            gather = fsdp.Sharded(mesh, sharding.param_specs(
                cfg, model.param_axes(), mesh, model.param_shapes()))
            with torch.inference_mode(), settings.override(mesh=mesh):
                enc = model.mod.encode(cfg, params, batch["frames"],
                                       compute_dtype=f32, gather=gather)
                model.mod.build_cross_cache(cfg, params, enc, cache,
                                            compute_dtype=f32, gather=gather)
        serve = steps.build_serve_step(
            model, ShapeSpec("d", case["max_seq"], B, "decode"), mesh=mesh,
            logits=True, compute_dtype=f32)
        rows = []
        for tok, pos in zip(case["feed"], case["pos"]):
            _, cache, lg = serve(params, cache, torch.from_numpy(tok),
                                 torch.from_numpy(pos))
            rows.append({"logits": lg.clone(), "cache": fsdp.unshard_tree(
                cache, cspecs, mesh)})
        out["serve"][case["name"]] = {
            "prefill": logits.clone(), "steps": rows,
            "layout": steps.cache_layout(model, B, case["max_seq"], mesh),
            "held": {"/".join(k): tuple(v.shape) for k, v in _flat(
                cache).items()}}
    return out


def _steps_case(mesh, pl, case):
    """One train case on the mesh from the case's whole state
    (`shard_state`), once a mode ("compressed": a sketch-mean compressor
    of the payload's sketch; "uncompressed"), fp32 compute, clip 1.0: per
    step the loss, the clip's norm, the whole params, m and v
    (`unshard_state`), this rank's EF, the ledger and `wire_bytes`; the
    shapes this rank holds."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import steps
    from repro_torch.rp import shard
    out = {}
    for mode in case["modes"]:
        compressed = mode == "compressed"
        model, step_fn = _fsdp_step(
            mesh, dict(pl, arch=case["arch"], capacity=case.get("capacity")),
            pl["cfg"] if compressed else None, sync="sketch-mean")
        whole = steps.from_numpy_state(model, case["state"], device="cpu")
        if not compressed:
            whole.pop("ef", None)
        state = steps.shard_state(model, whole, mesh)
        held = [tuple(t.shape) for t in tree_leaves(state["params"])]
        runs = []
        for batch in case["batches"]:
            shard.collective_ledger().reset()
            state, met = step_fn(state, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
            led = shard.collective_ledger().table()
            full = steps.unshard_state(model, state, mesh)
            runs.append({
                "loss": float(met["loss"]),
                "grad_norm": float(met["grad_norm"]),
                "params": [t.clone() for t in tree_leaves(full["params"])],
                "m": [t.clone() for t in tree_leaves(full["opt"]["m"])],
                "v": [t.clone() for t in tree_leaves(full["opt"]["v"])],
                "ef": [t.clone() for t in tree_leaves(state.get("ef", {}))],
                "ledger": led, "wire_bytes": met.get("wire_bytes")})
        out[mode] = {"held": held, "runs": runs}
    return out


def mesh_ckpt_scenario(mesh, pl):
    """The train loop on the mesh (the payload's arch, its sketch with a
    sketch-mean compressor, `fused` for `fused_update=True` and clip
    None, a dense EF) twice from one state: uninterrupted, and with
    checkpoints every step and a crash at `crash_at`, restarted from the
    directory. Returns both final states' leaves (this rank's blocks and
    EF), the whole final state (`unshard_state`), the restart report and
    this rank's blocks of the last checkpoint through `restore(shardings=)`
    (its EF stacked `(npod, ...)` where the mesh has a pod axis). With
    `sketched_dir`, one step more from a fresh state, saved as a sketched
    record of the stacked rows (`for_pod_rows`) and restored: the live EF
    and the restored one. With `respec`, the uninterrupted run's last
    checkpoint restored onto a (1, pod * data, model) mesh of the same
    ranks: its step, whole state and EF."""
    from repro_torch.ckpt import SketchedTreeCodec, checkpointer, \
        resume_pod_rank
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import train_loop
    from repro_torch.runtime.resilience import FaultInjector, \
        run_with_restarts
    carry_ops(pl["ops"])
    fused = pl.get("fused", False)
    model, step_fn = _fsdp_step(mesh, dict(pl, clip=None) if fused else pl,
                                pl["cfg"], sync="sketch-mean",
                                fused_update=fused)
    npod = mesh.shape.get("pod", 1)
    data = SyntheticLM(DataConfig(vocab=256, seq_len=pl["seq"],
                                  global_batch=pl["batch"]))

    def fresh(on=mesh):
        whole = steps.from_numpy_state(model, pl["state"], device="cpu")
        return steps.shard_state(model, whole, on)
    specs = steps.state_specs(model, mesh, fresh())
    total = pl["steps"]

    def loop(ckpt_dir=None, injector=None, steps_=total, codec=None):
        return train_loop.run(
            step_fn, fresh(), data, train_loop.LoopConfig(
                total_steps=steps_, ckpt_dir=ckpt_dir, ckpt_every=1,
                npod=npod, log_every=100, keep_ckpts=1,
                async_ckpt=pl["async"]),
            injector=injector, ef_codec=codec, mesh=mesh, shardings=specs,
            log=lambda *_: None)[0]

    plain = loop(pl["plain_dir"])
    final = {}

    def attempt(injector):
        final["state"] = loop(pl["dir"], injector)
        return total

    report = run_with_restarts(attempt, max_restarts=1,
                               injector=FaultInjector({pl["crash_at"]}))
    example = fresh()
    if npod > 1:
        example["ef"] = tree_map(lambda t: torch.empty(
            (npod,) + tuple(t.shape)), example["ef"])
    restored, _ = checkpointer.restore(
        pl["dir"], example, mesh=mesh, shardings=dict(
            specs, ef=tree_map(lambda t: (None,) * t.ndim, example["ef"])))

    def leaves(state):
        return [t.clone() for t in tree_leaves(state)]
    out = {"coordinate": mesh.coordinate, "plain": leaves(plain),
           "resumed": leaves(final["state"]),
           "whole": leaves(steps.unshard_state(model, plain, mesh)),
           "restored": leaves(restored), "restarts": report.restarts,
           "final_step": report.final_step}
    if pl.get("sketched_dir"):
        codec = SketchedTreeCodec.for_pod_rows(
            SketchConfig(**pl["cfg"]), fresh()["ef"], npod)
        live = loop(pl["sketched_dir"], steps_=1, codec=codec)
        back, step = resume_pod_rank(pl["sketched_dir"], fresh(), mesh,
                                     shardings=specs)
        out["sketched"] = {"live": leaves(live["ef"]), "step": step,
                           "restored": leaves(back["ef"]),
                           "params_equal": all(torch.equal(a, b) for a, b in
                                               zip(tree_leaves(back[
                                                   "params"]), tree_leaves(
                                                   live["params"])))}
    if pl.get("respec"):
        flat = make_mesh((1, mesh.shape["data"] * npod, mesh.shape["model"]),
                         ("pod", "data", "model"), device="cpu",
                         backend="gloo")
        state, step = resume_pod_rank(pl["plain_dir"], fresh(flat), flat,
                                      shardings=steps.state_specs(
                                          model, flat, fresh(flat)))
        out["respec"] = {"step": step, "ef": leaves(state["ef"]),
                         "whole": leaves(steps.unshard_state(model, state,
                                                             flat))}
    return out


def pod_model_scenario(mesh, pl):
    """The (pod, data, model) mesh: `_steps_case` for each of the
    payload's train cases, `tp_serve_scenario` on its serving cases, then
    `mesh_ckpt_scenario` on the payload's `ckpt`."""
    carry_ops(pl["ops"])
    out = {"coordinate": mesh.coordinate,
           "train": {c["name"]: _steps_case(mesh, pl, c)
                     for c in pl["train"]}}
    out["serve"] = tp_serve_scenario(mesh, {"cases": pl["serve"]})
    out["ckpt"] = mesh_ckpt_scenario(mesh, dict(pl, **pl["ckpt"]))
    return out


def cli_resume_scenario(mesh, pl):
    """The train CLI (`train.main`) on this rank's group twice: with
    `--crash-at`, which raises, then the same argv without it, which
    resumes; rank 0's printed lines of both and the first one's error."""
    import contextlib
    import io

    from repro_torch.launch import train
    os.environ["WORLD_SIZE"] = str(dist.get_world_size())
    first = io.StringIO()
    error = None
    with contextlib.redirect_stdout(first):
        try:
            train.main(pl["argv"] + ["--crash-at", str(pl["crash_at"])])
        except RuntimeError as err:
            error = str(err)
    second = io.StringIO()
    with contextlib.redirect_stdout(second):
        train.main(pl["argv"])
    return {"error": error, "first": first.getvalue(),
            "second": second.getvalue()}


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    shape, dtype = tree
    return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")


def dry_ledger_scenario(mesh, pl):
    """One train step of the payload's reduced arch on this mesh from a
    drawn state (the payload's global batch of tokens): the ledger rows
    it records, as `launch/dryrun.py` counts them on a fake mesh."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.rp import shard
    cfg = dataclasses.replace(reduced(get_config(pl["arch"])),
                              **pl.get("cfg", {}))
    model = build_model(cfg)
    B, S = pl["tokens"].shape
    state = steps.shard_state(model, steps.init_train_state(
        model, torch.Generator().manual_seed(0)), mesh)
    step = steps.build_train_step(model, ShapeSpec("t", S, B, "train"),
                                  mesh=mesh)
    tokens = torch.from_numpy(pl["tokens"])
    shard.collective_ledger().reset()
    step(state, {"tokens": tokens, "labels": tokens})
    return [{k: v for k, v in r.items() if k != "host_s"}
            for r in shard.collective_ledger().table()]


def digest_refusal_scenario(mesh, pl):
    """Each pod rank's tree of another shape: the compressor's and
    `gather_pod_rows`' digest agreements must refuse it (the messages)."""
    from repro_torch.optim.compress import (SketchCompressor,
                                            parse_compress_flag)
    from repro_torch.rp import shard
    group = mesh.group("pod")
    tree = {"w": torch.zeros(4 + group.index, 2)}
    out = {}
    comp = SketchCompressor(parse_compress_flag("tt:k=8,dims=2x2x2"),
                            pod_axis="pod", mesh=mesh)
    for name, call in (("compress", lambda: comp._agree_on(tree, group)),
                       ("pod_rows", lambda: shard.gather_pod_rows(tree,
                                                                  mesh))):
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


SCENARIOS = {"shard": shard_scenario, "collective": collective_scenario,
             "train": train_scenario, "resume": resume_scenario,
             "cli": cli_scenario, "pod_ckpt": pod_ckpt_scenario,
             "pod_sigterm": pod_sigterm_scenario,
             "vlm_pod": vlm_pod_scenario, "fsdp": fsdp_scenario,
             "fsdp_ckpt": fsdp_ckpt_scenario,
             "fsdp_fused": fsdp_fused_scenario,
             "pod_data": pod_data_scenario, "tp_grad": tp_grad_scenario,
             "tp_steps": tp_steps_scenario, "tp_serve": tp_serve_scenario,
             "tp_family": tp_family_scenario,
             "tp_collectives": tp_collectives_scenario,
             "mesh_ckpt": mesh_ckpt_scenario,
             "pod_model": pod_model_scenario,
             "cli_resume": cli_resume_scenario,
             "dry_ledger": dry_ledger_scenario,
             "digest_refusal": digest_refusal_scenario}
