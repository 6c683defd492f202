"""Fault-tolerant training loop: data by step, verified async checkpoints
(with fallback to the newest checkpoint that passes its integrity check),
sketched error-feedback records, the watchdog, SIGTERM-safe shutdown.

Port of `repro/runtime/train_loop.py`. Every batch is a pure function of
(seed, step), so a resumed run fast-forwards by starting at the restored
step. Each step runs under a `train.step` span; a straggler, a resume and
a fallback are `repro_torch.obs` events beside their log lines (all
no-ops when telemetry is off). The watchdog's step time includes the
device work: the loop waits for the step's queued kernels (the loss's
stream) before the clock stops.

A crash while an async save is in flight drains that save before the
exception leaves `run` (what the reference's `AsyncCheckpointer.__exit__`
does on a crash): otherwise the restarted attempt's checkpointer would
sweep the live tmp directory away and find no checkpoint.

On a mesh (`mesh=`, one process a rank) each rank holds its own pod's EF
row. A save gathers the rows into the reference's `(npod, ...)` layout
on rank 0 (`rp.shard.gather_pod_rows`, every rank on the step thread);
rank 0 alone writes (the params and optimizer state are the same bits on
every pod) and alone runs an `AsyncCheckpointer`. A restore reads the
same directory on every rank (`ckpt.elastic.resume_pod_rank`), after
the ranks have met, so that none lists the directory while rank 0 still
drains a save that a crash cut short; `run` returns on no rank before
rank 0's last save is on disk. A SIGTERM reaches one rank: the ranks
agree on the flag every step (one MAX all_reduce over the mesh), so they
save and stop at the same step instead of one rank waiting in a gather
that the others never join.

On a data mesh (FSDP, `shardings=` the state's specs,
`launch.steps.state_specs`) each rank holds its blocks of params, m and
v. A save gathers the blocks onto rank 0 (`launch.fsdp.gather_tree`, one
gather a sharded leaf), which writes whole leaves in the reference's
format; a sketched EF record is encoded by every rank (the codec splits
the buckets over the mesh), written by rank 0. A restore reads each
rank's block alone (`checkpointer.restore(shardings=)`), after the same
meeting as on a pod mesh. The SIGTERM, resume and done meetings are the
pod mesh's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.ckpt import checkpointer
from repro_torch.ckpt.elastic import resume_pod_rank
from repro_torch.data import SyntheticLM

from .resilience import FaultInjector, GracefulShutdown, Watchdog


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    log_every: int = 10
    keep_ckpts: int = 3
    async_ckpt: bool = True
    # the mesh's pod count (1 without a pod axis), recorded in every
    # manifest's `extra` so `ckpt.resume_elastic` knows the pod count the
    # EF state was written with
    npod: int = 1
    # corruption handling on resume: verify checksums and fall back to the
    # newest checkpoint that passes (False restores blind)
    verify_restore: bool = True


def _to_save(state: Any, step: int, ef_codec, mesh,
             shardings=None) -> tuple[Any, dict]:
    """(tree to write, manifest extra) — EF leaves go as sketch records.
    On a pod mesh every rank joins the gather of the EF rows, on a data
    mesh the gather of the blocks (and the record's encode); only rank 0
    gets a tree (None elsewhere)."""
    extra: dict = {}
    if shardings is not None:
        from repro_torch.launch.fsdp import gather_tree
        record = (ef_codec.encode(state["ef"], step=step)
                  if ef_codec is not None and "ef" in state else None)
        if record is not None:
            extra["sketched_ef"] = ef_codec.meta()
            state = {k: v for k, v in state.items() if k != "ef"}
            shardings = {k: v for k, v in shardings.items() if k != "ef"}
        tree = gather_tree(state, shardings, mesh)
        if tree is not None and record is not None:
            tree["ef"] = record
        return tree, extra
    if "ef" not in state:
        return (state if mesh is None or mesh.rank == 0 else None), extra
    tree = dict(state)
    if mesh is not None and mesh.shape.get("pod", 1) > 1:
        from repro_torch.rp.shard import gather_pod_rows
        tree["ef"] = gather_pod_rows(state["ef"], mesh)
    if mesh is not None and mesh.rank != 0:
        return None, extra
    if ef_codec is not None:
        tree["ef"] = ef_codec.encode(tree["ef"], step=step)
        extra["sketched_ef"] = ef_codec.meta()
    return tree, extra


def _agree(value: int, mesh, tag: str) -> int:
    """The largest `value` over the mesh's ranks (a MAX all_reduce of one
    int64); every rank waits here for the others."""
    if mesh is None or dist.get_world_size() == 1:
        return value
    from repro_torch.rp import shard
    t = torch.tensor([value], dtype=torch.int64, device=mesh.device)
    return int(shard.all_reduce(t, mesh.group(mesh.axis_names), op="max",
                                tag=tag)[0])


def _wait_for(loss) -> None:
    """Block until the step's queued device work is done."""
    if isinstance(loss, torch.Tensor) and loss.device.type == "cuda":
        torch.cuda.current_stream(loss.device).synchronize()


def run(step_fn: Callable, state: Any, data: SyntheticLM, cfg: LoopConfig, *,
        injector: FaultInjector | None = None,
        log: Callable[[str], None] = print,
        on_metrics: Callable[..., None] | None = None,
        ef_codec=None, mesh=None, shardings=None) -> tuple[Any, int]:
    """Runs step_fn(state, batch) -> (state, metrics) until total_steps.

    Resumes from the newest VERIFIED checkpoint in cfg.ckpt_dir if one
    exists (a corrupt newest one falls back to the previous verified
    checkpoint); restored tensors land on the devices of `state`'s
    leaves. `ef_codec` (a `repro_torch.ckpt.SketchedTreeCodec` over
    state["ef"]) persists the error-feedback tree as a (seed, spec,
    sketch) record and reconstructs it deterministically on restore.
    `on_metrics(step, metrics, state)` receives the post-step state.
    Returns (final_state, final_step).

    `mesh` (a `launch.mesh.Mesh`; needed when `cfg.npod > 1`) runs the
    loop on every rank of it: each rank passes its own pod's EF row,
    `ef_codec` is the stacked tree's (`SketchedTreeCodec.for_pod_rows`)
    and encodes on rank 0. With a 'pod' axis a restore goes through
    `ckpt.resume_pod_rank`: it always verifies, reads a sketched record's
    codec from the manifest, and takes a checkpoint of another pod count.
    On a data mesh `shardings` (the state's specs) is required: `state`
    holds this rank's blocks, a save writes the whole leaves and a restore
    reads the rank's blocks (see the module docstring).
    """
    pods = mesh is not None and "pod" in mesh.axis_names
    model = mesh is not None and mesh.shape.get("model", 1) > 1
    blocks = mesh is not None and (mesh.shape.get("data", 1) > 1 or model)
    if blocks and shardings is None:
        raise ValueError("run(mesh=) on a data mesh needs shardings=, the "
                         "state's specs (launch.steps.state_specs)")
    if not blocks:
        shardings = None
    if (model or pods and blocks) and cfg.ckpt_dir:
        raise NotImplementedError(
            "checkpoints of a pod x data mesh (each rank's pod residual "
            "beside the data blocks) and of a mesh with a model axis are "
            "item 12.7b.4 (ROADMAP.md, queue 1); run it without ckpt_dir, "
            "or checkpoint a (data, 1) or (pod, 1, 1) mesh")
    if cfg.npod > 1 and not (pods and mesh.shape["pod"] == cfg.npod):
        raise ValueError(
            f"LoopConfig(npod={cfg.npod}) needs the mesh= whose 'pod' axis "
            f"holds the {cfg.npod} pods, got {mesh!r}")
    writer = mesh is None or mesh.rank == 0
    start = 0
    if cfg.ckpt_dir:
        latest = checkpointer.latest_step(cfg.ckpt_dir)
        if pods or blocks:  # after rank 0 drained a save a crash cut short
            latest = _agree(-1 if latest is None else latest, mesh,
                            "resume")
            latest = None if latest < 0 else latest
        if latest is not None and pods:
            state, start = resume_pod_rank(cfg.ckpt_dir, state, mesh)
        elif latest is not None:
            example, specs = state, shardings
            if ef_codec is not None and "ef" in state:
                example = dict(state)
                example["ef"] = ef_codec.record_shapes()
                if specs is not None:   # the record is whole on every rank
                    specs = dict(specs)
                    specs["ef"] = {k: (None,) * t.ndim
                                   for k, t in example["ef"].items()}
            restored, start = checkpointer.restore(
                cfg.ckpt_dir, example, shardings=specs, mesh=mesh,
                verify_integrity=cfg.verify_restore, fallback=True)
            if ef_codec is not None and "ef" in state:
                restored["ef"] = ef_codec.decode(restored["ef"])
            state = restored
        if latest is not None:
            if start != latest:
                log(f"[resume] newest checkpoint (step {latest}) failed "
                    f"verification; fell back to verified step {start}")
                obs.event("ckpt.fallback", step_requested=latest,
                          step_restored=start, dir=str(cfg.ckpt_dir))
            log(f"[resume] restored step {start} from {cfg.ckpt_dir}")
            obs.event("ckpt.resume", step=start, dir=str(cfg.ckpt_dir))
    ck = (checkpointer.AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep_ckpts)
          if (cfg.ckpt_dir and cfg.async_ckpt and writer) else None)
    wd = Watchdog()
    t_start = time.time()
    step = start
    # the checkpointer's __exit__ drains an in-flight save on a crash and
    # keeps the exception; on a clean exit it closes (and raises a
    # background failure)
    with ck if ck is not None else contextlib.nullcontext(), \
            GracefulShutdown() as shutdown:
        for step in range(start, cfg.total_steps):
            if injector is not None:
                injector.maybe_crash(step)
            with obs.span("train.step", step=step):
                wd.start_step()
                state, metrics = step_fn(state, data.batch(step))
                _wait_for(metrics["loss"])
                ev = wd.end_step(step)
            if ev is not None:
                log(f"[straggler] step {step}: {ev.dt:.3f}s "
                    f"(ema {ev.ema:.3f}s, z={ev.zscore:.1f})")
                # the log string stays (operators grep for it); the event
                # is the machine-readable copy
                obs.event("train.straggler", step=step, dt=ev.dt,
                          ema=ev.ema, zscore=ev.zscore)
            if on_metrics is not None:
                on_metrics(step, metrics, state)
            if step % cfg.log_every == 0 or step == cfg.total_steps - 1:
                scal = {k: float(v) for k, v in metrics.items()
                        if isinstance(v, (float, int)) or (
                            isinstance(v, torch.Tensor) and v.ndim == 0)}
                log(f"step {step:6d} " + " ".join(
                    f"{k}={v:.5g}" for k, v in sorted(scal.items())))
            stop = bool(_agree(int(shutdown.requested), mesh, "shutdown"))
            want_ckpt = cfg.ckpt_dir and (
                (step + 1) % cfg.ckpt_every == 0
                or step == cfg.total_steps - 1 or stop)
            if want_ckpt:
                tree, extra = _to_save(state, step + 1, ef_codec, mesh,
                                       shardings)
                extra["npod"] = cfg.npod
                if ck is not None:
                    ck.save(step + 1, tree, extra=extra)
                elif writer:
                    checkpointer.save(cfg.ckpt_dir, step + 1, tree,
                                      keep=cfg.keep_ckpts, extra=extra)
            if stop:
                log(f"[shutdown] SIGTERM honored at step {step}")
                break
    # no rank returns before rank 0's last checkpoint is on disk
    _agree(0, mesh, "done")
    dt = time.time() - t_start
    log(f"[done] steps {start}..{step} in {dt:.1f}s "
        f"({len(wd.events)} straggler events)")
    return state, step + 1


__all__ = ["LoopConfig", "run"]
