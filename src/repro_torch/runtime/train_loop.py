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

On a mesh (`mesh=`, one process a rank) with a 'pod' axis each rank
holds its own pod's EF row, the same bits on every rank of a pod. A save
gathers the rows into the reference's `(npod, ...)` layout on rank 0
(`rp.shard.gather_pod_rows` over rank 0's pod group alone, the ranks at
(data, model) coordinate 0, on the step thread); rank 0 alone writes
(the params and optimizer state are the same bits on every pod), alone
encodes a sketched record of the stacked rows and alone runs an
`AsyncCheckpointer`. A restore reads the same directory on every rank
(`ckpt.elastic.resume_pod_rank`: the rows respecced to the mesh's pod
count, a sketched record decoded whole, this rank's row kept), after the
ranks have met, so that none lists the directory while rank 0 still
drains a save that a crash cut short; `run` returns on no rank before
rank 0's last save is on disk. A SIGTERM reaches one rank: the ranks
agree on the flag every step (one MAX all_reduce over the mesh), so they
save and stop at the same step instead of one rank waiting in a gather
that the others never join.

On a mesh whose data or model axis is above 1 (`shardings=` the state's
specs, `launch.steps.state_specs`) each rank holds its blocks of params,
m and v. A save gathers the blocks onto rank 0 (`launch.fsdp.gather_tree`,
one gather a sharded leaf, a two-dim block's model dim first), which
writes whole leaves in the reference's format; without a pod axis the EF
is whole on every rank and a sketched record is encoded by every rank
(the codec splits the buckets over the mesh). A restore reads each
rank's blocks alone (`checkpointer.restore(shardings=)`). With a pod axis
too (pod x data, or the reference's (pod, data, model)) both hold: the
rows' gather, then the blocks'; at a restore `resume_pod_rank(shardings=)`
reads this rank's blocks beside its pod's row. The SIGTERM, resume and
done meetings are the same on every mesh.
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
    On a mesh every rank joins the gathers: on a pod mesh rank 0's pod
    group gathers the EF rows, then with `shardings` every rank joins the
    gather of the blocks; only rank 0 gets a tree (None elsewhere)."""
    extra: dict = {}
    writer = mesh is None or mesh.rank == 0
    pods = mesh is not None and mesh.shape.get("pod", 1) > 1
    ef = state.get("ef")
    if ef is not None and pods:
        # the ranks of a pod hold the same residual bits (each syncs its
        # pod's whole mean gradient), so rank 0's pod group, the ranks at
        # (data, model) coordinate 0, alone gathers the rows
        first = all(mesh.coordinate[a] == 0 for a in mesh.axis_names
                    if a != "pod")
        from repro_torch.rp.shard import gather_pod_rows
        ef = gather_pod_rows(ef, mesh) if first else None
    if ef is not None and ef_codec is not None and (writer or not pods):
        # the stacked rows are encoded on rank 0; off a pod mesh every
        # rank encodes (the codec splits the buckets over the mesh)
        ef = ef_codec.encode(ef, step=step)
        extra["sketched_ef"] = ef_codec.meta()
    tree = {k: v for k, v in state.items() if k != "ef"}
    if shardings is not None:
        from repro_torch.launch.fsdp import gather_tree
        tree = gather_tree(tree, {k: v for k, v in shardings.items()
                                  if k != "ef"}, mesh)
    if not writer:
        return None, extra
    if "ef" in state:
        tree["ef"] = ef
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
    loop on every rank of it: with a 'pod' axis each rank passes its own
    pod's EF row, `ef_codec` is the stacked tree's
    (`SketchedTreeCodec.for_pod_rows`) and encodes on rank 0, and a
    restore goes through `ckpt.resume_pod_rank`: it always verifies,
    reads a sketched record's codec from the manifest, and takes a
    checkpoint of another pod count. On a mesh whose data or model axis
    is above 1 `shardings` (the state's specs) is required: `state` holds
    this rank's blocks, a save writes the whole leaves and a restore
    reads the rank's blocks (see the module docstring).
    """
    pods = mesh is not None and "pod" in mesh.axis_names
    blocks = mesh is not None and (mesh.shape.get("data", 1) > 1
                                   or mesh.shape.get("model", 1) > 1)
    if blocks and shardings is None:
        raise ValueError("run(mesh=) on a data mesh needs shardings=, the "
                         "state's specs (launch.steps.state_specs)")
    if not blocks:
        shardings = None
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
            state, start = resume_pod_rank(cfg.ckpt_dir, state, mesh,
                                           shardings=shardings)
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
