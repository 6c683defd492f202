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
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch import obs
from repro_torch.ckpt import checkpointer
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


def _to_save(state: Any, step: int, ef_codec) -> tuple[Any, dict]:
    """(tree to write, manifest extra) — EF leaves go as sketch records."""
    extra: dict = {}
    tree = state
    if ef_codec is not None and "ef" in state:
        tree = dict(state)
        tree["ef"] = ef_codec.encode(state["ef"], step=step)
        extra["sketched_ef"] = ef_codec.meta()
    return tree, extra


def _wait_for(loss) -> None:
    """Block until the step's queued device work is done."""
    if isinstance(loss, torch.Tensor) and loss.device.type == "cuda":
        torch.cuda.current_stream(loss.device).synchronize()


def run(step_fn: Callable, state: Any, data: SyntheticLM, cfg: LoopConfig, *,
        injector: FaultInjector | None = None,
        log: Callable[[str], None] = print,
        on_metrics: Callable[..., None] | None = None,
        ef_codec=None) -> tuple[Any, int]:
    """Runs step_fn(state, batch) -> (state, metrics) until total_steps.

    Resumes from the newest VERIFIED checkpoint in cfg.ckpt_dir if one
    exists (a corrupt newest one falls back to the previous verified
    checkpoint); restored tensors land on the devices of `state`'s
    leaves. `ef_codec` (a `repro_torch.ckpt.SketchedTreeCodec` over
    state["ef"]) persists the error-feedback tree as a (seed, spec,
    sketch) record and reconstructs it deterministically on restore.
    `on_metrics(step, metrics, state)` receives the post-step state.
    Returns (final_state, final_step). Checkpoints of a pod mesh
    (`cfg.npod > 1`: each rank holds its own pod's EF row) wait for
    ROADMAP.md queue 1 item 11.1 and are refused.
    """
    if cfg.ckpt_dir and cfg.npod > 1:
        raise NotImplementedError(
            f"checkpoints on a mesh of {cfg.npod} pods need each rank's EF "
            "row gathered into the (npod, ...) layout and handed back on "
            "restore (ROADMAP.md, queue 1 item 11.1); run without ckpt_dir "
            "or on one pod")
    start = 0
    if cfg.ckpt_dir:
        latest = checkpointer.latest_step(cfg.ckpt_dir)
        if latest is not None:
            example = state
            if ef_codec is not None and "ef" in state:
                example = dict(state)
                example["ef"] = ef_codec.record_shapes()
            restored, start = checkpointer.restore(
                cfg.ckpt_dir, example,
                verify_integrity=cfg.verify_restore, fallback=True)
            if ef_codec is not None and "ef" in state:
                restored["ef"] = ef_codec.decode(restored["ef"])
            state = restored
            if start != latest:
                log(f"[resume] newest checkpoint (step {latest}) failed "
                    f"verification; fell back to verified step {start}")
                obs.event("ckpt.fallback", step_requested=latest,
                          step_restored=start, dir=str(cfg.ckpt_dir))
            log(f"[resume] restored step {start} from {cfg.ckpt_dir}")
            obs.event("ckpt.resume", step=start, dir=str(cfg.ckpt_dir))
    ck = (checkpointer.AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep_ckpts)
          if (cfg.ckpt_dir and cfg.async_ckpt) else None)
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
            want_ckpt = cfg.ckpt_dir and (
                (step + 1) % cfg.ckpt_every == 0
                or step == cfg.total_steps - 1 or shutdown.requested)
            if want_ckpt:
                tree, extra = _to_save(state, step + 1, ef_codec)
                extra["npod"] = cfg.npod
                if ck is not None:
                    ck.save(step + 1, tree, extra=extra)
                else:
                    checkpointer.save(cfg.ckpt_dir, step + 1, tree,
                                      keep=cfg.keep_ckpts, extra=extra)
            if shutdown.requested:
                log(f"[shutdown] SIGTERM honored at step {step}")
                break
    dt = time.time() - t_start
    log(f"[done] steps {start}..{step} in {dt:.1f}s "
        f"({len(wd.events)} straggler events)")
    return state, step + 1


__all__ = ["LoopConfig", "run"]
