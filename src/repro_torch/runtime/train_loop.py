"""The training loop: data by step, the step function, the log lines.

Port of the step loop of `repro/runtime/train_loop.py`. Every batch is a
pure function of (seed, step), so a run is reproducible. Each step runs
under a `train.step` span (`repro_torch.obs`; a no-op when telemetry is
off). Checkpointing, restore, the watchdog with its straggler events,
SIGTERM handling and the resume events wait for their slice (ROADMAP.md,
queue 1 item 10): a `ckpt_dir` raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch import obs
from repro_torch.data import SyntheticLM


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_dir: str | None = None
    log_every: int = 10


def run(step_fn: Callable, state: Any, data: SyntheticLM, cfg: LoopConfig, *,
        log: Callable[[str], None] = print,
        on_metrics: Callable[..., None] | None = None) -> tuple[Any, int]:
    """Runs step_fn(state, batch) -> (state, metrics) for steps
    0..total_steps-1; logs the 0-d metrics every `log_every` steps and at
    the last. `on_metrics(step, metrics, state)` receives the post-step
    state. Returns (final_state, final_step)."""
    if cfg.ckpt_dir:
        raise NotImplementedError(
            "checkpointing is not ported yet (ROADMAP.md, queue 1 item 10); "
            "run without ckpt_dir")
    t_start = time.time()
    step = 0
    for step in range(cfg.total_steps):
        with obs.span("train.step", step=step):
            state, metrics = step_fn(state, data.batch(step))
        if on_metrics is not None:
            on_metrics(step, metrics, state)
        if step % cfg.log_every == 0 or step == cfg.total_steps - 1:
            scal = {k: float(v) for k, v in metrics.items()
                    if isinstance(v, (float, int)) or (
                        isinstance(v, torch.Tensor) and v.ndim == 0)}
            log(f"step {step:6d} " + " ".join(
                f"{k}={v:.5g}" for k, v in sorted(scal.items())))
    dt = time.time() - t_start
    log(f"[done] steps 0..{step} in {dt:.1f}s")
    return state, step + 1


__all__ = ["LoopConfig", "run"]
