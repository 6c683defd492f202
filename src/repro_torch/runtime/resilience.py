"""Fault-tolerance runtime: the watchdog (stragglers), signal-triggered
checkpointing, retry/backoff, injectable I/O faults, and a crash-restart
supervisor.

Port of `repro/runtime/resilience.py`, which imports no JAX; the port
keeps its own copy so that it never imports the reference package. The
failure model: slow steps (stragglers), preemption, hard crashes, and
storage faults (torn writes, bit flips, failed renames, slow disks).

  * Watchdog — EMA + z-score over step wall times; a step scored against
    the PRE-update statistics above `z_thresh` is a straggler event.
  * GracefulShutdown — SIGTERM/SIGINT set a flag the loop checks once a
    step: it finishes the step, checkpoints and exits.
  * retry_with_backoff — capped exponential backoff around a transient
    (by default OSError) operation; the checkpointer wraps every array
    write and the atomic rename in it.
  * CheckpointIO / IOFaultInjector — the checkpointer's I/O surface as an
    injectable object: transient write and rename failures (retried),
    slow writes, truncated arrays, flipped bytes and a corrupted manifest
    (caught by the checksums on restore, which falls back to the newest
    verified checkpoint).
  * run_with_restarts — reruns a training function after RETRYABLE
    crashes with capped exponential backoff, up to a budget; FATAL ones
    (by default ValueError/TypeError: misconfiguration, corruption with
    no fallback) stop it at once. The function gets a FaultInjector so a
    test can kill a chosen step.
"""
from __future__ import annotations

import dataclasses
import pathlib
import signal
import time
from typing import Callable

import numpy as np


@dataclasses.dataclass
class WatchdogEvent:
    step: int
    dt: float
    ema: float
    zscore: float


class Watchdog:
    """EMA + z-score straggler detector over per-step wall times.

    `start_step()` / `end_step(step)` bracket each training step; after
    `warmup` steps, a step whose duration sits more than `z_thresh` standard
    deviations above the EMA is recorded as a `WatchdogEvent` (and passed to
    `on_straggler` when set).
    """

    def __init__(self, *, warmup: int = 5, z_thresh: float = 4.0,
                 on_straggler: Callable[[WatchdogEvent], None] | None = None):
        self.warmup = warmup
        self.z_thresh = z_thresh
        self.on_straggler = on_straggler
        self.ema = None
        self.var = 0.0
        self.n = 0
        self.events: list[WatchdogEvent] = []
        self._last = None

    def start_step(self) -> None:
        self._last = time.monotonic()

    def end_step(self, step: int) -> WatchdogEvent | None:
        if self._last is None:
            raise ValueError("Watchdog.end_step called without start_step")
        dt = time.monotonic() - self._last
        self.n += 1
        if self.ema is None:
            self.ema = dt
            return None
        alpha = 0.1
        dev = dt - self.ema
        # score against the PRE-update statistics: folding the sample into
        # the variance first bounds z at 1/sqrt((1-alpha)*alpha) ~ 3.33,
        # i.e. the spike inflates the very baseline it is measured against
        # and a z_thresh of 4 can never fire
        sd = max(self.var ** 0.5, 1e-9)
        z = dev / sd
        self.var = (1 - alpha) * (self.var + alpha * dev * dev)
        self.ema += alpha * dev
        if self.n > self.warmup and z > self.z_thresh:
            ev = WatchdogEvent(step=step, dt=dt, ema=self.ema, zscore=z)
            self.events.append(ev)
            if self.on_straggler:
                self.on_straggler(ev)
            return ev
        return None


class GracefulShutdown:
    """Context manager: converts SIGTERM/SIGINT into a `requested` flag the
    training loop checks once per step (preemption-safe: the loop finishes
    the current step, checkpoints, and exits cleanly)."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = signals
        self.requested = False
        self._old = {}

    def _handler(self, signum, frame):
        del frame
        self.requested = True

    def __enter__(self):
        for s in self.signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._old.items():
            signal.signal(s, h)
        return False


# ---------------------------------------------------------------------------
# Retry / backoff
# ---------------------------------------------------------------------------

def backoff_delays(retries: int, *, base_delay: float = 0.05,
                   max_delay: float = 2.0) -> list[float]:
    """The capped exponential schedule retry_with_backoff sleeps through."""
    return [min(max_delay, base_delay * (2.0 ** i)) for i in range(retries)]


def retry_with_backoff(fn: Callable, *, retries: int = 3,
                       base_delay: float = 0.05, max_delay: float = 2.0,
                       retryable: tuple = (OSError,),
                       sleep: Callable[[float], None] = time.sleep,
                       on_retry: Callable | None = None):
    """Run `fn()`, retrying `retryable` exceptions with capped exponential
    backoff. Non-retryable exceptions propagate immediately; the last
    retryable one propagates after the budget is spent.

    `sleep` is injectable so tests assert the schedule without waiting it
    out; `on_retry(attempt, delay, exc)` observes each retry.
    """
    attempt = 0
    while True:
        try:
            return fn()
        except retryable as e:
            attempt += 1
            if attempt > retries:
                raise
            delay = min(max_delay, base_delay * (2.0 ** (attempt - 1)))
            if on_retry is not None:
                on_retry(attempt, delay, e)
            sleep(delay)


# ---------------------------------------------------------------------------
# Injectable checkpoint I/O
# ---------------------------------------------------------------------------

class CheckpointIO:
    """The checkpointer's storage surface: array writes, the atomic rename,
    and a post-commit hook. Subclass to inject faults (IOFaultInjector) or
    to retarget storage (object stores, TensorStore) without touching the
    save logic."""

    def write_array(self, path, arr) -> None:
        np.save(path, arr)

    def rename(self, src, dst) -> None:
        pathlib.Path(src).rename(dst)

    def post_commit(self, final_dir) -> None:
        """Called once after the atomic rename lands; no-op by default."""


@dataclasses.dataclass
class IOFaultPlan:
    """Deterministic storage-fault schedule for IOFaultInjector.

    fail_writes      : first N write_array calls raise OSError (transient —
                       the checkpointer's retry loop should absorb them).
    fail_renames     : first N rename calls raise OSError.
    slow_write_s     : sleep this long before every write (straggler I/O).
    truncate_file    : after writing this file NAME, truncate it to
                       `truncate_to` bytes (a torn write: the crc32 catches
                       it on verify and restore falls back).
    flip_byte_in     : after writing this file NAME, XOR one byte at
                       `flip_offset` (negative = from end).
    corrupt_manifest : after the atomic rename, flip one byte inside the
                       committed manifest.json (the sha256 catches it).
    """

    fail_writes: int = 0
    fail_renames: int = 0
    slow_write_s: float = 0.0
    truncate_file: str | None = None
    truncate_to: int = 32
    flip_byte_in: str | None = None
    flip_offset: int = -1
    corrupt_manifest: bool = False


def flip_byte(path, offset: int = -1) -> None:
    """XOR one byte of `path` in place (deterministic bit-flip injection)."""
    path = pathlib.Path(path)
    blob = bytearray(path.read_bytes())
    blob[offset] ^= 0xFF
    path.write_bytes(bytes(blob))


class IOFaultInjector(CheckpointIO):
    """CheckpointIO that executes an IOFaultPlan. Each fault class fires the
    scheduled number of times and then behaves like the real IO, so a save
    under `fail_writes=2, retries>=2` succeeds after backoff while
    `fail_writes=retries+1` exhausts the budget and surfaces the OSError."""

    def __init__(self, plan: IOFaultPlan | None = None, **kw):
        self.plan = plan if plan is not None else IOFaultPlan(**kw)
        self.writes = 0
        self.renames = 0
        self.injected: list[str] = []

    def write_array(self, path, arr) -> None:
        if self.plan.slow_write_s:
            time.sleep(self.plan.slow_write_s)
        self.writes += 1
        if self.writes <= self.plan.fail_writes:
            self.injected.append(f"write-fail:{pathlib.Path(path).name}")
            raise OSError(f"injected transient write failure #{self.writes}")
        super().write_array(path, arr)
        name = pathlib.Path(path).name
        if self.plan.truncate_file == name:
            with open(path, "r+b") as f:
                f.truncate(self.plan.truncate_to)
            self.injected.append(f"truncate:{name}")
        if self.plan.flip_byte_in == name:
            flip_byte(path, self.plan.flip_offset)
            self.injected.append(f"flip:{name}")

    def rename(self, src, dst) -> None:
        self.renames += 1
        if self.renames <= self.plan.fail_renames:
            self.injected.append(f"rename-fail:{pathlib.Path(dst).name}")
            raise OSError(f"injected rename failure #{self.renames}")
        super().rename(src, dst)

    def post_commit(self, final_dir) -> None:
        if self.plan.corrupt_manifest:
            flip_byte(pathlib.Path(final_dir) / "manifest.json")
            self.injected.append("flip:manifest.json")
            self.plan = dataclasses.replace(self.plan, corrupt_manifest=False)


# ---------------------------------------------------------------------------
# Crash injection + restart supervisor
# ---------------------------------------------------------------------------

class FaultInjector:
    """Deterministic crash injection for restart tests: raises once per
    scheduled step (`maybe_crash` is called at the top of every training
    step), so a supervised run crashes exactly where the test plants it."""

    def __init__(self, crash_at_steps: set[int] | None = None):
        self.crash_at_steps = set(crash_at_steps or ())
        self.fired: set[int] = set()

    def maybe_crash(self, step: int) -> None:
        if step in self.crash_at_steps and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected fault at step {step}")


@dataclasses.dataclass
class RestartReport:
    restarts: int
    completed: bool
    final_step: int
    history: list
    fatal_error: str | None = None


# Failures a restart cannot fix: misconfiguration, shape drift, corruption
# with no verified fallback (ckpt.CheckpointError subclasses ValueError).
FATAL_DEFAULT = (ValueError, TypeError)


def run_with_restarts(train_fn: Callable[..., int], *, max_restarts: int = 3,
                      injector: FaultInjector | None = None,
                      fatal: tuple = FATAL_DEFAULT,
                      base_delay: float = 0.0, max_delay: float = 30.0,
                      sleep: Callable[[float], None] = time.sleep
                      ) -> RestartReport:
    """Supervise `train_fn(injector) -> final step`, restarting after crashes.

    The training fn must checkpoint internally and resume from its own
    latest checkpoint when re-invoked. The supervisor distinguishes
    RETRYABLE failures (everything outside `fatal`; restarted with capped
    exponential backoff — `base_delay * 2^attempt`, capped at `max_delay`)
    from FATAL ones (`fatal` classes: the report carries `fatal_error` and
    no restart is attempted — a ValueError from a changed tree structure or
    an unrecoverable checkpoint re-raises identically forever). `base_delay`
    defaults to 0 so tests don't sleep; production supervisors pass e.g.
    `base_delay=1.0`.
    """
    injector = injector or FaultInjector()
    history = []
    restarts = 0
    while True:
        try:
            final = train_fn(injector)
            return RestartReport(restarts=restarts, completed=True,
                                 final_step=final, history=history)
        except fatal as e:
            history.append(repr(e))
            return RestartReport(restarts=restarts, completed=False,
                                 final_step=-1, history=history,
                                 fatal_error=repr(e))
        except Exception as e:  # noqa: BLE001 — supervisor boundary
            history.append(repr(e))
            restarts += 1
            if restarts > max_restarts:
                return RestartReport(restarts=restarts, completed=False,
                                     final_step=-1, history=history)
            if base_delay > 0:
                sleep(min(max_delay, base_delay * (2.0 ** (restarts - 1))))


__all__ = ["CheckpointIO", "FATAL_DEFAULT", "FaultInjector",
           "GracefulShutdown", "IOFaultInjector", "IOFaultPlan",
           "RestartReport", "Watchdog", "WatchdogEvent", "backoff_delays",
           "flip_byte", "retry_with_backoff", "run_with_restarts"]
