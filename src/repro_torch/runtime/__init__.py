"""repro_torch.runtime — the fault-tolerant training loop (port of
`repro.runtime`): `train_loop` (checkpoints, resume with fallback, the
watchdog, SIGTERM-safe shutdown) and `resilience` (the watchdog, retry
and backoff, injectable I/O faults, the restart supervisor)."""
from .train_loop import LoopConfig, run

__all__ = ["LoopConfig", "run"]
