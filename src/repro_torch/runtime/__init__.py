"""repro_torch.runtime — the training loop (port of `repro.runtime`'s
step loop; checkpointing and fault tolerance wait for ROADMAP.md queue 1
item 10)."""
from .train_loop import LoopConfig, run

__all__ = ["LoopConfig", "run"]
