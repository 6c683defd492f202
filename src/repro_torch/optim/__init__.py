"""repro_torch.optim — AdamW (unfused and fused with the unsketch, K4),
LR schedules and the sketch compressor (port of `repro.optim`)."""
from . import adamw, schedule
from .adamw import AdamWConfig

__all__ = ["AdamWConfig", "adamw", "schedule"]
