"""LR schedules (pure functions of the step counter).

Port of `repro/optim/schedule.py`: the step may be a float, an int or a
0-d tensor; a tensor step gives a float32 0-d tensor on its device.
"""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(step, *, peak_lr: float, warmup_steps: int,
                       total_steps: int, final_frac: float = 0.1):
    if isinstance(step, torch.Tensor):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(1, warmup_steps)
        prog = torch.clamp((step - warmup_steps)
                           / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = final_frac * peak_lr + (1 - final_frac) * peak_lr * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, cos)
    step = float(step)
    if step < warmup_steps:
        return peak_lr * step / max(1, warmup_steps)
    prog = min(max((step - warmup_steps)
                   / max(1, total_steps - warmup_steps), 0.0), 1.0)
    return final_frac * peak_lr + (1 - final_frac) * peak_lr * 0.5 * (
        1 + math.cos(math.pi * prog))


def constant(step, *, peak_lr: float, **_):
    del step
    return peak_lr


__all__ = ["constant", "cosine_with_warmup"]
