"""Device resolution shared by the port's entry points.

`device=None` means the CUDA device. Asking for it where CUDA is not
available raises instead of silently running on the CPU: a caller that
wants the CPU says so with `device="cpu"`.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> `cuda`; raises if the requested CUDA device is missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} needs CUDA, which is not available here; "
            "pass device='cpu' to run on the CPU")
    return dev
