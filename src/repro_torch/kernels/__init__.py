"""repro_torch.kernels — hand-written CUDA mode-sweep kernels for Hopper.

K1 `sweep_project` and K2 `sweep_reconstruct` (`_sweep.py`, sources in
`csrc/`) replace the Pallas TPU kernels of `repro/kernels/_sweep.py`;
`ops.py` holds the contraction planner (the reference's einsum programs,
tiles re-budgeted for shared memory) and the public wrappers; `ref.py`
the einsum oracles. Nothing here builds or loads a kernel at import time.
"""
from . import ref
from .ops import (MAX_ORDER, ContractionPlan, cp_project, cp_reconstruct,
                  kernel_order_supported, plan_contraction, program_codes,
                  sweep_hbm_bytes, tt_cores_squeezed, tt_project,
                  tt_reconstruct)

__all__ = ["MAX_ORDER", "ContractionPlan", "cp_project", "cp_reconstruct",
           "kernel_order_supported", "plan_contraction", "program_codes",
           "ref", "sweep_hbm_bytes", "tt_cores_squeezed", "tt_project",
           "tt_reconstruct"]
