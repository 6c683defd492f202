"""repro_torch.kernels — hand-written CUDA kernels for Hopper.

K1 `sweep_project`, K5 `sweep_project_pipelined` and K2
`sweep_reconstruct` (`_sweep.py`, sources in `csrc/`) replace the Pallas
TPU kernels of `repro/kernels/_sweep.py`; K3 `carry_sweep_project` and K6
`carry_sweep_project_pipelined` (`struct/`) those of
`repro/kernels/struct/carry.py`; K4 `fused_update_buckets`
(`fused_update.py`) that of `repro/kernels/fused_update.py`. `ops.py`
holds the contraction planner (the reference's einsum programs, tiles
re-budgeted for shared memory) and the public wrappers; `ref.py` the
einsum oracles. Nothing here builds or
loads a kernel at import time.
"""
from . import ref
from .fused_update import (fused_hbm_bytes, fused_update_buckets,
                           fused_update_buckets_plain, plan_fused_update,
                           unfused_hbm_bytes)
from .ops import (MAX_ORDER, PIPELINES, ContractionPlan, cp_project,
                  cp_reconstruct, kernel_order_supported, pick_tiles,
                  plan_contraction,
                  program_codes, sweep_hbm_bytes, tt_cores_squeezed,
                  tt_project, tt_reconstruct, validate_pipeline)


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0: K1, K5 and K2
    (`_sweep.py`), K3 and K6 (`struct/carry.py`), K4
    (`fused_update.py`)."""
    from . import _sweep, fused_update
    from .struct import carry
    _sweep.reset_launch_counts()
    carry.reset_launch_counts()
    fused_update.reset_launch_counts()


__all__ = ["MAX_ORDER", "PIPELINES", "ContractionPlan", "cp_project",
           "cp_reconstruct", "fused_hbm_bytes", "fused_update_buckets",
           "fused_update_buckets_plain", "kernel_order_supported",
           "pick_tiles", "plan_contraction", "plan_fused_update",
           "program_codes", "ref", "reset_launch_counts", "sweep_hbm_bytes",
           "tt_cores_squeezed", "tt_project", "tt_reconstruct",
           "unfused_hbm_bytes", "validate_pipeline"]
