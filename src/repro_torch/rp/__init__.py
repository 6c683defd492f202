"""repro_torch.rp — the unified projector API (port of `repro.rp`).

One protocol (`RPOperator`), one declarative spec (`ProjectorSpec`), a
registry (`register_family` / `make_projector`), and the dispatched entry
points `project` / `reconstruct` / `project_many`, each resolving through
a cached `ExecutionPlan` (`repro_torch.rp.plan`) that routes dense
inputs, TT/CP-format inputs and sketches of TT/CP operators to the
hand-written CUDA kernels on the card ('auto' | 'kernel' | 'torch';
`pipeline='double'` for the double-buffered projections). The paper's
baselines ('gaussian', 'sparse') stream blocks of their (k, D) matrix.
Mesh-aware entry points (`project_sharded` / `reconstruct_sharded` /
`sketch_tree_sharded` / `bucket_pspec`, `rp.shard`) split the bucket axis
over a `launch.mesh.Mesh`: one dispatch a rank on its block, the operator
drawn again on every rank.

Quickstart::

    from repro_torch import rp

    spec = rp.ProjectorSpec(family="tt", k=512, dims=(64, 64, 64), rank=5)
    op = rp.make_projector(spec, seed=0)           # on the CUDA device
    y = rp.project(op, x)                          # (*batch, k)
    x_hat = rp.reconstruct(op, y)                  # unbiased adjoint
"""
from . import families as _families  # noqa: F401  (registers built-ins)
from .dispatch import (DispatchStats, count_kernel_dispatch, current_stats,
                       dispatch_breakdown, dispatch_stats, force_kernel,
                       kernel_call_count, project, reconstruct)
from .many import project_many
from .plan import (BACKENDS, CostLedger, ExecutionPlan, PlanCacheStats,
                   StructureSig, clear_plan_cache, collective_wire_bytes,
                   execute_plan, explain,
                   group_signature, plan_cache_stats, plan_execution,
                   plan_update, pow2ceil, struct_in_rank, struct_signature,
                   structure_tag, validate_backend, validate_pipeline)
from .protocol import FormatMismatchError, ProjectorSpec, RPOperator
from .shard import (bucket_pspec, dequantize_psum, project_sharded,
                    quantize_for_psum, reconstruct_sharded,
                    sketch_tree_sharded)
from .registry import (get_family, list_families, make_projector,
                       register_family)

__all__ = [
    "BACKENDS", "CostLedger", "bucket_pspec", "dequantize_psum",
    "project_sharded", "quantize_for_psum", "reconstruct_sharded",
    "sketch_tree_sharded", "DispatchStats", "ExecutionPlan",
    "FormatMismatchError", "PlanCacheStats", "ProjectorSpec", "RPOperator",
    "StructureSig", "clear_plan_cache", "collective_wire_bytes",
    "count_kernel_dispatch",
    "current_stats", "dispatch_breakdown", "dispatch_stats", "execute_plan",
    "explain", "force_kernel", "get_family", "group_signature", "kernel_call_count",
    "list_families", "make_projector", "plan_cache_stats", "plan_execution",
    "plan_update", "pow2ceil", "project", "project_many", "reconstruct",
    "register_family", "struct_in_rank", "struct_signature",
    "structure_tag", "validate_backend", "validate_pipeline",
]
