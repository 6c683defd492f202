"""Compressed-domain sketching: batched projection of TT/CP-format inputs
through the hand-written CUDA carry-sweep kernels K3/K6 (port of
`repro.kernels.struct`).

  plan.py  — `plan_carry_sweep` / `CarryPlan`: the reference's einsum carry
             program + (tk, tb) tiles budgeted for shared memory.
  carry.py — the kernel wrappers, their plain versions and the lowering
             of the program to the kernels' opcodes.
  ref.py   — order-generic batched einsum oracles (also the torch route).
  ops.py   — `struct_project`: layout + planning, single and batched.
"""
from . import ref
from .ops import STRUCT_TYPES, struct_project, struct_rank
from .plan import CarryPlan, plan_carry_sweep, struct_hbm_bytes

__all__ = ["CarryPlan", "STRUCT_TYPES", "plan_carry_sweep", "ref",
           "struct_hbm_bytes", "struct_project", "struct_rank"]
