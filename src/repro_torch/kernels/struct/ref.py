"""Plain einsum oracles for the carry sweep: batched structured-input
projections for all four (operator, input) family pairings, any order
N >= 2 — port of `repro/kernels/struct/ref.py`, string for string.

Layouts match the kernel layouts:
  TT-RP cores      g1 (k, d1, R),  interior (k, R, d_n, R),  gN (k, R, dN)
  CP-RP factors    f_n (k, d_n, R)
  TT input cores   x1 (B, d1, R~), interior (B, R~, d_n, R~), xN (B, R~, dN)
  CP input factors a_n (B, d_n, R~)   (weights already folded into a_1)

The 1/sqrt(k) JLT scaling is applied by `ops.struct_project`, NOT here.
"""
from __future__ import annotations

import torch


def tt_tt_ref(op_cores, in_cores) -> torch.Tensor:
    """y[b, i] = < <<G_i^1..G_i^N>>, <<X_b^1..X_b^N>> >, carry (b,k,R,R~)."""
    c = torch.einsum("kdu,bde->bkue", op_cores[0], in_cores[0])
    for g, x in zip(op_cores[1:-1], in_cores[1:-1]):
        t = torch.einsum("bkue,kudv->bkedv", c, g)
        c = torch.einsum("bkedv,bedf->bkvf", t, x)
    t = torch.einsum("bkue,kud->bked", c, op_cores[-1])
    return torch.einsum("bked,bed->bk", t, in_cores[-1])


def tt_cp_ref(op_cores, in_factors) -> torch.Tensor:
    """TT operator x CP-format input; carry (b, k, R, R~)."""
    c = torch.einsum("kdu,bdp->bkup", op_cores[0], in_factors[0])
    for g, a in zip(op_cores[1:-1], in_factors[1:-1]):
        t = torch.einsum("bkup,kudv->bkpdv", c, g)
        c = torch.einsum("bkpdv,bdp->bkvp", t, a)
    t = torch.einsum("bkup,kud->bkpd", c, op_cores[-1])
    return torch.einsum("bkpd,bdp->bk", t, in_factors[-1])


def cp_tt_ref(op_factors, in_cores) -> torch.Tensor:
    """CP operator x TT-format input; carry (b, k, R, R~)."""
    c = torch.einsum("kdr,bde->bkre", op_factors[0], in_cores[0])
    for f, x in zip(op_factors[1:-1], in_cores[1:-1]):
        t = torch.einsum("bkre,bedf->bkrdf", c, x)
        c = torch.einsum("bkrdf,kdr->bkrf", t, f)
    t = torch.einsum("bkre,bed->bkrd", c, in_cores[-1])
    return torch.einsum("bkrd,kdr->bk", t, op_factors[-1])


def cp_cp_ref(op_factors, in_factors) -> torch.Tensor:
    """CP operator x CP-format input: per-mode Hadamard on the (r, p) bond."""
    c = torch.einsum("kdr,bdp->bkrp", op_factors[0], in_factors[0])
    for f, a in zip(op_factors[1:-1], in_factors[1:-1]):
        c = c * torch.einsum("kdr,bdp->bkrp", f, a)
    t = torch.einsum("kdr,bdp->bkrp", op_factors[-1], in_factors[-1])
    return torch.einsum("bkrp,bkrp->bk", c, t)


REFS = {("tt", "tt"): tt_tt_ref, ("tt", "cp"): tt_cp_ref,
        ("cp", "tt"): cp_tt_ref, ("cp", "cp"): cp_cp_ref}
