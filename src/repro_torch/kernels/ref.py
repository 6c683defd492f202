"""Plain einsum oracles for the mode-sweep kernels — port of
`repro/kernels/ref.py`, string for string.

Layouts match the kernel layouts (`ops.tt_cores_squeezed` / `op.factors`):
  TT-RP cores:   g1 (k, d1, R), interior (k, R, d_n, R), gN (k, R, dN)
  CP-RP factors: f_n (k, d_n, R)
The 1/sqrt(k) JLT scaling is applied by ops.py, NOT here.
"""
from __future__ import annotations

import torch

_MODES = "abcdefgh"


def tt_project_ref(x: torch.Tensor, cores) -> torch.Tensor:
    """y[i] = < <<G_i^1, ..., G_i^N>>, x >, unbatched x, squeezed cores."""
    order = len(cores)
    modes = _MODES[:order]
    z = torch.einsum(f"{modes},ku{modes[-1]}->k{modes[:-1]}u", x, cores[-1])
    carry = "u"
    for i in range(order - 2, 0, -1):
        new = "v" if carry == "u" else "u"
        z = torch.einsum(f"k{modes[:i + 1]}{carry},k{new}{modes[i]}{carry}"
                         f"->k{modes[:i]}{new}", z, cores[i])
        carry = new
    return torch.einsum(f"ka{carry},ka{carry}->k", z, cores[0])


def cp_project_ref(x: torch.Tensor, factors) -> torch.Tensor:
    """y[i] = sum_r <f1[i,:,r] o ... o fN[i,:,r], x>, unbatched x."""
    order = len(factors)
    modes = _MODES[:order]
    z = torch.einsum(f"{modes},k{modes[-1]}r->k{modes[:-1]}r", x, factors[-1])
    for i in range(order - 2, 0, -1):
        z = torch.einsum(f"k{modes[:i + 1]}r,k{modes[i]}r->k{modes[:i]}r",
                         z, factors[i])
    return torch.einsum("kar,kar->k", z, factors[0])


def tt_reconstruct_ref(y: torch.Tensor, cores) -> torch.Tensor:
    """x_hat[n,...] = sum_{i, bonds} y[n,i] g1[i,.] ... gN[i,.], y (B, k)."""
    w = torch.einsum("nk,kar->nkar", y, cores[0])
    for g in cores[1:-1]:
        w = torch.einsum("nk...r,krds->nk...ds", w, g)
    return torch.einsum("nk...r,krd->n...d", w, cores[-1])


def cp_reconstruct_ref(y: torch.Tensor, factors) -> torch.Tensor:
    """x_hat[n,...] = sum_{i,r} y[n,i] f1[i,.,r] ... fN[i,.,r], y (B, k)."""
    w = torch.einsum("nk,kar->nkar", y, factors[0])
    for f in factors[1:-1]:
        w = torch.einsum("nk...r,kdr->nk...dr", w, f)
    return torch.einsum("nk...r,kdr->n...d", w, factors[-1])
