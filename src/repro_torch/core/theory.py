"""Theorem 1/2 bounds and complexity formulas, used by tests and benchmarks.

All formulas are stated exactly as in the paper; `required_k_*` expose the
JL lower bounds with an explicit constant c (the paper's ≳ hides it).

Order-dependent TT-vs-CP comparison (the paper's headline, Sec. 4)
------------------------------------------------------------------
At input order N and rank R, the Thm-1 variance factors are

    TT: 3 (1 + 2/R)^{N-1} - 1        CP: 3^{N-1} (1 + 2/R) - 1

— identical at N = 2 (both reduce to 3(1+2/R) - 1), and diverging
exponentially for N >= 3: their ratio grows like (3 / (1 + 2/R))^{N-2},
so for any R > 1 every extra mode multiplies CP's variance disadvantage
by 3/(1+2/R) > 1 (`variance_ratio_cp_to_tt`). The Thm-2 embedding sizes
inherit the same ordering: `required_k_cp / required_k_tt` ~
(3 / (1 + 2/R))^{N-1}. This is exactly why the order-N kernel layer pays
off — tensorizing the same bucket into MORE, SMALLER modes shrinks the TT
operator (params O(kNdR^2) with d ~ D^{1/N}) while the TT bound degrades
only geometrically in N where CP's degrades like 3^N.
"""
from __future__ import annotations

import math


# ---------------------------------------------------------------------------
# Theorem 1 — variance bounds (the bracketed factor multiplying ||X||^4 / k)
# ---------------------------------------------------------------------------

def variance_factor_tt(N: int, R: int) -> float:
    """Var(||f_TT(R)(X)||^2) <= factor / k * ||X||_F^4."""
    return 3.0 * (1.0 + 2.0 / R) ** (N - 1) - 1.0


def variance_factor_cp(N: int, R: int) -> float:
    """Var(||f_CP(R)(X)||^2) <= factor / k * ||X||_F^4."""
    return 3.0 ** (N - 1) * (1.0 + 2.0 / R) - 1.0


def variance_factor_gaussian() -> float:
    """Classical Gaussian RP: Var = 2/k ||x||^4 (the N=1 specialization)."""
    return 2.0


def variance_factor_sparse(s: float) -> float:
    """Very-sparse RP (Li et al. 2006) worst case: E[a^4] = s gives
    Var(||y||^2) <= (2 + (s-3) sum x_j^4/||x||^4)/k ||x||^4 <= (s-1)/k ||x||^4."""
    return max(2.0, s - 1.0)


def variance_ratio_cp_to_tt(N: int, R: int) -> float:
    """Thm-1 bound ratio CP/TT at order N, rank R (module docstring).

    == 1 at N = 2 (and for R = 1 at any N, where the two maps coincide
    distribution-wise); grows ~ (3/(1+2/R))^{N-2} for R > 1 — the
    order-dependent advantage of TT the benchmarks chart.
    """
    return variance_factor_cp(N, R) / variance_factor_tt(N, R)


def variance_factor(family: str, *, N: int, R: int, D: int | None = None) -> float:
    """Thm-1 variance factor for any built-in family (per-family dispatch).

    Unknown (externally registered) families fall back to the Gaussian
    factor — conservative users should register a tighter bound here.
    """
    if family == "tt":
        return variance_factor_tt(N, R)
    if family == "cp":
        return variance_factor_cp(N, R)
    if family in ("sparse", "verysparse"):
        return variance_factor_sparse(math.sqrt(D) if D else 2.0)
    return variance_factor_gaussian()


# ---------------------------------------------------------------------------
# Theorem 2 — JL embedding-size lower bounds
# ---------------------------------------------------------------------------

def required_k_tt(eps: float, m: int, N: int, R: int, *, delta: float = 0.01,
                  c: float = 1.0) -> int:
    """k ≳ eps^-2 (1 + 2/R)^N log^{2N}(m / delta)."""
    return int(math.ceil(
        c * eps ** -2 * (1.0 + 2.0 / R) ** N * math.log(m / delta) ** (2 * N)))


def required_k_cp(eps: float, m: int, N: int, R: int, *, delta: float = 0.01,
                  c: float = 1.0) -> int:
    """k ≳ eps^-2 3^{N-1} (1 + 2/R) log^{2N}(m / delta)."""
    return int(math.ceil(
        c * eps ** -2 * 3.0 ** (N - 1) * (1.0 + 2.0 / R)
        * math.log(m / delta) ** (2 * N)))


def required_k_gaussian(eps: float, m: int, *, delta: float = 0.01,
                        c: float = 8.0) -> int:
    """Classical JL: k = O(eps^-2 log(m/delta))."""
    return int(math.ceil(c * eps ** -2 * math.log(m / delta)))


def concentration_bound_tt(k: int, eps: float, N: int, R: int,
                           *, K: float = 1.0) -> float:
    """Theorem 5 failure-probability upper bound (C = e^2)."""
    C = math.e ** 2
    expo = (math.sqrt(k) * eps) ** (1.0 / N) / (
        (3.0 * K) ** (1.0 / (2 * N)) * math.sqrt(1.0 + 2.0 / R))
    return C * math.exp(-expo)


# ---------------------------------------------------------------------------
# Memory / compute complexity (Sec. 1 & 3) — exact parameter counts
# ---------------------------------------------------------------------------

def params_tt_rp(k: int, dims, R: int) -> int:
    """k * (d_1 R + sum_middle R d R + d_N R); == O(kNdR^2)."""
    N = len(dims)
    if N == 1:
        return k * dims[0]
    total = dims[0] * R + dims[-1] * R
    for d in dims[1:-1]:
        total += R * d * R
    return k * total


def params_cp_rp(k: int, dims, R: int) -> int:
    """k * R * sum(d_n); == O(kNdR)."""
    return k * R * sum(dims)


def params_gaussian_rp(k: int, dims) -> int:
    out = k
    for d in dims:
        out *= d
    return out


def params_sparse_rp(k: int, dims, s: float | None = None) -> int:
    D = 1
    for d in dims:
        D *= d
    s = s if s is not None else math.sqrt(D)
    return int(k * D / s)


def params_rp(family: str, k: int, dims, R: int = 2) -> int:
    """Operator parameter count for any built-in family."""
    if family == "tt":
        return params_tt_rp(k, dims, R)
    if family == "cp":
        return params_cp_rp(k, dims, R)
    if family in ("gaussian", "dense"):
        return params_gaussian_rp(k, dims)
    if family in ("sparse", "verysparse"):
        return params_sparse_rp(k, dims)
    raise KeyError(f"no parameter formula for family {family!r}")


# FLOP estimates for the projection paths (multiply-adds x2), used by the
# kernel-level roofline analysis.

def flops_project_dense_tt(k: int, dims, R: int) -> int:
    N = len(dims)
    D = 1
    for d in dims:
        D *= d
    if N == 1:
        return 2 * k * D
    fl = 2 * k * R * D  # right-most contraction
    lead = D // dims[-1]
    for n in range(N - 2, 0, -1):
        lead //= dims[n]
        fl += 2 * k * R * R * lead * dims[n]
    fl += 2 * k * R * dims[0]
    return fl


def flops_project_tt_tt(k: int, dims, R: int, R_in: int) -> int:
    """TT operator applied to TT input: O(k N d R R~ (R + R~))."""
    fl = 0
    for d in dims:
        fl += 2 * k * d * R * R_in * (R + R_in)
    return fl


# ---------------------------------------------------------------------------
# Structured-input (compressed-domain) cost model — the carry-sweep path
# (`repro.kernels.struct`). Per-mode costs follow the einsum carry programs
# exactly; dividing the dense-path FLOPs by these gives the analytic speedup
# the benchmarks report next to measured wall-clock.
# ---------------------------------------------------------------------------

def flops_project_struct(op_family: str, in_family: str, k: int, dims,
                         R: int, R_in: int) -> int:
    """Carry-sweep FLOPs (x2 multiply-add) for one structured projection.

    Per mode of size d, the (operator, input) pairing costs:
      tt x tt : 2 k d R R~ (R + R~)   — two bond updates of the (R, R~) carry
      tt x cp : 2 k d R R~ (R + 1)    — CP input has no bond to re-expand
      cp x tt : 2 k d R R~ (R~ + 1)
      cp x cp : 2 k d R R~  (+ k R R~ Hadamard, kept: exact, not just O())
    vs the dense path's O(k R d^N) (`flops_project_dense_tt` / `_cp`) —
    compressed-domain projection replaces the d^N dependence with N·d.
    """
    if op_family not in ("tt", "cp") or in_family not in ("tt", "cp"):
        raise KeyError(f"no structured cost model for "
                       f"{op_family!r} x {in_family!r}")
    fl = 0
    for d in dims:
        if op_family == "tt" and in_family == "tt":
            fl += 2 * k * d * R * R_in * (R + R_in)
        elif op_family == "tt" and in_family == "cp":
            fl += 2 * k * d * R * R_in * (R + 1)
        elif op_family == "cp" and in_family == "tt":
            fl += 2 * k * d * R * R_in * (R_in + 1)
        else:
            fl += 2 * k * d * R * R_in + k * R * R_in
    return fl


def mem_carry_struct(k: int, R: int, R_in: int, *, batch: int = 1) -> int:
    """Peak carry-state bytes of the sweep: B * k * R * R~ f32 floats —
    the (B, k, R_op·R_in) bond state that replaces the dense path's
    (B, k, d_2..d_N) sweep intermediates (Iwen et al.'s memory argument)."""
    return 4 * batch * k * R * R_in


def struct_speedup(op_family: str, in_family: str, k: int, dims, R: int,
                   R_in: int) -> float:
    """Analytic dense-FLOPs / structured-FLOPs ratio for one projection.

    > 1 while the input's rank is low (the paper's regime: compressed-domain
    projection wins by ~d^{N-1} / (R~ (R + R~))); monotonically decreasing
    in R~, crossing below 1 once R~(R + R~) outgrows the dense contraction —
    the crossover `benchmarks/timing.py` reports per row.
    """
    dense = (flops_project_dense_tt(k, dims, R) if op_family == "tt"
             else flops_project_dense_cp(k, dims, R))
    return dense / flops_project_struct(op_family, in_family, k, dims,
                                        R, R_in)


def flops_project_dense_cp(k: int, dims, R: int) -> int:
    N = len(dims)
    D = 1
    for d in dims:
        D *= d
    fl = 2 * k * R * D
    lead = D
    for n in range(N - 2, -1, -1):
        lead //= dims[n + 1]
        fl += 2 * k * R * lead
    return fl
