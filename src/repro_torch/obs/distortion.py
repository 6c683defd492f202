"""Streaming check of the quantity the paper actually guarantees.

Theorem 1 (Tensorized Random Projections) bounds the variance of the
sketch's squared-norm estimate: for a unit vector x,
Var[‖Sx‖²] = c/k with c the family's variance factor
(`repro_torch.core.theory.variance_factor`, the port's copy — TT:
3(1+2/R)^(N-1) - 1, CP: 3^(N-1)(1+2/R) - 1). Chebyshev then gives the
distortion interval:

    P(|‖Sx‖²/‖x‖² - 1| > eps) <= c / (k · eps²) <= delta
                                  whenever k >= c / (delta · eps²).

`DistortionMonitor` watches that guarantee EMPIRICALLY: callers declare a
fixed quality target (eps, delta) once, stream per-sketch distortions
‖Sx‖²/‖x‖² grouped per (family, order, k), and the monitor raises a typed
alert event as soon as a group's observed out-of-interval rate exceeds
delta (after `min_samples`, so one unlucky sketch can't page anyone). At
the paper-prescribed k (>= c/(delta·eps²)) the alert provably stays
silent up to sampling noise; an under-sized k inflates the variance past
the target and the out-rate crosses delta — which is exactly the
misconfiguration this monitor exists to catch in production, where nothing
else in the serving/training path ever looks at distortion.

The target eps is deliberately NOT derived from each group's own k: the
self-derived interval sqrt(c/(k·delta)) widens as k shrinks and would
never flag an under-provisioned sketch. Fixed target, per-group verdict.
Port of `repro/obs/distortion.py`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

from repro_torch.core import theory


@dataclasses.dataclass(frozen=True)
class DistortionAlert:
    """Typed alert payload: one (family, order, k) group crossed delta."""

    family: str
    order: int
    k: int
    n: int                   # samples seen when the alert fired
    out_rate: float          # observed P(|distortion - 1| > eps)
    eps: float               # the fixed target interval half-width
    delta: float             # the target out-rate the group exceeded
    k_required: int          # paper-prescribed k for (eps, delta)

    def as_event(self) -> dict:
        d = dataclasses.asdict(self)
        d["name"] = "distortion.alert"
        return d


@dataclasses.dataclass
class _Group:
    n: int = 0
    out: int = 0
    sum: float = 0.0         # running mean of the distortion, for reports
    alerted: bool = False


def required_k(family: str, order: int, *, rank: int, eps: float,
               delta: float) -> int:
    """Paper-prescribed sketch size: the smallest k with c/(k·eps²) <= delta."""
    if eps <= 0.0:
        raise ValueError(f"eps must be positive, got {eps}")
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    c = theory.variance_factor(family, N=order, R=rank)
    return math.ceil(c / (delta * eps * eps))


class DistortionMonitor:
    """Streams empirical distortion against a fixed (eps, delta) target.

    `observe(family, order, k, distortion)` ingests one sketch's
    ‖Sx‖²/‖x‖²; `observe_norms` computes it from the two squared norms.
    When a (family, order, k) group has seen >= `min_samples` samples and
    its out-of-interval rate exceeds `delta`, a `DistortionAlert` is
    recorded (once per group — a stuck config should not page every
    sketch) and `on_alert` is invoked with it. `repro_torch.obs.enable()`
    wires `on_alert` to the metrics event log + a trace instant by default.
    """

    def __init__(self, eps: float, delta: float, *, min_samples: int = 64,
                 on_alert: Callable[[DistortionAlert], None] | None = None):
        if not eps > 0.0:
            raise ValueError(
                f"distortion target eps must be > 0, got {eps}")
        if not 0.0 < delta < 1.0:
            raise ValueError(
                f"distortion target delta must be in (0, 1), got {delta}")
        if min_samples < 1:
            raise ValueError(
                f"min_samples must be >= 1, got {min_samples}")
        self.eps = float(eps)
        self.delta = float(delta)
        self.min_samples = int(min_samples)
        self.on_alert = on_alert
        self.groups: dict[tuple[str, int, int], _Group] = {}
        self.alerts: list[DistortionAlert] = []

    # -- ingestion -------------------------------------------------------
    def observe(self, family: str, order: int, k: int, distortion: float,
                *, rank: int = 2) -> DistortionAlert | None:
        """Ingest one sketch's distortion ‖Sx‖²/‖x‖² for its group.

        Returns the alert iff THIS observation crossed the threshold.
        `rank` only feeds the alert's `k_required` diagnostic (unknown
        families fall back to a Gaussian variance factor there).
        """
        if int(k) <= 0:
            raise ValueError(f"sketch size k must be positive, got {k}")
        g = self.groups.setdefault((family, int(order), int(k)), _Group())
        d = float(distortion)
        g.n += 1
        g.sum += d
        if abs(d - 1.0) > self.eps:
            g.out += 1
        if g.alerted or g.n < self.min_samples:
            return None
        rate = g.out / g.n
        if rate <= self.delta:
            return None
        g.alerted = True
        try:
            k_req = required_k(family, order, rank=rank, eps=self.eps,
                               delta=self.delta)
        except (KeyError, ValueError):
            k_req = required_k("gaussian", order, rank=rank, eps=self.eps,
                               delta=self.delta)
        alert = DistortionAlert(family=family, order=int(order), k=int(k),
                                n=g.n, out_rate=rate, eps=self.eps,
                                delta=self.delta, k_required=k_req)
        self.alerts.append(alert)
        if self.on_alert is not None:
            self.on_alert(alert)
        return alert

    def observe_norms(self, family: str, order: int, k: int,
                      x_norm2: float, y_norm2: float, *,
                      rank: int = 2) -> DistortionAlert | None:
        """Ingest from squared norms; zero-norm inputs are skipped (their
        distortion is undefined, not out-of-interval)."""
        x2 = float(x_norm2)
        if x2 <= 0.0:
            return None
        return self.observe(family, order, k, float(y_norm2) / x2, rank=rank)

    # -- reporting -------------------------------------------------------
    def summary(self) -> list[dict]:
        """Per-group report rows (the obs_report CLI renders these)."""
        rows = []
        for (family, order, k), g in sorted(self.groups.items()):
            rows.append({
                "family": family, "order": order, "k": k, "n": g.n,
                "mean_distortion": g.sum / g.n if g.n else 0.0,
                "out_rate": g.out / g.n if g.n else 0.0,
                "eps": self.eps, "delta": self.delta,
                "alerted": g.alerted,
            })
        return rows
