"""K1/K2 schedules, including the Theorem-3.1 admissible K2 and adaptive
controllers motivated by §3.3 ("adaptive choice of K2 may be better")
(PyTorch port of ``repro/core/schedules.py``: pure Python, copied).

:class:`AdaptivePlan` generalizes the K2 ladder to any N-level
ReductionPlan: it scales the *outermost* period (the expensive cross-DCI
reduction) while inner periods stay fixed — Jiang & Agrawal
(arXiv:2007.06134) show the averaging period is the lever worth adapting.
:class:`AdaptiveK2` is its 2-level specialization, kept for the legacy
(k1, k2) API.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Union

from repro_torch.configs.base import HierAvgParams
from repro_torch.core.plan import ReductionPlan


def thm31_k2(T: int, P: int, B: int) -> int:
    """K2 = T^{1/4} / (PB)^{3/4} — the largest interval that preserves the
    O(1/sqrt(PBT)) rate (Theorem 3.1, eq. 3.3)."""
    return max(1, int(round(T ** 0.25 / (P * B) ** 0.75)))


def thm31_gamma(P: int, B: int, T: int) -> float:
    """gamma = sqrt(PB/T) (Theorem 3.1, eq. 3.3) — parallelism-scaled step."""
    return math.sqrt(P * B / T)


@dataclass
class AdaptivePlan:
    """Far-from-optimum => large outermost period (Thm 3.4 intuition:
    condition (3.11) holds when F(w1)-F* is large); near convergence =>
    shrink it toward the next-inner period.  Inner periods never move —
    the controller only spaces out the expensive outermost (cross-DCI)
    reduction.

    A simple multiplicative ladder on the observed training loss: the
    outer period halves each time the loss drops below the next power-of-
    two fraction of its initial value, floored at ``outer_min`` and kept a
    multiple of the next-inner period.  Deterministic, cheap, and
    documented as heuristic.

    ``plan`` is the *widest* schedule (its outermost period is the
    ladder's maximum), as a ReductionPlan or spec string.
    """

    plan: Union[ReductionPlan, str]
    outer_min: Optional[int] = None
    _loss0: Optional[float] = field(default=None, repr=False)

    def __post_init__(self):
        if not isinstance(self.plan, ReductionPlan):
            self.plan = ReductionPlan.parse(self.plan)
        self.outer_max = self.plan.total_period
        # inner periods are fixed; the outer period never dips below the
        # next-inner one (a level reducing more often than its child
        # would violate period nesting)
        self.inner = (self.plan.levels[-2].period
                      if len(self.plan.levels) > 1 else 1)
        self.outer_min = self.outer_min or self.inner
        if (self.outer_min < self.inner
                or self.outer_min % self.inner != 0):
            raise ValueError(
                f"outer_min {self.outer_min} must be a multiple of the "
                f"next-inner period {self.inner}")

    def outer_for(self, loss: float) -> int:
        if self._loss0 is None:
            self._loss0 = max(loss, 1e-9)
        frac = max(loss, 1e-9) / self._loss0
        # frac 1.0 -> outer_max ; frac -> 0 shrinks to outer_min, in
        # powers of two
        span = max(1, int(math.log2(max(2, self.outer_max
                                        // self.outer_min))))
        level = min(span, max(0, int(-math.log2(max(frac, 1e-9)))))
        outer = max(self.outer_min, self.outer_max >> level)
        # keep divisibility inner | outer
        return max(self.inner, (outer // self.inner) * self.inner)

    def plan_for(self, loss: float) -> ReductionPlan:
        return self.plan.with_outer_period(self.outer_for(loss))

    def params_for(self, loss: float,
                   base: Optional[HierAvgParams] = None) -> HierAvgParams:
        """HierAvgParams for the current loss.  ``base`` carries every
        non-schedule field (``bucket_bytes``, ``overlap``, ...) into the
        result — only the plan is replaced.  Without it, defaults apply."""
        spec = self.plan_for(loss).describe()
        if base is None:
            return HierAvgParams(plan=spec)
        return dataclasses.replace(base, plan=spec)

    def reset(self) -> None:
        """Forget the loss anchor so the next ``*_for`` call re-anchors
        the ladder — call between independent runs (``_loss0`` otherwise
        carries over and a warm-started run never sees frac 1.0)."""
        self._loss0 = None


@dataclass
class AdaptiveK2:
    """2-level specialization of :class:`AdaptivePlan` for the legacy
    (k1, k2) API: K2 ladder from ``k2_max`` down toward ``k2_min``
    (default K1) as the loss falls, always keeping K1 | K2."""

    k1: int
    k2_max: int
    k2_min: Optional[int] = None

    def __post_init__(self):
        # the legacy API tolerated non-divisible bounds (it rounded inside
        # the ladder); keep that by flooring both to multiples of K1 here
        self.k2_max = max(self.k1, (self.k2_max // self.k1) * self.k1)
        k2_min = self.k2_min or self.k1
        self.k2_min = max(self.k1, (k2_min // self.k1) * self.k1)
        self._ctl = AdaptivePlan(
            ReductionPlan.from_k1_k2(self.k1, self.k2_max),
            outer_min=self.k2_min)

    def k2_for(self, loss: float) -> int:
        return self._ctl.outer_for(loss)

    def params_for(self, loss: float,
                   base: Optional[HierAvgParams] = None) -> HierAvgParams:
        """Legacy-trio params for the current loss; ``base`` (if given)
        keeps its other fields via ``dataclasses.replace`` — ``plan`` is
        cleared so the adapted (k1, k2) actually take effect."""
        k2 = self.k2_for(loss)
        if base is None:
            return HierAvgParams(k1=self.k1, k2=k2)
        return dataclasses.replace(base, k1=self.k1, k2=k2, plan=None)

    def reset(self) -> None:
        self._ctl.reset()
