"""Cost-aware multi-level period controller (PyTorch port of
``repro/autotune/controller.py``; plain Python, a copy that differs in
import paths and docstrings).

:class:`CostAwarePlan` generalizes :class:`repro_torch.core.schedules.
AdaptivePlan` from "scale the outermost period on the loss ladder" to
"adapt EVERY reduction spacing from what the hardware actually costs":

* the **outermost** period still follows the loss ladder (far from the
  optimum -> wide interval, Thm 3.4 intuition; near convergence ->
  shrink toward the next-inner period) — Jiang & Agrawal
  (arXiv:2007.06134) show the averaging period is the lever worth
  adapting at runtime;
* every **intermediate** period (the pod level included — the ROADMAP
  follow-up) is set from the CALIBRATED cost ratio to its outer
  neighbour: level *i* fires ``~cost(i+1)/cost(i)`` times per level-
  *i+1* reduction, snapped to the nesting lattice.  With periods
  proportional to per-reduction cost, every tier spends roughly the
  same wire seconds per SGD step — and when the probed DCI/ICI ratio
  skews (global reductions get expensive relative to pod ones), the pod
  period SHRINKS: cheap intra-pod averaging substitutes for the
  expensive cross-DCI reduction, exactly Hier-AVG §3.3's "more frequent
  local averaging can replace global reductions";
* the **innermost** period is the SGD batching cadence and stays fixed,
  like AdaptivePlan's inner levels.

Costs come from a :class:`~repro_torch.autotune.calibrate.Calibration` (or a
raw CommModel / artifact path) through
``theory.level_reduction_seconds`` — the same bill the analytic stack
reports — so a synthetic calibration artifact drives the controller
deterministically in tests (no timing dependence).
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple, Union

from repro_torch.autotune.calibrate import Calibration, resolve_comm_model
from repro_torch.comm import DEFAULT_BUCKET_BYTES
from repro_torch.configs.base import HierAvgParams
from repro_torch.core.plan import ReductionPlan, apply_bucketing
from repro_torch.core.schedules import AdaptivePlan
from repro_torch.core.theory import (CommModel, level_reduction_seconds,
                               param_template)
from repro_torch.core.topology import HierTopology


# bounded window of ingested telemetry rows (observe): enough to settle
# a median past warm-up noise, small enough to track a drifting fleet
OBS_WINDOW = 64


def _pow2_gap(ratio: float, max_gap: int) -> int:
    """Nearest power of two to ``ratio``, clamped to [1, max_gap]."""
    if ratio <= 1.0:
        return 1
    g = 2 ** int(round(math.log2(ratio)))
    return max(1, min(int(g), max_gap))


def _snap_divisor(target: int, outer: int, inner: int) -> int:
    """Largest divisor of ``outer`` that is a multiple of ``inner`` and
    <= max(target, inner) — keeps the period lattice (inner | p | outer)
    while honouring the cost-derived target."""
    best = inner
    d = inner
    while d <= outer:
        if outer % d == 0 and d <= max(target, inner):
            best = d
        d += inner
    return best


@dataclass
class CostAwarePlan:
    """Adapt all periods of ``plan`` (the widest schedule) from the loss
    AND the calibrated per-level reduction costs on ``topo``.

    ``comm`` is a Calibration, a CommModel, a calibration-artifact path,
    or None (then ``$REPRO_CALIBRATION`` or the built-in constants).
    ``template`` is a single-learner parameter tree for payload
    accounting (meta tensors fine; default a 4M-param stand-in).
    ``max_gap`` clamps any cost-derived spacing multiplier.
    ``bucket_bytes``/``overlap`` mirror HierAvgParams: levels are COSTED
    resolved (bucketed message counts, pipelined overlap credit), the
    schedule ``resolve_plan`` will actually run.
    """

    plan: Union[ReductionPlan, str]
    topo: HierTopology
    comm: Union[Calibration, CommModel, str, None] = None
    template: Any = None
    outer_min: Optional[int] = None
    max_gap: int = 64
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    overlap: bool = True
    # parallel/sharding.py ShardPlan for fsdp>1 meshes: the resolved
    # engines then bill the reduce-scatter/all-gather wire bytes
    # (payload/F per sharded bucket) instead of the replicated payload
    shards: Any = None
    # elastic expected-cost billing: scalar per-member miss probability
    # (or {level_name: p}) the level costs are priced under — an
    # unreliable outer tier shrinks its n_eff ring, which moves the cost
    # ratios and therefore the intermediate periods (theory.py)
    drop_prob: Any = 0.0
    _ladder: AdaptivePlan = field(init=False, repr=False)

    def __post_init__(self):
        if not isinstance(self.plan, ReductionPlan):
            self.plan = ReductionPlan.parse(self.plan)
        if isinstance(self.comm, Calibration):
            self.comm = self.comm.model
        elif isinstance(self.comm, str):
            self.comm = Calibration.load(self.comm).model
        elif self.comm is None:
            self.comm = resolve_comm_model(default=CommModel())
        if self.template is None:
            self.template = param_template(1 << 22, n_leaves=8)
        # the loss ladder drives the outermost period, as before
        self._ladder = AdaptivePlan(self.plan, outer_min=self.outer_min)
        # every level_costs input is fixed for the controller's
        # lifetime; compute once instead of re-walking the template
        # every params_for call of a training loop
        resolved = apply_bucketing(self.plan, self.bucket_bytes,
                                   self.overlap, shards=self.shards)
        self._level_costs = tuple(
            level_reduction_seconds(
                lvl, self.topo, self.template, self.comm,
                drop_prob=(self.drop_prob.get(lvl.name, 0.0)
                           if hasattr(self.drop_prob, "get")
                           else float(self.drop_prob)))[2]
            for lvl in resolved.levels)
        # runtime observations (telemetry train_round rows via observe)
        self._obs_walls: deque = deque(maxlen=OBS_WINDOW)
        self._obs_fracs: Dict[str, deque] = {}

    @property
    def level_costs(self) -> Tuple[float, ...]:
        """Calibrated scheduled-wall seconds of ONE reduction per level
        (innermost first), on each level's RESOLVED engine (bucketed /
        pipelined per the knobs) — the cost the round actually pays."""
        return self._level_costs

    def periods_for(self, loss: float) -> Tuple[int, ...]:
        """All N periods (innermost first) for the current loss.

        Outermost from the ladder; then outside-in, each intermediate
        level's period is its outer neighbour's divided by the
        power-of-two-snapped cost ratio — an expensive outer neighbour
        pulls the level's period DOWN (reduce more often on the cheap
        tier), a cost ratio near 1 leaves it riding the outer boundary.
        """
        levels = self.plan.levels
        costs = self.level_costs
        periods = [lvl.period for lvl in levels]
        periods[-1] = self._ladder.outer_for(loss)
        inner = periods[0]
        tiny = 1e-30
        for i in range(len(levels) - 2, 0, -1):
            gap = _pow2_gap(costs[i + 1] / max(costs[i], tiny),
                            self.max_gap)
            periods[i] = _snap_divisor(periods[i + 1] // gap,
                                       periods[i + 1], inner)
        return tuple(periods)

    def plan_for(self, loss: float) -> ReductionPlan:
        return self.plan.with_periods(self.periods_for(loss))

    def params_for(self, loss: float,
                   base: Optional[HierAvgParams] = None) -> HierAvgParams:
        """Like :meth:`AdaptivePlan.params_for`: ``base`` keeps every
        non-schedule field via ``dataclasses.replace``."""
        spec = self.plan_for(loss).describe()
        if base is None:
            return HierAvgParams(plan=spec)
        return dataclasses.replace(base, plan=spec)

    def reset(self) -> None:
        """Forget the ladder's loss anchor (new run)."""
        self._ladder.reset()

    # ------------------------------------------------------------ #
    # live telemetry ingestion (repro_torch/telemetry — the first consumer)

    def observe(self, row: Mapping) -> None:
        """Ingest one measured ``train_round`` telemetry row
        (telemetry/metrics.py schema): the measured round ``wall_s`` and
        the per-level ``active_frac`` land in bounded windows so
        measured-vs-modeled wall (and live participation) are queryable
        at runtime.  Closing the loop — re-deriving ``drop_prob`` /
        periods from these windows — is the ROADMAP online-control
        follow-up; this is the signal path it plugs into."""
        w = row.get("wall_s")
        if w is not None and float(w) > 0.0:
            self._obs_walls.append(float(w))
        for name, f in (row.get("active_frac") or {}).items():
            self._obs_fracs.setdefault(
                name, deque(maxlen=OBS_WINDOW)).append(float(f))

    @property
    def observed_wall_s(self) -> Optional[float]:
        """Median measured round wall over the observation window
        (None until the first row; the median rides out the compile
        round and scheduler spikes)."""
        if not self._obs_walls:
            return None
        s = sorted(self._obs_walls)
        return s[len(s) // 2]

    @property
    def observed_active_frac(self) -> Dict[str, float]:
        """Mean observed participation fraction per level name."""
        return {n: sum(d) / len(d)
                for n, d in self._obs_fracs.items() if d}

    @property
    def modeled_round_wall_s(self) -> float:
        """The calibrated COMM bill of one round of ``plan``: billable
        reduction count x scheduled wall per level (no SGD compute —
        compare against ``observed_wall_s`` knowing measured walls
        include the compute the model does not bill)."""
        counts = dict(self.plan.counts_per_round())
        return sum(counts[lvl.name] * c
                   for lvl, c in zip(self.plan.levels, self._level_costs))

    def wall_bias(self) -> Optional[float]:
        """measured / modeled round wall (None until observed); the
        ratio a re-planner would scale the analytic bill by."""
        w = self.observed_wall_s
        m = self.modeled_round_wall_s
        return None if (w is None or m <= 0.0) else w / m
