"""Enumerate-and-rank reduction-plan search under a calibrated cost model
(PyTorch port of ``repro/autotune/search.py``; plain Python, a copy that
differs in import paths and docstrings).

Scores every (periods x reducers per level) candidate on two axes and
ranks by their product — a time-to-target proxy in the fixed-data
regime:

* **seconds per SGD step** — the calibrated communication wall-clock
  (``theory.plan_comm_per_round`` under the fitted CommModel, i.e. each
  level on its own measured tier with its own compressed payload and
  overlap term) plus the caller's ``step_s`` compute floor;
* **bound constant per step** — the paper's Theorem 3.4 objective
  ``B(K2) = f(K2) g(K2)`` (theory.thm34_objective) with K1 = the
  candidate's innermost period, K2 = its outermost, S = the topology's
  cluster size: the convergence error constant per unit data at a fixed
  data budget.  Candidates violating the Theorem 3.2 admissibility
  condition (3.5) for their K2 are flagged infeasible and rank after
  every feasible plan.

So a plan only wins by spending LESS wall-clock per step without giving
up more convergence constant than it saves — e.g. under a skewed
(expensive-DCI) calibration the search stretches the global period
and/or compresses the global payload, while a cheap-DCI calibration
keeps dense frequent globals.  Deterministic given the calibration
artifact: tests drive it with synthetic models, no timing dependence.

``template`` is a single-learner parameter tree of meta tensors (shape
and dtype only): ``core/simulator.py::init_template`` of a model, where
the reference takes ``jax.eval_shape``, or ``theory.param_template``.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

from repro_torch.autotune.calibrate import Calibration
from repro_torch.comm import DEFAULT_BUCKET_BYTES
from repro_torch.core.plan import ReductionPlan, apply_bucketing
from repro_torch.core.theory import (CommModel, param_template,
                               plan_comm_per_round, thm32_condition,
                               thm34_objective, thm34_terms)
from repro_torch.core.topology import HierTopology

DEFAULT_PERIODS: Dict[str, Tuple[int, ...]] = {
    "local": (1, 2, 4),
    "pod": (2, 4, 8, 16),
    "global": (4, 8, 16, 32, 64),
}
DEFAULT_REDUCERS: Dict[str, Tuple[str, ...]] = {
    "local": ("mean", "cast:bfloat16"),
    "pod": ("mean",),
    "global": ("mean", "cast:bfloat16", "topk:0.05"),
}


@dataclass(frozen=True)
class SearchSpace:
    """Candidate grid: per-level periods and reducer specs.  Periods
    must nest (each divides the next) — non-nesting combinations are
    skipped during enumeration."""

    levels: Tuple[str, ...] = ("local", "pod", "global")
    periods: Dict[str, Tuple[int, ...]] = field(
        default_factory=lambda: dict(DEFAULT_PERIODS))
    reducers: Dict[str, Tuple[str, ...]] = field(
        default_factory=lambda: dict(DEFAULT_REDUCERS))


@dataclass(frozen=True)
class ScoredPlan:
    spec: str
    outer: int                  # K2 (outermost period)
    inner: int                  # K1 (innermost period)
    comm_s_per_step: float      # calibrated comm wall per SGD step
    sec_per_step: float         # step_s + comm_s_per_step
    objective: float            # Thm 3.4 B(K2) error constant
    score: float                # sec_per_step * objective
    feasible: bool              # Thm 3.2 condition (3.5) at this K2


def enumerate_specs(space: SearchSpace):
    """All nested (period, reducer) combinations as plan spec strings."""
    for periods in itertools.product(
            *(space.periods[n] for n in space.levels)):
        if any(hi % lo for lo, hi in zip(periods, periods[1:])):
            continue
        for reds in itertools.product(
                *(space.reducers[n] for n in space.levels)):
            yield "/".join(f"{n}@{p}:{r}" for n, p, r
                           in zip(space.levels, periods, reds))


def search_plans(topo: HierTopology,
                 comm: Union[Calibration, CommModel, None] = None, *,
                 template: Any = None,
                 space: Optional[SearchSpace] = None,
                 B: int = 32, T_ref: int = 4096,
                 gamma: float = 0.05, L: float = 1.0, M: float = 1.0,
                 F1_minus_Fstar: float = 1.0,
                 step_s: float = 0.0,
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 overlap: bool = True,
                 shards: Any = None,
                 drop_prob=0.0,
                 top: Optional[int] = None) -> List[ScoredPlan]:
    """Rank the candidate grid; best (lowest score, feasible first)
    first.  ``gamma``/``L``/``M``/``F1_minus_Fstar`` are the Thm 3.4
    constants (defaults: the paper's small-step regime — gamma small
    enough that a useful K2 range stays admissible under (3.5));
    ``step_s`` the per-SGD-step compute floor the comm bill rides on.

    Candidates are costed RESOLVED — bucketed on the pipelined schedule
    per ``bucket_bytes``/``overlap``, like ``resolve_plan`` will run
    them — so codec candidates get their bucketed message counts and
    overlap credit, not a per-leaf serial bill the trained plan never
    pays.  The returned ``spec`` stays the
    raw plan string (resolution re-applies at build time).  ``shards``
    (parallel/sharding.py ShardPlan) bills fsdp>1 candidates at their
    reduce-scatter/all-gather wire bytes (payload/F per sharded
    bucket).

    ``drop_prob`` — score plans against an unreliable tier: a scalar (or
    ``{level_name: p}`` mapping) per-member miss probability; each
    level's ring terms are billed at ``effective_participants`` (elastic
    expected-cost mode, core/theory.py).  The Thm 3.4 objective is left
    at its dense constants — the masked mean keeps the averaging
    unbiased over survivors, so the cost side is where unreliability
    moves the ranking."""
    if isinstance(comm, Calibration):
        comm = comm.model
    cm = comm or CommModel()
    space = space or SearchSpace()
    if template is None:
        template = param_template(1 << 22, n_leaves=8)
    P = topo.n_learners
    S = max(topo.s, 1)
    alpha, beta, eta = thm34_terms(F1_minus_Fstar, L, M, gamma, T_ref, P, B)
    out: List[ScoredPlan] = []
    for spec in enumerate_specs(space):
        plan = ReductionPlan.parse(spec)
        resolved = apply_bucketing(plan, bucket_bytes, overlap,
                                   shards=shards)
        costs = plan_comm_per_round(resolved, topo, template, cm,
                                    drop_prob=drop_prob)
        comm_per_step = sum(c.overlap_s for c in costs) / plan.total_period
        k1 = plan.levels[0].period
        k2 = plan.total_period
        obj = thm34_objective(k2, k1, S, alpha, beta, eta)
        sec = step_s + comm_per_step
        out.append(ScoredPlan(
            spec=spec, outer=k2, inner=k1,
            comm_s_per_step=comm_per_step, sec_per_step=sec,
            objective=obj, score=sec * obj,
            feasible=thm32_condition(L, gamma, k2)))
    out.sort(key=lambda sp: (not sp.feasible, sp.score))
    return out[:top] if top else out


def recommend_plan(topo: HierTopology,
                   comm: Union[Calibration, CommModel, None] = None,
                   **kw) -> ScoredPlan:
    """The search winner (best feasible plan; best overall only if
    nothing in the grid satisfies condition (3.5))."""
    return search_plans(topo, comm, **kw)[0]
