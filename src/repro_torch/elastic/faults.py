"""Deterministic fault injection: the seeded :class:`FaultSchedule`
(PyTorch port of ``repro/elastic/faults.py``; numpy, copied, so a spec
and a seed give the reference's masks bit for bit).

Every robustness claim in this repo is a reproducible run, not an
anecdote: a fault schedule is a *pure function of (seed, unit, round)* —
no carried RNG state — so the same spec string rebuilds the exact same
drop pattern in a fresh process (the bench subprocess A/B legs rely on
this; test-enforced).  Each query seeds a fresh
``numpy.random.Generator`` from a ``SeedSequence`` over integer
coordinates, so masks can be queried out of order, in parallel, or from
different processes and always agree.

Spec grammar (``--faults`` on launch/train.py, ``faults=`` on the
Simulator) — ``/``-separated clauses, each ``kind:args[@level]``:

    crash:P                 each learner independently dies for good at a
                            Geometric(P)-distributed round (never rejoins)
    flaky[:GRAN]:P[:DOWN]   each GRAN unit (learner | group | pod; default
                            learner) goes down with per-round probability
                            P and rejoins after DOWN rounds (default 1)
    straggler:P[:SLACK]     each learner straggles with per-round
                            probability P, drawing an Exponential delay;
                            it misses every level whose deadline —
                            SLACK x that level's calibrated wall
                            (core/theory.py ``level_reduction_seconds``)
                            — the delay exceeds.  SLACK defaults to 1.5.

An ``@level`` suffix (``crash:0.1@global``) restricts a clause to one
plan level; without it a clause masks every level.  Example: a fleet
with 2% permanent crashes, 20% pod-level flaps lasting 3 rounds, and
10% stragglers against a 1.5x deadline::

    crash:0.02/flaky:pod:0.2:3/straggler:0.1:1.5

The deadline policy: straggler delays are drawn at the scale of the
*largest* level wall (the outermost reduction is the natural sync
horizon), and a straggler misses exactly the levels whose own deadline
is shorter than its delay — so cheap inner reductions are missed more
often than the expensive global one, matching how a real deadline-based
membership service degrades.  With no deadlines supplied every level's
wall defaults to 1.0 (miss probability ``exp(-SLACK)`` per straggler).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.topology import HierTopology

# salts keeping the three fault families' streams disjoint
_SALT_CRASH = 0x63727368
_SALT_FLAKY = 0x666c616b
_SALT_STRAG = 0x73747261

_GRANULARITIES = ("learner", "group", "pod")


def _rng(*coords: int) -> np.random.Generator:
    """A fresh generator keyed by integer coordinates only — the whole
    determinism story (reconstructable from (seed, unit, round) alone)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(c) & 0xFFFFFFFF for c in coords]))


@dataclass(frozen=True)
class FaultClause:
    """One parsed clause of a fault spec string."""

    kind: str                      # "crash" | "flaky" | "straggler"
    p: float                       # per-unit (per-round) probability
    gran: str = "learner"          # flaky granularity
    down: int = 1                  # flaky outage length, rounds
    slack: float = 1.5             # straggler deadline multiplier
    level: Optional[str] = None    # clause restricted to one plan level

    def describe(self) -> str:
        if self.kind == "crash":
            body = f"crash:{self.p:g}"
        elif self.kind == "flaky":
            body = f"flaky:{self.gran}:{self.p:g}:{self.down}"
        else:
            body = f"straggler:{self.p:g}:{self.slack:g}"
        return body + (f"@{self.level}" if self.level else "")


def parse_faults(spec: str) -> Tuple[FaultClause, ...]:
    """Parse the ``/``-separated clause grammar (module docstring)."""
    clauses = []
    for part in str(spec).split("/"):
        part = part.strip()
        if not part:
            continue
        body, _, level = part.partition("@")
        level = level.strip() or None
        args = [a.strip() for a in body.split(":")]
        kind = args.pop(0)
        try:
            if kind == "crash":
                (p,) = args
                clauses.append(FaultClause("crash", float(p), level=level))
            elif kind == "flaky":
                gran = "learner"
                if args and args[0] in _GRANULARITIES:
                    gran = args.pop(0)
                p = float(args.pop(0))
                down = int(args.pop(0)) if args else 1
                if args:
                    raise ValueError(args)
                if down < 1:
                    raise ValueError(f"flaky down must be >= 1, got {down}")
                clauses.append(FaultClause("flaky", p, gran=gran, down=down,
                                           level=level))
            elif kind == "straggler":
                p = float(args.pop(0))
                slack = float(args.pop(0)) if args else 1.5
                if args:
                    raise ValueError(args)
                clauses.append(FaultClause("straggler", p, slack=slack,
                                           level=level))
            else:
                raise ValueError(
                    f"unknown fault kind {kind!r} in clause {part!r}; "
                    f"known: crash / flaky / straggler")
        except (ValueError, TypeError, IndexError) as e:
            if isinstance(e, ValueError) and e.args and \
                    isinstance(e.args[0], str) and "fault" in e.args[0]:
                raise
            raise ValueError(
                f"bad fault clause {part!r} (grammar: crash:P | "
                f"flaky[:learner|group|pod]:P[:down] | "
                f"straggler:P[:slack], each optionally @level)") from e
        if not 0.0 <= clauses[-1].p <= 1.0:
            raise ValueError(
                f"fault probability must be in [0, 1], got {clauses[-1].p} "
                f"in clause {part!r}")
    if not clauses:
        raise ValueError(f"empty fault spec {spec!r}")
    return tuple(clauses)


class FaultSchedule:
    """Per-round, per-level participation masks for one learner fleet.

    ``levels`` are the plan's level names innermost-first (matching the
    ``active[i]`` convention of the elastic ``make_hier_round``);
    ``deadlines`` maps level name -> wall seconds of one reduction at
    that level (price them with ``repro_torch.elastic.level_deadlines(
    plan, topo, template, cm)`` from the calibrated CommModel) and only
    matters for straggler clauses.
    """

    def __init__(self, clauses, topo: HierTopology,
                 levels: Sequence[str], seed: int = 0,
                 deadlines: Optional[Dict[str, float]] = None):
        if isinstance(clauses, str):
            clauses = parse_faults(clauses)
        self.clauses: Tuple[FaultClause, ...] = tuple(clauses)
        self.topo = topo
        self.levels = tuple(levels)
        self.seed = int(seed)
        self.deadlines = {str(k): float(v)
                          for k, v in (deadlines or {}).items()}
        for c in self.clauses:
            if c.level is not None and c.level not in self.levels:
                raise ValueError(
                    f"fault clause {c.describe()!r} names level "
                    f"{c.level!r}, but the plan has {self.levels}")
        # delays are drawn at the scale of the slowest level (the round's
        # natural sync horizon); 1.0 when no calibrated walls were given
        walls = [self.deadlines.get(n, 1.0) for n in self.levels]
        self._delay_scale = max(walls) if walls else 1.0

    # ------------------------------------------------------------------ #
    # per-clause learner masks (True = active), each a pure function of
    # (seed, unit, round)
    # ------------------------------------------------------------------ #

    def _crash_mask(self, c: FaultClause, r: int) -> np.ndarray:
        P = self.topo.n_learners
        up = np.ones(P, bool)
        if c.p <= 0.0:
            return up
        for j in range(P):
            crash_round = _rng(self.seed, _SALT_CRASH, j).geometric(c.p)
            up[j] = r < crash_round
        return up

    def _flaky_unit_count(self, c: FaultClause) -> Tuple[int, int]:
        """(n_units, learners_per_unit) for a flaky granularity."""
        t = self.topo
        if c.gran == "pod":
            return t.pods, t.groups * t.local
        if c.gran == "group":
            return t.pods * t.groups, t.local
        return t.n_learners, 1

    def _flaky_mask(self, c: FaultClause, r: int) -> np.ndarray:
        n_units, per = self._flaky_unit_count(c)
        up = np.ones(n_units, bool)
        if c.p > 0.0:
            for u in range(n_units):
                for r0 in range(max(0, r - c.down + 1), r + 1):
                    if _rng(self.seed, _SALT_FLAKY, u, r0).random() < c.p:
                        up[u] = False
                        break
        return np.repeat(up, per)

    def _straggler_delays(self, c: FaultClause, r: int) -> np.ndarray:
        """Per-learner delay this round (0.0 = on time)."""
        P = self.topo.n_learners
        delays = np.zeros(P)
        if c.p <= 0.0:
            return delays
        for j in range(P):
            g = _rng(self.seed, _SALT_STRAG, j, r)
            if g.random() < c.p:
                delays[j] = g.exponential(scale=self._delay_scale)
        return delays

    # ------------------------------------------------------------------ #
    # the schedule surface
    # ------------------------------------------------------------------ #

    def active(self, r: int) -> np.ndarray:
        """The boolean ``[n_levels, pods, G, S]`` participation mask of
        round ``r`` — exactly what the elastic ``make_hier_round`` takes."""
        r = int(r)
        shape = self.topo.shape
        out = np.ones((len(self.levels),) + shape, bool)
        for c in self.clauses:
            if c.kind == "straggler":
                delays = self._straggler_delays(c, r)
                for i, name in enumerate(self.levels):
                    if c.level is not None and c.level != name:
                        continue
                    deadline = c.slack * self.deadlines.get(name, 1.0)
                    out[i] &= (delays <= deadline).reshape(shape)
                continue
            m = (self._crash_mask(c, r) if c.kind == "crash"
                 else self._flaky_mask(c, r)).reshape(shape)
            for i, name in enumerate(self.levels):
                if c.level is None or c.level == name:
                    out[i] &= m
        return out

    def active_frac(self, r: int) -> np.ndarray:
        """Per-level participation fraction of round ``r``."""
        return self.active(r).reshape(len(self.levels), -1).mean(axis=1)

    def describe(self) -> str:
        return "/".join(c.describe() for c in self.clauses)

    def __repr__(self) -> str:
        return (f"FaultSchedule({self.describe()!r}, seed={self.seed}, "
                f"levels={self.levels})")


def level_deadlines(plan, topo: HierTopology, template,
                    cm=None) -> Dict[str, float]:
    """Price each plan level's deadline base — the scheduled wall of ONE
    reduction at that level under the (calibrated) CommModel — for the
    straggler clauses' ``slack x wall`` policy."""
    from repro_torch.core.theory import level_reduction_seconds
    return {lvl.name: level_reduction_seconds(lvl, topo, template, cm)[2]
            for lvl in plan.levels}
