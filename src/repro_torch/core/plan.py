"""N-level reduction hierarchy: the ``ReductionPlan`` (PyTorch port of
``repro/core/plan.py``).

The paper's Algorithm 1 is the 2-level special case (cluster-local every K1
steps, global every K2) of a general hierarchy: an ordered list of
:class:`ReductionLevel` entries, each naming a scope (which stacked learner
axes it averages over), a period (how many SGD steps between its
reductions), and a reducer (what each learner puts on the wire at that
level — see comm/).  A 3-level plan looks like

    local@4:cast:bfloat16 / pod@8:mean / global@16:topk:0.05:perleaf

Nesting is validated: each level's axes must contain the previous level's,
and each period must divide the next.  :func:`apply_bucketing` wraps the
compressed levels in the bucket engine (comm/bucket.py), as the
reference's ``HierAvgParams.bucket_bytes`` and ``overlap`` knobs say.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple, Union

from repro_torch.comm import (DEFAULT_BUCKET_BYTES, Bucketed, Pipelined,
                              Reducer, get_reducer)
from repro_torch.core.topology import (GLOBAL_ARRAY_AXES, LOCAL_ARRAY_AXES,
                                       POD_ARRAY_AXES)

# level name -> stacked array axes the reduction averages over
LEVEL_AXES = {
    "local": LOCAL_ARRAY_AXES,     # within each cluster of S learners
    "pod": POD_ARRAY_AXES,         # all learners of one pod
    "global": GLOBAL_ARRAY_AXES,   # all P learners
}


@dataclass(frozen=True, eq=False)
class ReductionLevel:
    """One rung of the hierarchy.

    ``axes`` are stacked-learner array axes (core/topology.py);
    ``period`` is in SGD steps; ``reducer`` is a comm/ Reducer instance.
    """

    name: str
    axes: Tuple[int, ...]
    period: int
    reducer: Reducer

    def describe(self) -> str:
        return f"{self.name}@{self.period}:{self.reducer.describe()}"

    def __repr__(self) -> str:
        return f"ReductionLevel({self.describe()})"


PlanLike = Union["ReductionPlan", str, None]


@dataclass(frozen=True, eq=False)
class ReductionPlan:
    """Ordered (innermost -> outermost) reduction levels.

    Invariants enforced at construction:
      * at least one level, unique known names (local / pod / global);
      * scopes nest: level i's axes are a superset of level i-1's;
      * periods nest: each level's period divides the next level's.
    """

    levels: Tuple[ReductionLevel, ...]

    def __post_init__(self):
        if not self.levels:
            raise ValueError("a ReductionPlan needs at least one level")
        names = [lvl.name for lvl in self.levels]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate level names in plan: {names}")
        for lvl in self.levels:
            if lvl.name not in LEVEL_AXES:
                raise ValueError(
                    f"unknown level name {lvl.name!r}; "
                    f"known: {sorted(LEVEL_AXES)}")
            if lvl.period < 1:
                raise ValueError(
                    f"level {lvl.name!r} period must be >= 1, "
                    f"got {lvl.period}")
        for lo, hi in zip(self.levels, self.levels[1:]):
            if not set(hi.axes) >= set(lo.axes):
                raise ValueError(
                    f"level {hi.name!r} axes {hi.axes} must contain "
                    f"inner level {lo.name!r} axes {lo.axes}")
            if hi.period % lo.period != 0:
                raise ValueError(
                    f"level {lo.name!r} period {lo.period} must divide "
                    f"level {hi.name!r} period {hi.period}")

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #

    @classmethod
    def parse(cls, spec: str) -> "ReductionPlan":
        """``"name@period[:reducer_spec]"`` entries joined by ``/``, e.g.
        ``"local@4:cast:bfloat16/pod@8/global@16:topk:0.05"`` (reducer
        defaults to ``mean``)."""
        levels = []
        for part in str(spec).split("/"):
            part = part.strip()
            if "@" not in part:
                raise ValueError(
                    f"bad plan entry {part!r}: expected name@period"
                    f"[:reducer_spec]")
            name, _, rest = part.partition("@")
            period_s, _, red_spec = rest.partition(":")
            try:
                period = int(period_s)
            except ValueError:
                raise ValueError(
                    f"bad period {period_s!r} in plan entry {part!r}")
            name = name.strip()
            axes = LEVEL_AXES.get(name)
            if axes is None:
                raise ValueError(
                    f"unknown level name {name!r} in plan entry {part!r}; "
                    f"known: {sorted(LEVEL_AXES)}")
            levels.append(ReductionLevel(
                name=name, axes=axes, period=period,
                reducer=get_reducer(red_spec or "mean")))
        return cls(tuple(levels))

    @classmethod
    def from_k1_k2(cls, k1: int, k2: int, reducer="mean") -> "ReductionPlan":
        """The paper's 2-level hierarchy (Algorithm 1): cluster-local every
        K1 steps, global every K2, one reducer for both."""
        red = get_reducer(reducer)
        return cls((
            ReductionLevel("local", LEVEL_AXES["local"], k1, red),
            ReductionLevel("global", LEVEL_AXES["global"], k2, red),
        ))

    # ------------------------------------------------------------------ #
    # derived shape / schedule facts
    # ------------------------------------------------------------------ #

    @property
    def total_period(self) -> int:
        """SGD steps per round (the outermost level's period)."""
        return self.levels[-1].period

    @property
    def batch_dims(self) -> Tuple[int, ...]:
        """Leading round-batch dims, outermost ratio first:
        (p_N/p_{N-1}, ..., p_2/p_1, p_1).  2-level == (beta, K1)."""
        dims = [self.levels[0].period]
        for lo, hi in zip(self.levels, self.levels[1:]):
            dims.append(hi.period // lo.period)
        return tuple(reversed(dims))

    def counts_per_round(self) -> Tuple[Tuple[str, int], ...]:
        """(name, billable reductions per round) per level.  A reduction
        coinciding with an outer level's is not counted (the wire bill);
        the round still runs it (for error-feedback reducers it updates
        that level's EF state)."""
        N = self.total_period
        out = []
        for i, lvl in enumerate(self.levels):
            n = N // lvl.period
            if i + 1 < len(self.levels):
                n -= N // self.levels[i + 1].period
            out.append((lvl.name, n))
        return tuple(out)

    # ------------------------------------------------------------------ #
    # derivation
    # ------------------------------------------------------------------ #

    def with_outer_period(self, period: int) -> "ReductionPlan":
        """Same plan with the outermost period replaced (inner levels
        fixed)."""
        outer = replace(self.levels[-1], period=period)
        return ReductionPlan(self.levels[:-1] + (outer,))

    def with_periods(self, periods) -> "ReductionPlan":
        """Same levels/reducers with EVERY period replaced (innermost
        first); nesting is re-validated by the constructor."""
        periods = tuple(int(p) for p in periods)
        if len(periods) != len(self.levels):
            raise ValueError(
                f"need {len(self.levels)} periods (one per level), "
                f"got {periods}")
        return ReductionPlan(tuple(
            replace(lvl, period=p)
            for lvl, p in zip(self.levels, periods)))

    def with_reducer(self, reducer) -> "ReductionPlan":
        """Same schedule with every level's reducer replaced (the legacy
        single-``reducer`` override)."""
        red = get_reducer(reducer)
        return ReductionPlan(tuple(replace(lvl, reducer=red)
                                   for lvl in self.levels))

    def describe(self) -> str:
        return "/".join(lvl.describe() for lvl in self.levels)

    def __repr__(self) -> str:
        return f"ReductionPlan({self.describe()})"


def apply_bucketing(plan: ReductionPlan, bucket_bytes: int,
                    overlap: bool = True, shards=None) -> ReductionPlan:
    """Wrap each level's reducer in a bucket engine (comm/bucket.py):
    :class:`~repro_torch.comm.Pipelined` when ``overlap`` is on, plain
    :class:`~repro_torch.comm.Bucketed` (serial) otherwise.

    Per level: reducers marked ``:perleaf`` stay per leaf;
    ``bucket_by_default`` codecs (cast / topk / randk / qint8) are wrapped
    when ``bucket_bytes > 0``; reducers already wrapped (``:bucketed``)
    keep their wrapper and inherit this cap unless built with their own.
    The dense mean and PowerSGD stay per leaf unless marked.  An explicit
    ``:pipelined`` stays pipelined with ``overlap=False`` and a
    ``:serial`` pin stays serial with ``overlap=True``; a wrapper that an
    earlier resolution chose follows the current ``overlap``.

    ``shards`` (a ``ShardPlan`` of an ``fsdp > 1`` mesh, or None) is
    threaded into every bucket engine, so layouts pack per-shard runs and
    the grouped means run as reduce-scatter + all-gather; wrappers
    carrying another ShardPlan are rebuilt.
    """
    levels, changed = [], False
    for lvl in plan.levels:
        r = lvl.reducer
        new = r
        if isinstance(r, Bucketed):
            if isinstance(r, Pipelined) and r.pipeline_pin:
                engine = Pipelined           # explicit :pipelined wins
            elif r.overlap_opt_out or r.inner.overlap_opt_out:
                engine = Bucketed            # explicit :serial pin
            else:
                engine = Pipelined if overlap else Bucketed
            cap = r.bucket_bytes
            if (cap is None and bucket_bytes and bucket_bytes > 0
                    and bucket_bytes != r.effective_bucket_bytes):
                cap = bucket_bytes
            want_shards = shards if shards is not None else r.shards
            if (type(r) is not engine or cap != r.bucket_bytes
                    or want_shards is not r.shards):
                new = engine(r.inner, cap, shards=want_shards)
                new.overlap_opt_out = r.overlap_opt_out
                new.pipeline_pin = r.pipeline_pin
        elif (bucket_bytes and bucket_bytes > 0
                and r.bucket_by_default and not r.bucket_opt_out):
            engine = Pipelined if (overlap and not r.overlap_opt_out) \
                else Bucketed
            # a ':serial' pin stays visible as new.inner.overlap_opt_out
            new = engine(r, bucket_bytes, shards=shards)
        if new is not r:
            lvl = replace(lvl, reducer=new)
            changed = True
        levels.append(lvl)
    return ReductionPlan(tuple(levels)) if changed else plan


def apply_shards(plan: ReductionPlan, shards) -> ReductionPlan:
    """Thread a ``ShardPlan`` into an already-resolved plan's bucket
    engines, keeping each level's engine and cap (for callers holding a
    ``ReductionPlan`` instance).  ``shards=None`` is a no-op."""
    if shards is None:
        return plan
    levels, changed = [], False
    for lvl in plan.levels:
        r = lvl.reducer
        if isinstance(r, Bucketed) and r.shards is not shards:
            new = type(r)(r.inner, r.bucket_bytes, shards=shards)
            new.overlap_opt_out = r.overlap_opt_out
            new.pipeline_pin = r.pipeline_pin
            lvl = replace(lvl, reducer=new)
            changed = True
        levels.append(lvl)
    return ReductionPlan(tuple(levels)) if changed else plan


def resolve_plan(hier, reducer=None, plan: PlanLike = None,
                 shards=None) -> ReductionPlan:
    """The plan a round/step builder actually uses.

    Precedence: explicit ``plan`` argument (instance or spec string), then
    ``hier.plan``, then the legacy 2-level plan from ``hier.k1``/``hier.k2``.
    An explicit ``reducer`` (spec or instance) overrides the reducer of
    EVERY level.  Finally ``hier.bucket_bytes`` buckets the compressed
    levels (:func:`apply_bucketing`), on the pipelined schedule unless
    ``hier.overlap`` is off, so round builders, state init and payload
    accounting agree on the packed layout.
    """
    if plan is None:
        plan = getattr(hier, "plan", None)
    if plan is None:
        p = ReductionPlan.from_k1_k2(
            hier.k1, hier.k2, getattr(hier, "reducer", "mean"))
    elif isinstance(plan, ReductionPlan):
        p = plan
    else:
        p = ReductionPlan.parse(plan)
    if reducer is not None:
        p = p.with_reducer(reducer)
    return apply_bucketing(
        p, getattr(hier, "bucket_bytes", DEFAULT_BUCKET_BYTES),
        getattr(hier, "overlap", True), shards=shards)


def init_comm_state(plan: ReductionPlan, params):
    """Per-level reducer carry keyed by level name (stateful levels only —
    top-k error feedback at the local level must not pollute global EF).
    All-stateless plans keep ``()``."""
    state = {lvl.name: lvl.reducer.init_state(params)
             for lvl in plan.levels if lvl.reducer.stateful}
    return state if state else ()
