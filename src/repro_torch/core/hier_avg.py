"""Hier-AVG (Algorithm 1) as a PyTorch trainer, generalized to an N-level
:class:`~repro_torch.core.plan.ReductionPlan` (port of
``repro/core/hier_avg.py``).

A round runs the reference's nest of scans, one per plan level,
innermost first:

    level 0:  p_1 SGD steps, then the level-0 reduction
    level i:  (p_{i+1}/p_i) runs of level i-1, then the level-i reduction

as one Python loop over the round's steps, in which level i reduces
after every p_{i+1} steps (the product of the round batch's step dims
from level i's inward), innermost first; so an inner level's reduction
also runs at an outer boundary (for top-k that updates the inner level's
EF state: it is not a no-op).  The paper's
Algorithm 1 is the 2-level plan ``local@K1 / global@K2``.

Parameters/optimizer state live in the stacked-learner layout
[pods, G, S, *shape]; per-learner gradients come from
``torch.func.vmap(torch.func.grad(loss))`` over the flattened
[pods * G * S] axis (a conv with per-learner weights becomes a grouped
conv).  Each level's reduction is a tensor mean over that level's stacked
axes (core/topology.py), optionally compressed per level by a comm/
Reducer.  Rounds run eagerly and return new tensors; nothing is written
in place, so the caller's state stays valid.

On a mesh of ``torch.distributed`` ranks (repro_torch/parallel) each rank
runs this trainer on its block of the learners: the state holds the
block, each level's reduction sums the ranks by collectives over the
level's process group (core/topology.py), and ``shards=`` (``fsdp > 1``)
takes the bucketed levels through shard-local runs and reduce-scatter +
all-gather.  The ranks of one learner compute its step redundantly.

Elastic rounds (``elastic=True``) take a participation mask per level:
absent learners contribute weight 0 to the level's renormalized mean and
keep their params and EF state untouched.  ``telemetry=`` adds the
device-side statistics of ``repro_torch/telemetry/gradstats.py`` to the
metrics without touching the trajectory.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.comm import DEFAULT_BUCKET_BYTES, Reducer, reduce_with
from repro_torch.configs.base import HierAvgParams
from repro_torch.core.plan import (PlanLike, ReductionLevel, ReductionPlan,
                                   apply_bucketing, apply_shards,
                                   init_comm_state, resolve_plan)
from repro_torch.core.topology import (LEARNER_AXES, HierTopology,
                                       average_over,
                                       stack_like, where_active)
from repro_torch.optim import Optimizer
from repro_torch.tree import leaves, tree_map


class TrainState(NamedTuple):
    params: Any          # leaves [pods, G, S, *shape]
    opt_state: Any       # same stacking
    step: int            # local SGD steps taken
    comm_state: Any = ()  # per-level reducer carry (comm/), keyed by level
                          # name; () when no level is stateful


def init_state(topo: HierTopology, init_fn, optimizer: Optimizer,
               generator: Optional[torch.Generator],
               reducer: Optional[Reducer] = None,
               plan: PlanLike = None,
               bucket_bytes: Optional[int] = None,
               overlap: Optional[bool] = None,
               shards: Optional[Any] = None, *,
               device="cuda") -> TrainState:
    """All learners start from the same w_1 (paper's initialization):
    ``init_fn(generator)`` once, moved to ``device`` and copied to every
    learner.  ``topo`` is the grid of learners this process holds: on a
    mesh of ranks, this rank's block (``RankMesh.block_topology``), with
    the same generator seed on every rank.

    ``plan`` (or legacy ``reducer``) must match what the round/step
    function was built with: stateful reducers carry per-level state in
    ``comm_state`` keyed by level name, in bucket space for bucketed
    levels.  A ``plan`` given as a spec string, or a bare ``reducer``,
    gets the bucketing a default ``HierAvgParams`` resolves to; pass
    ``bucket_bytes`` (0 = per leaf) and/or ``overlap=False`` when the
    round uses other values (the pipelined engine pads multi-bucket
    layouts uniform, so its EF state differs from the serial engine's).
    A ``ReductionPlan`` instance is taken as resolved unless
    ``bucket_bytes`` or ``overlap`` is given: an explicit ``overlap``
    re-chooses the bucket engine.

    ``shards`` (a ``ShardPlan``, fsdp > 1) must be the one the round is
    built with: the EF state then holds this rank's shard rows.
    """
    if shards is not None and shards.mesh.bound:
        for ax, n in zip(LEARNER_AXES, topo.shape):
            if shards.mesh.spread(ax) > 1 and n != 1:
                raise ValueError(f"topology {topo.shape} is not a rank's "
                                 f"block of {shards.mesh}: pass "
                                 f"mesh.block_topology(topo)")
    params = stack_like(topo, tree_map(lambda x: x.to(device),
                                       init_fn(generator)))
    opt_state = optimizer.init(params)
    ov = True if overlap is None else overlap
    if plan is not None:
        if isinstance(plan, ReductionPlan):
            p = apply_shards(plan, shards) \
                if (bucket_bytes is None and overlap is None) \
                else apply_bucketing(
                    plan, 0 if bucket_bytes is None else bucket_bytes, ov,
                    shards=shards)
        else:
            p = apply_bucketing(
                ReductionPlan.parse(plan),
                DEFAULT_BUCKET_BYTES if bucket_bytes is None
                else bucket_bytes, ov, shards=shards)
        comm_state = init_comm_state(p, params)
    elif reducer is not None:
        comm_state = init_comm_state(
            apply_bucketing(ReductionPlan.from_k1_k2(1, 1, reducer),
                            DEFAULT_BUCKET_BYTES if bucket_bytes is None
                            else bucket_bytes, ov, shards=shards), params)
    else:
        comm_state = ()
    return TrainState(params, opt_state, 0, comm_state)


def stacked_grad_fn(loss_fn: Callable):
    """loss_fn(params, batch) -> (loss, metrics), single learner.

    Returns grad_fn(stacked_params, stacked_batch) -> (grads, metrics) where
    grads are per-learner (stacked) and metrics keep the learner axes: the
    gradient of the sum of the per-learner losses, as the reference takes
    it.
    """
    per_learner = torch.func.vmap(torch.func.grad(loss_fn, has_aux=True))

    def grad_fn(params, batch):
        lead = tuple(leaves(params)[0].shape[:3])

        def fold(x):
            return x.reshape((-1,) + tuple(x.shape[3:]))

        def unfold(x):
            return x.reshape(lead + tuple(x.shape[1:]))

        grads, metrics = per_learner(tree_map(fold, params),
                                     tree_map(fold, batch))
        return tree_map(unfold, grads), tree_map(unfold, metrics)

    return grad_fn


def _stack(ms):
    """A list of equal-structure metric trees -> one tree, stacked on a
    new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *ms)


def make_sgd_step(loss_fn: Callable, optimizer: Optimizer,
                  grad_postprocess: Optional[Callable] = None,
                  microbatch: int = 1,
                  grad_observer: Optional[Callable] = None):
    """One local SGD step on all learners concurrently.

    ``microbatch > 1`` splits each learner's per-step batch (dim 3 of every
    leaf, after the [pods, G, S] axes) into that many contiguous slices and
    accumulates fp32 gradients over them — activation memory drops by the
    factor, FLOPs unchanged.

    ``grad_observer`` (telemetry/gradstats.py): a pure function of the
    stacked per-learner gradients returning extra scalar metrics keys —
    a read-only tap, the update itself is untouched.
    """
    grad_fn = stacked_grad_fn(loss_fn)

    def accumulated(state: TrainState, batch):
        def split(x, i):
            b = x.shape[3]
            if b % microbatch:
                raise ValueError(f"per-learner batch {b} does not split "
                                 f"into {microbatch} microbatches")
            y = x.reshape(tuple(x.shape[:3]) + (microbatch, b // microbatch)
                          + tuple(x.shape[4:]))
            return y[:, :, :, i]

        g = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), state.params)
        ms = []
        for i in range(microbatch):
            grads, metrics = grad_fn(state.params,
                                     tree_map(lambda x: split(x, i), batch))
            g = tree_map(lambda a, b: a + b.float(), g, grads)
            ms.append(metrics)
        grads = tree_map(lambda a: a / microbatch, g)
        return grads, tree_map(lambda m: m.mean(0), _stack(ms))

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if microbatch == 1:
            grads, metrics = grad_fn(state.params, batch)
        else:
            grads, metrics = accumulated(state, batch)
        if grad_observer is not None:
            metrics = dict(metrics)
            metrics.update(grad_observer(grads))
        if grad_postprocess is not None:
            grads = grad_postprocess(grads)
        params, opt_state = optimizer.update(grads, state.params,
                                             state.opt_state, state.step)
        return state._replace(params=params, opt_state=opt_state,
                              step=state.step + 1), metrics

    return step


def _round_mesh(mesh, shards):
    """The bound mesh a round runs on (None in one process); a
    ``ShardPlan`` on a mesh of ranks must be laid on that same mesh."""
    mesh = mesh if mesh is not None and mesh.bound else None
    if shards is not None and shards.mesh.bound and shards.mesh is not mesh:
        raise ValueError(f"shards= is laid on {shards.mesh} but the round "
                         f"runs on {mesh}: pass mesh=shards.mesh")
    return mesh


def _make_reduce(mesh, constraint_fn, sync_opt_state: bool):
    """reduce(level, state, active=None) -> state after one compressed
    reduction at that level, touching only that level's comm_state entry.

    ``active`` (elastic membership, repro_torch/elastic): a boolean
    ``[pods, G, S]`` participation mask on the state's device (on a mesh
    of ranks the whole grid's).  The grouped mean renormalizes over the
    present learners only (core/topology.py ``average_over``), and absent
    learners keep their own params AND their EF/``comm_state`` untouched
    across the missed fire (``where_active``, on this rank's block).
    ``active=None`` is the dense path.  ``mesh``: the bound mesh of
    ranks the reductions run on, or None in one process."""

    def reduce(level: ReductionLevel, state: TrainState,
               active=None) -> TrainState:
        avg_fn = lambda tree, cf=None, specs=None: average_over(  # noqa: E731
            tree, level.axes, cf, specs, active, mesh)
        mine = active if active is None or mesh is None \
            else mesh.take_block(active)
        if level.reducer.stateful:
            params, lvl_cs = reduce_with(level.reducer, avg_fn, state.params,
                                         state.comm_state[level.name],
                                         constraint_fn)
            if active is not None:
                lvl_cs = where_active(mine, lvl_cs,
                                      state.comm_state[level.name])
            comm_state = dict(state.comm_state)
            comm_state[level.name] = lvl_cs
        else:
            params, _ = reduce_with(level.reducer, avg_fn, state.params, (),
                                    constraint_fn)
            comm_state = state.comm_state
        if active is not None:
            params = where_active(mine, params, state.params)
        if sync_opt_state:
            opt = avg_fn(state.opt_state, constraint_fn)
            if active is not None:
                opt = where_active(mine, opt, state.opt_state)
            state = state._replace(opt_state=opt)
        return state._replace(params=params, comm_state=comm_state)

    return reduce


def _device_masks(active, n_levels: int, params, mesh=None) -> torch.Tensor:
    """The ``[n_levels, pods, G, S]`` participation mask (the whole grid's
    on a mesh of ranks) as a bool tensor on the params' device (a host
    mask goes up through pinned memory, without a synchronize)."""
    lead = tuple(leaves(params)[0].shape[:3])
    if mesh is not None:
        lead = tuple(n * mesh.spread(ax) for n, ax in
                     zip(lead, LEARNER_AXES))
    m = torch.as_tensor(active, dtype=torch.bool)
    if tuple(m.shape) != (n_levels,) + lead:
        raise ValueError(f"active mask must be [n_levels, pods, G, S] = "
                         f"{(n_levels,) + lead}, got {tuple(m.shape)}")
    dev = leaves(params)[0].device
    if m.device == dev:
        return m
    if dev.type == "cuda" and m.device.type == "cpu":
        return m.pin_memory().to(dev, non_blocking=True)
    return m.to(dev)


def make_hier_round(loss_fn: Callable, optimizer: Optimizer,
                    hier: HierAvgParams, *,
                    sync_opt_state: bool = False,
                    skip_local: bool = False,
                    mesh: Optional[Any] = None,
                    constraint_fn: Optional[Callable] = None,
                    grad_postprocess: Optional[Callable] = None,
                    microbatch: int = 1,
                    reducer: Optional[Any] = None,
                    plan: PlanLike = None,
                    shards: Optional[Any] = None,
                    elastic: bool = False,
                    telemetry: Any = None):
    """Build the Hier-AVG round for an N-level reduction plan.

    round(state, round_batch) -> (state, metrics); round_batch leaves are
    shaped [*hier.batch_dims, pods, G, S, *per_learner_batch] — for the
    legacy 2-level plan that is the familiar [beta, K1, ...]; metrics are
    scalar means over the round.

    ``elastic=True`` builds the participation-masked round instead:
    ``round(state, round_batch, active) -> (state, metrics)`` with
    ``active`` a boolean ``[n_levels, pods, G, S]`` mask (tensor or numpy;
    level *i* of the plan, innermost first, uses ``active[i]`` for every
    one of its fires this round).  Absent learners contribute weight 0 to
    that level's renormalized mean and keep their params and EF state
    untouched (see ``_make_reduce``); metrics gain
    ``active_frac/<level>``.  With an all-true mask the round equals the
    dense build bit for bit.

    ``plan`` — a ReductionPlan, a spec string, or None to use
    ``hier.plan`` / the legacy 2-level plan from ``hier.k1``/``hier.k2``.
    ``skip_local=True`` skips every reduction except the outermost (for
    the 2-level plan this turns the round into K-AVG with K = K2).
    ``sync_opt_state`` additionally averages optimizer state at each
    reduction.  ``reducer`` replaces the reducer of EVERY level.  Stateful
    reducers carry ``TrainState.comm_state`` keyed by level name — build
    the initial state with ``init_state(..., plan=...)``.

    ``telemetry`` (repro_torch/telemetry): ``True`` or a
    ``TelemetryConfig`` adds device-side statistics to the metrics
    (``telemetry/...`` keys, each a mean over the round's fires or
    steps): per-level pre/post-average divergence, codec error, EF mass
    and the cross-learner gradient-norm variance.  Pure observers: the
    trajectory is bit for bit that of ``telemetry=None``.

    On a mesh of ranks: ``mesh`` (a bound ``RankMesh``) is the one the
    levels reduce over, ``constraint_fn`` (parallel/sharding.py
    ``make_constraint_fn``) checks each reduction's block shapes, and
    ``shards`` (a ``ShardPlan`` on ``mesh``, fsdp > 1) packs the bucketed
    levels shard-locally and runs their means as reduce-scatter +
    all-gather; pass the same ``shards`` to ``init_state``.  ``state``
    and ``round_batch`` hold this rank's block of the learners, ``active``
    the whole grid's mask, and the metrics are means over the block, but
    for the ``telemetry/...`` keys: those are the whole grid's, equal on
    every rank (telemetry/gradstats.py takes the level groups' means and
    the per-learner totals across ranks).
    """
    from repro_torch.telemetry.gradstats import (level_stats,
                                                 make_grad_observer,
                                                 resolve_telemetry)
    mesh = _round_mesh(mesh, shards)
    tcfg = resolve_telemetry(telemetry)
    p = resolve_plan(hier, reducer, plan, shards=shards)
    sgd_step = make_sgd_step(loss_fn, optimizer, grad_postprocess,
                             microbatch=microbatch,
                             grad_observer=make_grad_observer(
                                 tcfg, p.levels, mesh) if tcfg else None)
    _reduce = _make_reduce(mesh, constraint_fn, sync_opt_state)
    last = len(p.levels) - 1
    n_dims = len(p.batch_dims)

    def run(state: TrainState, round_batch, active):
        # the loop nest, flattened: level i runs over the round batch's
        # dim n-1-i, so it reduces after every prod(dims[n-1-i:]) steps,
        # innermost first.  One frame holds the running state, so a round
        # keeps no earlier state alive but the caller's (a nest of calls
        # would hold one state per level)
        dims = tuple(leaves(round_batch)[0].shape[:n_dims])
        every = [math.prod(dims[n_dims - 1 - i:]) for i in range(n_dims)]
        steps = tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[n_dims:])),
                         round_batch)
        ms = []
        stats: Dict[str, list] = {}
        for t in range(math.prod(dims)):
            state, m = sgd_step(state, tree_map(lambda x: x[t], steps))
            ms.append(m)
            for i, level in enumerate(p.levels):
                if (t + 1) % every[i]:
                    break
                if skip_local and i < last:
                    continue
                # the pre-fire params are held only for the statistics,
                # and never into the next step
                pre = state.params if tcfg is not None else None
                state = _reduce(level, state,
                                None if active is None else active[i])
                if tcfg is not None:
                    # absent learners keep their (stale) params and
                    # count toward divergence, as in the reference
                    for k, v in level_stats(tcfg, level, pre, state.params,
                                            state.comm_state, mesh).items():
                        stats.setdefault(k, []).append(v)
                    pre = None
        # metrics leaves: [steps, pods, G, S] -> scalar means; a level's
        # statistics: the mean over its fires
        metrics = tree_map(lambda m: m.mean(), _stack(ms))
        metrics.update({k: torch.stack(v).mean() for k, v in stats.items()})
        return state, metrics

    if not elastic:
        def round_fn(state: TrainState, round_batch):
            return run(state, round_batch, None)

        return round_fn

    def elastic_round_fn(state: TrainState, round_batch, active):
        active = _device_masks(active, len(p.levels), state.params, mesh)
        state, metrics = run(state, round_batch, active)
        for i, lvl in enumerate(p.levels):
            metrics[f"active_frac/{lvl.name}"] = active[i].float().mean()
        return state, metrics

    return elastic_round_fn


# --------------------------------------------------------------------- #
# step-wise API (serving-style loops / adaptive schedules)
# --------------------------------------------------------------------- #

def make_hier_step(loss_fn: Callable, optimizer: Optimizer,
                   hier: HierAvgParams, *,
                   skip_local: bool = False,
                   mesh: Optional[Any] = None,
                   constraint_fn: Optional[Callable] = None,
                   reducer: Optional[Any] = None,
                   plan: PlanLike = None,
                   shards: Optional[Any] = None,
                   elastic: bool = False):
    """Single-step variant: per-level firing on the step counter.

    ``elastic=True`` builds ``step(state, batch, active)`` with ``active``
    a boolean ``[n_levels, pods, G, S]`` participation mask; a firing
    level reduces over its present learners only, and absent learners
    keep their params/EF untouched (same semantics as the elastic
    ``make_hier_round``).  An all-true mask equals the dense build bit
    for bit.

    Level i fires when ``t % period_i == 0`` and the next level does NOT
    fire (an outer reduction subsumes all inner ones at the same step);
    the outermost level fires whenever its period divides t.  Equal to
    the round API for stateless reducers; for error-feedback reducers the
    round API also reduces inner levels at outer boundaries, so the two
    trajectories differ by the compression of an already-averaged delta.

    ``mesh``, ``constraint_fn`` and ``shards`` run it on a mesh of
    ranks, as in ``make_hier_round``.
    """
    mesh = _round_mesh(mesh, shards)
    sgd_step = make_sgd_step(loss_fn, optimizer)
    p = resolve_plan(hier, reducer, plan, shards=shards)
    _reduce = _make_reduce(mesh, constraint_fn, False)
    last = len(p.levels) - 1

    def step(state: TrainState, batch, active=None
             ) -> Tuple[TrainState, Dict]:
        if elastic:
            if active is None:
                raise ValueError("the elastic step needs the "
                                 "[n_levels, pods, G, S] active mask")
            active = _device_masks(active, len(p.levels), state.params,
                                   mesh)
        state, metrics = sgd_step(state, batch)
        t = state.step  # steps completed
        for i, level in enumerate(p.levels):
            if skip_local and i < last:
                continue
            fire = t % level.period == 0
            if i < last:
                fire = fire and t % p.levels[i + 1].period != 0
            if fire:
                state = _reduce(level, state,
                                active[i] if elastic else None)
        return state, metrics

    return step


# --------------------------------------------------------------------- #
# batch reshaping helpers
# --------------------------------------------------------------------- #

def round_batch_shape(hier: HierAvgParams, topo: HierTopology,
                      per_learner_batch: int) -> Tuple[int, ...]:
    return hier.batch_dims + topo.shape + (per_learner_batch,)


def shard_round_batch(batch, hier: HierAvgParams, topo: HierTopology):
    """Reshape leaves [steps*P*B, ...] -> [*batch_dims, pods, G, S, B, ...]."""
    def rs(x):
        total = hier.steps_per_round * topo.n_learners
        b = x.shape[0] // total
        return x.reshape(hier.batch_dims + topo.shape + (b,)
                         + tuple(x.shape[1:]))
    return tree_map(rs, batch)


def state_rows(state: TrainState, plan: ReductionPlan) -> TrainState:
    """Which leaves of ``state`` are shard rows (the codec view of a
    shard-aware level's sharded buckets), as a tree of bools: the
    ``rows=`` a checkpoint of a rank's block takes
    (checkpoint/checkpoint.py ``save_checkpoint(mesh=)``).  ``plan`` is
    the resolved plan the state was built with (``shards=`` included)."""
    def no(tree):
        return tree_map(lambda _: False, tree)

    cs = state.comm_state
    if cs and cs != ():
        rows = {}
        for lvl in plan.levels:
            if lvl.name not in cs:
                continue
            r = lvl.reducer
            rows[lvl.name] = (r.state_rows(cs[lvl.name], state.params)
                              if getattr(r, "shards", None) is not None
                              else no(cs[lvl.name]))
        cs = rows
    return TrainState(no(state.params), no(state.opt_state), False, cs)
