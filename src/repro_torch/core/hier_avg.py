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
from repro_torch.core.topology import HierTopology, average_over, stack_like
from repro_torch.optim import Optimizer
from repro_torch.tree import leaves, tree_map


class TrainState(NamedTuple):
    params: Any          # leaves [pods, G, S, *shape]
    opt_state: Any       # same stacking
    step: int            # local SGD steps taken
    comm_state: Any = ()  # per-level reducer carry (comm/), keyed by level
                          # name; () when no level is stateful


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP Queue 1 "
                              f"item {item}")


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
    learner.

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
    """
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
                  microbatch: int = 1):
    """One local SGD step on all learners concurrently.

    ``microbatch > 1`` splits each learner's per-step batch (dim 3 of every
    leaf, after the [pods, G, S] axes) into that many contiguous slices and
    accumulates fp32 gradients over them — activation memory drops by the
    factor, FLOPs unchanged.
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
        if grad_postprocess is not None:
            grads = grad_postprocess(grads)
        params, opt_state = optimizer.update(grads, state.params,
                                             state.opt_state, state.step)
        return state._replace(params=params, opt_state=opt_state,
                              step=state.step + 1), metrics

    return step


def _make_reduce(sync_opt_state: bool):
    """reduce(level, state) -> state after one compressed reduction at
    that level, touching only that level's comm_state entry."""

    def reduce(level: ReductionLevel, state: TrainState) -> TrainState:
        avg_fn = lambda tree, cf=None: average_over(tree, level.axes)  # noqa: E731
        if level.reducer.stateful:
            params, lvl_cs = reduce_with(level.reducer, avg_fn, state.params,
                                         state.comm_state[level.name])
            comm_state = dict(state.comm_state)
            comm_state[level.name] = lvl_cs
        else:
            params, _ = reduce_with(level.reducer, avg_fn, state.params, ())
            comm_state = state.comm_state
        if sync_opt_state:
            state = state._replace(opt_state=avg_fn(state.opt_state))
        return state._replace(params=params, comm_state=comm_state)

    return reduce


def _refuse_unported(constraint_fn, shards, elastic, telemetry):
    if constraint_fn is not None:
        _not_ported("constraint_fn (GSPMD sharding hints)", "7")
    if shards is not None:
        _not_ported("shards= (fsdp layouts)", "7")
    if elastic:
        _not_ported("elastic=True (participation masks)", "5")
    if telemetry:
        _not_ported("telemetry=", "5")


def make_hier_round(loss_fn: Callable, optimizer: Optimizer,
                    hier: HierAvgParams, *,
                    sync_opt_state: bool = False,
                    skip_local: bool = False,
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

    ``plan`` — a ReductionPlan, a spec string, or None to use
    ``hier.plan`` / the legacy 2-level plan from ``hier.k1``/``hier.k2``.
    ``skip_local=True`` skips every reduction except the outermost (for
    the 2-level plan this turns the round into K-AVG with K = K2).
    ``sync_opt_state`` additionally averages optimizer state at each
    reduction.  ``reducer`` replaces the reducer of EVERY level.  Stateful
    reducers carry ``TrainState.comm_state`` keyed by level name — build
    the initial state with ``init_state(..., plan=...)``.

    Not ported yet, and refused: ``constraint_fn`` and ``shards`` (ROADMAP
    Queue 1 item 7), ``elastic`` and ``telemetry`` (item 5).
    """
    _refuse_unported(constraint_fn, shards, elastic, telemetry)
    p = resolve_plan(hier, reducer, plan)
    sgd_step = make_sgd_step(loss_fn, optimizer, grad_postprocess,
                             microbatch=microbatch)
    _reduce = _make_reduce(sync_opt_state)
    last = len(p.levels) - 1
    n_dims = len(p.batch_dims)

    def round_fn(state: TrainState, round_batch):
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
        for t in range(math.prod(dims)):
            state, m = sgd_step(state, tree_map(lambda x: x[t], steps))
            ms.append(m)
            for i, level in enumerate(p.levels):
                if (t + 1) % every[i]:
                    break
                if not (skip_local and i < last):
                    state = _reduce(level, state)
        # metrics leaves: [steps, pods, G, S] -> scalar means
        return state, tree_map(lambda m: m.mean(), _stack(ms))

    return round_fn


# --------------------------------------------------------------------- #
# step-wise API (serving-style loops / adaptive schedules)
# --------------------------------------------------------------------- #

def make_hier_step(loss_fn: Callable, optimizer: Optimizer,
                   hier: HierAvgParams, *,
                   skip_local: bool = False,
                   constraint_fn: Optional[Callable] = None,
                   reducer: Optional[Any] = None,
                   plan: PlanLike = None,
                   shards: Optional[Any] = None,
                   elastic: bool = False):
    """Single-step variant: per-level firing on the step counter.

    Level i fires when ``t % period_i == 0`` and the next level does NOT
    fire (an outer reduction subsumes all inner ones at the same step);
    the outermost level fires whenever its period divides t.  Equal to
    the round API for stateless reducers; for error-feedback reducers the
    round API also reduces inner levels at outer boundaries, so the two
    trajectories differ by the compression of an already-averaged delta.
    """
    _refuse_unported(constraint_fn, shards, elastic, None)
    sgd_step = make_sgd_step(loss_fn, optimizer)
    p = resolve_plan(hier, reducer, plan)
    _reduce = _make_reduce(False)
    last = len(p.levels) - 1

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        state, metrics = sgd_step(state, batch)
        t = state.step  # steps completed
        for i, level in enumerate(p.levels):
            if skip_local and i < last:
                continue
            fire = t % level.period == 0
            if i < last:
                fire = fire and t % p.levels[i + 1].period != 0
            if fire:
                state = _reduce(level, state)
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
