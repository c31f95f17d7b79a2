"""Device-side gradient/parameter statistics inside the round (PyTorch
port of ``repro/telemetry/gradstats.py``).

Everything here is a few fp32 tensor reductions on the device, added to
the round behind the opt-in ``telemetry=`` knob on ``make_hier_round`` —
pure OBSERVERS: no statistic writes into params/opt_state/EF, runs an
in-place op on them or draws from a generator, so a telemetry-on round
is bit-identical in losses and params to telemetry-off.  The stats land
as extra scalar keys in the round's metrics dict, each the mean over the
round's fires (or steps):

* ``telemetry/div_pre/<level>`` / ``div_post/<level>`` — mean over the
  level's learners of the squared distance to the level-group mean,
  summed over the parameter tree.  ``div_pre`` is the paper's Theorem
  3.2 pre-average discrepancy (the quantity Local SGD analyses bound —
  Stich 1805.09767); ``div_post`` shows what the reduction left behind
  (0 for an exact mean, > 0 under lossy codecs);
* ``telemetry/grad_norm_var/<level>`` — cross-learner variance of the
  per-learner squared gradient norm within the level's averaging
  groups: the Adaptive Periodic Averaging trigger signal (Jiang &
  Agrawal 2007.06134 — stretch periods when gradients agree, shrink
  when they diverge), plus ``telemetry/grad_sq_norm`` (fleet mean);
* ``telemetry/ef_mass/<level>`` — squared mass of the level's
  error-feedback residual (the untransmitted delta a sparse codec
  carries forward);
* ``telemetry/codec_err/<level>`` — relative squared error of the
  post-reduction params against the exact dense group mean of the
  pre-reduction params: the compression error the level's codec
  actually introduced this fire (~0 for the identity mean).

On a mesh of ranks (``mesh=``, a bound ``RankMesh``; each rank holds a
block of the learners) every statistic is the reference's global one,
equal on every rank:

* a level group's mean is the in-rank sum over the level's axes, one
  all-reduce of every leaf's sums over the level's process group, and
  the division by the group's size (as ``core/topology.py::_rank_means``
  takes it);
* the per-learner totals (squared distances, squared norms) of the
  rank's block are laid into the whole ``[pods, G, S]`` grid, zeros
  elsewhere, and one all-reduce over the learner axes' group assembles
  the grid exactly (each entry has one contributor), so the mean over
  the P learners is the one-process formula on the same numbers;
* the parameters and gradients of one learner are whole on each of its
  fsdp ranks, so those sums run over the learner axes only and every
  fsdp slice reads the same value; an EF state's shard rows (the codec
  view of a sharded bucket) are summed over the fsdp ranks too, so each
  learner's shard row counts once, and its flat rows (whole on every
  fsdp rank) once.

Every collective goes through ``parallel/collectives.py`` and is
counted; with telemetry off none is made.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

from repro_torch.parallel.sharding import LEARNER_MESH_AXES
from repro_torch.tree import leaves


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Which device-side statistics the round computes (all on by
    default; each adds a handful of fused reductions per level fire)."""

    divergence: bool = True     # div_pre / div_post per level
    grad_var: bool = True       # grad_norm_var per level + grad_sq_norm
    ef_mass: bool = True        # EF residual mass per stateful level
    codec_err: bool = True      # codec error vs the exact dense mean


TelemetryKnob = Union[None, bool, TelemetryConfig]


def resolve_telemetry(knob: TelemetryKnob) -> Optional[TelemetryConfig]:
    """``None``/``False`` -> off; ``True`` -> all stats; a
    :class:`TelemetryConfig` passes through."""
    if knob is None or knob is False:
        return None
    if knob is True:
        return TelemetryConfig()
    if isinstance(knob, TelemetryConfig):
        return knob
    raise TypeError(
        f"telemetry= wants None/bool/TelemetryConfig, got {knob!r}")


def _per_learner_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the trailing dims of a stacked ``[pods, G, S, *shape]``
    leaf: the ``[pods, G, S]`` per-learner totals."""
    return x.reshape(tuple(x.shape[:3]) + (-1,)).sum(-1)


def _zero(tree) -> torch.Tensor:
    ls = leaves(tree)
    dev = ls[0].device if ls else "cpu"
    return torch.zeros((), dtype=torch.float32, device=dev)


def _on_ranks(mesh, axes: Sequence[int] = (0, 1, 2)) -> bool:
    """Whether any of the learner ``axes`` is spread over the ranks of
    ``mesh`` (None: one process)."""
    return mesh is not None and any(
        mesh.spread(LEARNER_MESH_AXES[a]) > 1 for a in axes)


def _grid(t: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """The whole grid of a rank's per-learner values ``t`` (dims
    ``dim..dim+2`` its ``[pods, G, S]`` block): the block laid into
    zeros at its coordinates, summed over the learner axes' group by one
    all-reduce.  Each entry has one contributor, so the grid is exact."""
    if not _on_ranks(mesh):
        return t
    from repro_torch.parallel import collectives
    shape = list(t.shape)
    for i, ax in enumerate(LEARNER_MESH_AXES):
        shape[dim + i] *= mesh.spread(ax)
    g = torch.zeros(shape, dtype=t.dtype, device=t.device)
    view = g
    for i, ax in enumerate(LEARNER_MESH_AXES):
        if mesh.spread(ax) > 1:
            view = view.narrow(dim + i, mesh.coord(ax), 1)
    view.copy_(t)
    return collectives.all_reduce(g, mesh.process_group(LEARNER_MESH_AXES))


def _group_means(xs: List[torch.Tensor], axes: Sequence[int], mesh
                 ) -> List[torch.Tensor]:
    """The mean of each (fp32) tensor of ``xs`` over the learner ``axes``
    (kept, size 1): in one process ``x.mean``; across ranks the in-rank
    sums, one all-reduce of every tensor's sums over the level's group,
    and the division by the group's size."""
    axes = tuple(axes)
    if not _on_ranks(mesh, axes):
        return [x.mean(dim=axes, keepdim=True) for x in xs]
    from repro_torch.parallel import collectives
    sums = [x.sum(dim=axes, keepdim=True) for x in xs]
    flat = torch.cat([s.reshape(-1) for s in sums])
    collectives.all_reduce(flat, mesh.process_group(
        tuple(LEARNER_MESH_AXES[a] for a in axes)))
    n = math.prod(xs[0].shape[a] * mesh.spread(LEARNER_MESH_AXES[a])
                  for a in axes)
    out, at = [], 0
    for s in sums:
        out.append(flat[at:at + s.numel()].reshape(s.shape) / n)
        at += s.numel()
    return out


def group_divergence(params: Any, axes: Sequence[int],
                     mesh=None) -> torch.Tensor:
    """Mean over learners of ||w_j - mean_group(w)||^2, summed over the
    tree — the Thm-3.2 discrepancy at a level whose groups are the
    stacked ``axes``.  fp32 accumulation regardless of param dtype.
    ``mesh``: the bound mesh whose rank holds ``params``' block."""
    return _level_sums(params, None, axes, mesh, ("div_pre",))["div_pre"]


def codec_error(post: Any, pre: Any, axes: Sequence[int],
                mesh=None) -> torch.Tensor:
    """Relative squared error of the reduced params vs the exact dense
    group mean of the pre-reduction params, over the whole tree."""
    return _level_sums(pre, post, axes, mesh, ("codec_err",))["codec_err"]


def _level_sums(pre: Any, post: Any, axes: Sequence[int], mesh,
                keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    """``keys`` of ``div_pre``, ``div_post`` and ``codec_err``: the level
    means (across ranks on a mesh), then every per-learner total of the
    fire in one grid (one all-reduce on a mesh).  The means over learners
    and the sums over the tree run as in one process."""
    xs = [x.float() for x in leaves(pre)]
    ys = [] if post is None else [y.float() for y in leaves(post)]
    if not xs:
        return {k: _zero(pre) for k in keys}
    m_pre = _group_means(xs, axes, mesh)
    m_post = _group_means(ys, axes, mesh) if "div_post" in keys else None
    parts = {
        "div_pre": lambda: [torch.square(x - m) for x, m in zip(xs, m_pre)],
        "div_post": lambda: [torch.square(y - m)
                             for y, m in zip(ys, m_post)],
        "codec_num": lambda: [torch.square(y - m)
                              for y, m in zip(ys, m_pre)],
        "codec_den": lambda: [torch.square(m.expand(y.shape))
                              for y, m in zip(ys, m_pre)]}
    names = [k for k in ("div_pre", "div_post") if k in keys]
    if "codec_err" in keys:
        names += ["codec_num", "codec_den"]
    rows = [_per_learner_sum(d) for k in names for d in parts[k]()]
    grid = _grid(torch.stack(rows), mesh, dim=1)
    n, tot = len(xs), {}
    for i, k in enumerate(names):
        t = _zero(pre)
        for g in grid[i * n:(i + 1) * n]:
            t = t + (g.mean() if k.startswith("div") else g.sum())
        tot[k] = t
    out = {k: tot[k] for k in ("div_pre", "div_post") if k in tot}
    if "codec_err" in keys:
        out["codec_err"] = tot["codec_num"] / (tot["codec_den"] + 1e-30)
    return out


def ef_mass(level_state: Any, mesh=None, rows: Any = None) -> torch.Tensor:
    """Squared mass of a level's error-feedback residual.  Sparse/qint8
    EF states carry the untransmitted residual in ``.err``; for other
    stateful reducers every float leaf counts (int leaves — RNG carries,
    counters — are skipped).  ``mesh``: the rank's block of the state,
    summed across ranks; ``rows`` (``Reducer.state_rows``) marks the shard
    rows, which are summed over the fsdp ranks as well."""
    src = getattr(level_state, "err", level_state)
    fl = [x for x in leaves(src) if torch.is_floating_point(x)]
    tot = _zero(fl)
    if not fl:
        return tot
    part = torch.stack([torch.square(x.float()).sum() for x in fl])
    if _on_ranks(mesh):
        from repro_torch.parallel import collectives
        collectives.all_reduce(part, mesh.process_group(LEARNER_MESH_AXES))
    marks = []
    if rows is not None:
        r = getattr(rows, "err", rows)
        marks = [m for x, m in zip(leaves(src), leaves(r))
                 if torch.is_floating_point(x)]
    if any(marks) and mesh is not None and mesh.spread("fsdp") > 1:
        from repro_torch.parallel import collectives
        sharded = torch.tensor(marks, device=part.device)
        w = torch.where(sharded, part, torch.zeros_like(part))
        collectives.all_reduce(w, mesh.process_group(("fsdp",)))
        part = torch.where(sharded, w, part)
    for v in part:
        tot = tot + v
    return tot


def level_stats(cfg: TelemetryConfig, level: Any, pre_params: Any,
                post_params: Any, comm_state: Any, mesh=None
                ) -> Dict[str, torch.Tensor]:
    """The per-fire statistics of one reduction at ``level`` (a
    ReductionLevel): pre/post divergence, codec error, EF mass.
    ``mesh``: the bound mesh whose rank holds the block (None in one
    process); the statistics are then the whole grid's, on every rank."""
    out: Dict[str, torch.Tensor] = {}
    keys = (("div_pre", "div_post") if cfg.divergence else ()) \
        + (("codec_err",) if cfg.codec_err else ())
    if keys:
        for k, v in _level_sums(pre_params, post_params, level.axes,
                                mesh, keys).items():
            out[f"telemetry/{k}/{level.name}"] = v
    if (cfg.ef_mass and level.reducer.stateful
            and isinstance(comm_state, dict)
            and level.name in comm_state):
        st = comm_state[level.name]
        rows = None
        if mesh is not None and getattr(level.reducer, "shards",
                                        None) is not None:
            rows = level.reducer.state_rows(st, pre_params)
        out[f"telemetry/ef_mass/{level.name}"] = ef_mass(st, mesh, rows)
    return out


def make_grad_observer(cfg: Optional[TelemetryConfig],
                       levels: Sequence[Any], mesh=None
                       ) -> Optional[Callable[[Any], Dict]]:
    """Observer the SGD step calls on the (stacked, fp32-accumulated)
    per-learner gradients: per-level within-group variance of the
    per-learner squared gradient norm — the Jiang & Agrawal period
    trigger — plus the fleet-mean squared norm.  ``mesh``: the rank's
    per-learner norms are assembled into the whole grid first (one
    all-reduce a step), then the one-process formula runs on it."""
    if cfg is None or not cfg.grad_var:
        return None

    def observe(grads: Any) -> Dict[str, torch.Tensor]:
        sq = _zero(grads)
        for leaf in leaves(grads):
            sq = sq + _per_learner_sum(torch.square(leaf.float()))
        sq = _grid(sq, mesh)
        out = {"telemetry/grad_sq_norm": sq.mean()}
        for lvl in levels:
            m = sq.mean(dim=tuple(lvl.axes), keepdim=True)
            out[f"telemetry/grad_norm_var/{lvl.name}"] = \
                torch.square(sq - m).mean()
        return out

    return observe
