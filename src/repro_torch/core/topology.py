"""Learner topology for Hier-AVG (PyTorch port of
``repro/core/topology.py``).

The paper's communicators:
  * P  learners total
  * clusters of S learners each do the *local* reduction
  * all P learners do the *global* reduction

A learner is a coordinate on the (pod, group, local) axes; ``local`` has
size S, ``group`` counts clusters per pod, and ``pod`` counts pods.  All
parameter / optimizer-state leaves carry these three leading axes (the
*stacked-learner* layout), so:

  local  reduction == mean over the ``local``  array axis (index 2)
  global reduction == mean over ``pod, group, local`` (indices 0, 1, 2)

In one process every reduction is a tensor mean over those axes, summed
in a fixed order over the learners (:func:`ordered_means`).  On a mesh of
``torch.distributed`` ranks (repro_torch/parallel) each rank holds a
block of the learners: an axis spread over ranks keeps one coordinate, any
other axis stays whole.  A level then sums its in-rank axes by the same
fixed tree and its on-rank axes by collectives over the level's process
group (parallel/collectives.py): an all-reduce, or for the shard-aware
buckets of ``fsdp > 1`` layouts the reference's reduce-scatter +
all-gather (``_scatter_mean``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.tree import flatten, tree_map, unflatten

AXIS_POD = "pod"
AXIS_GROUP = "group"
AXIS_LOCAL = "local"

LEARNER_AXES: Tuple[str, str, str] = (AXIS_POD, AXIS_GROUP, AXIS_LOCAL)
LOCAL_ARRAY_AXES: Tuple[int, ...] = (2,)
POD_ARRAY_AXES: Tuple[int, ...] = (1, 2)
GLOBAL_ARRAY_AXES: Tuple[int, ...] = (0, 1, 2)


@dataclass(frozen=True)
class HierTopology:
    """(pods, groups, local) learner grid; ``local`` is the paper's S."""

    pods: int = 1
    groups: int = 1
    local: int = 1

    def __post_init__(self):
        if min(self.pods, self.groups, self.local) < 1:
            raise ValueError(f"every axis needs >= 1 learner, got {self}")

    @property
    def n_learners(self) -> int:  # the paper's P
        return self.pods * self.groups * self.local

    @property
    def s(self) -> int:          # the paper's S
        return self.local

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.pods, self.groups, self.local)

    # local clusters never span pods: cluster id = (pod, group)
    @property
    def n_clusters(self) -> int:
        return self.pods * self.groups

    def describe(self) -> str:
        return (f"P={self.n_learners} learners = {self.pods} pod(s) x "
                f"{self.groups} cluster(s)/pod x S={self.local}")


def stack_like(topo: HierTopology, tree):
    """Replicate a single-learner tree to the stacked layout
    [pods, G, S, ...] (paper: all learners start from the same w_1).

    The reference's ``broadcast_to`` is a value; here the copy is
    materialised, because learners update independently and an expanded
    view would share one buffer among them."""
    return tree_map(
        lambda x: x.expand(topo.shape + tuple(x.shape)).clone(), tree)


def stack_distinct(topo: HierTopology, init_fn, generator: torch.Generator):
    """Independent per-learner init (for ablations): ``init_fn(generator)``
    once per learner, in row-major learner order, stacked."""
    per = [init_fn(generator) for _ in range(topo.n_learners)]
    return tree_map(
        lambda *xs: torch.stack(xs).reshape(topo.shape + tuple(xs[0].shape)),
        *per)


def unstack_first(tree):
    """Extract learner (0,0,0)'s copy (post-global-average they are equal)."""
    return tree_map(lambda x: x[0, 0, 0], tree)


def _mask_weights(mask: torch.Tensor, ndim: int, dtype) -> torch.Tensor:
    """The mask as multiplicative weights aligned to an ``ndim``-dim
    stacked leaf: ``[pods, G, S]`` broadcast over the trailing dims."""
    w = mask.to(dtype)
    return w.reshape(tuple(w.shape) + (1,) * (ndim - w.dim()))


def _reduction_mesh(mesh, bucket_specs):
    """The bound mesh a reduction runs on (None in one process).  The
    packed buckets' shardings must lie on that same mesh: they cannot
    bring one of their own."""
    mesh = mesh if mesh is not None and mesh.bound else None
    for s in bucket_specs or ():
        if s is not None and s.mesh.bound and s.mesh is not mesh:
            raise ValueError(f"bucket shardings on {s.mesh} but the "
                             f"reduction runs on {mesh}: pass mesh=")
    return mesh


def _spread_axes(mesh, axes: Tuple[int, ...]):
    """The level's learner axes spread over ranks, major first, as
    ``(array axis, ranks)``."""
    return [(a, mesh.spread(LEARNER_AXES[a])) for a in sorted(axes)
            if mesh.spread(LEARNER_AXES[a]) > 1]


def _scatter_mean(sums, sharding, axes: Tuple[int, ...], denom):
    """The grouped mean of one packed bucket by reduce-scatter +
    all-gather (the reference's ``_scatter_mean``): ``sums`` are the
    bucket's in-rank sums (its shape with 1 on ``axes``), reduced over
    the on-rank axes one collective per axis, minor axis first, divided by
    ``denom`` and gathered back.  Returns None where the sharding cannot
    take the scatter path (a lead dim not mesh-mapped, or a run that does
    not tile), and the caller all-reduces instead."""
    from repro_torch.parallel import collectives
    mesh, spec = sharding.mesh, tuple(sharding.spec)
    for a in axes:
        if a >= len(spec) or spec[a] != LEARNER_AXES[a]:
            return None                      # lead dim not mesh-mapped
    active = _spread_axes(mesh, axes)
    tile = math.prod(n for _, n in active)
    run = sums.shape[-1]
    if not active or run % tile:
        return None
    groups = [(mesh.process_group((LEARNER_AXES[a],)), n)
              for a, n in active]
    lead = tuple(sums.shape[:-1])
    d = denom.reshape(tuple(denom.shape)
                      + (1,) * (len(lead) - denom.dim())).expand(
        lead).reshape(-1, 1)
    out = collectives.scatter_mean(sums.reshape(-1, run), groups, d)
    return out.reshape(sums.shape)


def _keep_block(mesh, t: torch.Tensor, axes: Tuple[int, ...]):
    """This rank's block of a global ``[pods, G, S]`` tensor summed over
    ``axes`` (kept as size 1): the kept axes spread over ranks narrow to
    this rank's coordinate."""
    for a in range(len(LEARNER_AXES)):
        if a not in axes and mesh.spread(LEARNER_AXES[a]) > 1:
            t = t.narrow(a, mesh.coord(LEARNER_AXES[a]), 1)
    return t


def _rank_means(xs, specs, axes: Tuple[int, ...], mesh, mask):
    """:func:`ordered_means` on a rank's block when some of the level's
    axes are spread over ranks: the fixed tree sums the in-rank axes
    (the on-rank ones hold one coordinate), then the collectives sum the
    ranks: reduce-scatter + all-gather for a packed bucket whose sharding
    takes it, one all-reduce over the level's group otherwise.

    ``mask`` is the *global* ``[pods, G, S]`` participation mask: this
    rank's block weights the products, and the per-group survivor counts
    come from the whole mask, so no count crosses the wire.  Both paths
    divide by a count held on the device, so an all-true mask gives the
    dense result bit for bit."""
    from repro_torch.parallel import collectives
    axes = tuple(sorted(axes))
    d, e = axes[0], axes[-1]
    if axes != tuple(range(d, e + 1)):
        raise ValueError(f"learner axes {axes} are not adjacent")
    dev = xs[0].device
    if mask is None:
        n = math.prod(xs[0].shape[a] * mesh.spread(LEARNER_AXES[a])
                      for a in axes)
        count = torch.full((), n, dtype=torch.float32, device=dev)
        w = None
    else:
        wg = mask.to(device=dev, dtype=torch.float32)
        keep_g = tuple(1 if i in axes else k for i, k in enumerate(wg.shape))
        count = _keep_block(mesh, torch.clamp(
            _tree_sum([wg.flatten(d, e)], d)[0], min=1).reshape(keep_g),
            axes)
        w = mesh.take_block(wg)
    level_group = mesh.process_group(tuple(LEARNER_AXES[a] for a in axes))
    out = []
    for x, spec in zip(xs, specs):
        y = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
        if w is not None:
            y = y * w.reshape(tuple(w.shape) + (1,) * (y.dim() - w.dim()))
        keep = tuple(1 if i in axes else k for i, k in enumerate(x.shape))
        s = _tree_sum([y.flatten(d, e)], d)[0].reshape(keep)
        o = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        m = None if spec is None else _scatter_mean(s, spec, axes, count)
        if m is not None:
            o.copy_(m.expand_as(x))
        else:
            if s.data_ptr() == y.data_ptr():
                s = s.clone()                # no in-rank sum: not x itself
            collectives.all_reduce(s, level_group)
            c = count if mask is None else count.reshape(
                tuple(count.shape) + (1,) * (x.dim() - count.dim()))
            torch.div(s.expand_as(x), c, out=o)
        out.append(o)
    return out


def average_over(tree, axes: Tuple[int, ...], constraint_fn=None,
                 bucket_specs=None, mask=None, mesh=None):
    """Mean over stacked learner axes, broadcast back and materialised
    (== grouped all-reduce).

    ``mask`` — a boolean ``[pods, G, S]`` participation mask; absent
    learners contribute weight 0 and the sum renormalizes by the
    per-group survivor count (a group with no survivors yields 0, never
    NaN).  The masked sums run through the same fixed tree as the dense
    mean (:func:`ordered_means`), so at full participation, where every
    weight is exactly 1.0 and every count exactly n, masked == unmasked
    bit for bit, and a bucket's masked mean equals its leaves'.

    On a mesh of ranks (``mesh``, a bound ``RankMesh``; an unbound one
    is the whole grid in one process) ``tree`` is this rank's block and
    ``mask`` the global mask.  A level whose axes all live inside the rank reduces as
    in one process; one with axes spread over ranks sums the ranks by
    collectives (:func:`_rank_means`).  ``bucket_specs`` — one
    ``RankSharding`` (or None) per packed bucket, from the shard-aware
    bucket engine (comm/bucket.py ``bucket_shardings``) — takes those
    buckets through reduce-scatter + all-gather (:func:`_scatter_mean`).
    ``constraint_fn`` (parallel/sharding.py ``make_constraint_fn``)
    checks the block shapes of the result (it is not applied to packed
    buckets, as in the reference).
    """
    flat, treedef = flatten(tree)
    specs = [None] * len(flat) if bucket_specs is None \
        else list(bucket_specs)
    if len(specs) != len(flat):
        raise ValueError(f"{len(specs)} bucket specs for {len(flat)} "
                         f"bucket leaves")
    mesh = _reduction_mesh(mesh, bucket_specs)
    if mesh is None:
        out = ordered_means(flat, tuple(axes), mask)
    elif not _spread_axes(mesh, tuple(axes)):
        out = ordered_means(flat, tuple(axes),
                            None if mask is None else mesh.take_block(mask))
    else:
        out = _rank_means(flat, specs, tuple(axes), mesh, mask) \
            if flat else []
    out = unflatten(treedef, out)
    if constraint_fn is not None and bucket_specs is None:
        out = constraint_fn(out)
    return out


def _tree_sum(ys, d: int):
    """Sum each tensor of ``ys`` over dim ``d`` (kept, size 1) by a fixed
    tree of elementwise adds: learner i + h joins learner i, level by
    level, each level one ``_foreach_add`` over every tensor."""
    while ys and ys[0].shape[d] > 1:
        m = ys[0].shape[d]
        h = m // 2
        sums = torch._foreach_add([y.narrow(d, 0, h) for y in ys],
                                  [y.narrow(d, h, h) for y in ys])
        if m % 2:
            torch._foreach_add_([s.select(d, h - 1) for s in sums],
                                [y.select(d, 2 * h) for y in ys])
        ys = sums
    return ys


def ordered_means(xs, axes: Tuple[int, ...], mask=None):
    """The mean of each tensor in ``xs`` over ``axes``, broadcast back to
    its shape and materialised.  The learners are summed by a fixed tree
    of elementwise adds in row-major learner order, then divided by their
    count; 16-bit inputs sum in fp32.  Every element's sum runs in the
    same order whatever the tensor's shape, so a bucket of leaves averages
    bit for bit as the leaves do one by one (``torch.mean`` picks its
    reduction order from the shape on the card).

    ``mask`` (boolean ``[pods, G, S]``, see :func:`average_over`): the
    products ``x * w`` and the weights ``w`` are summed by the same tree,
    then divided by the count clamped to 1.  The division is a true
    division by a device tensor in both cases (on the card a division by a
    host scalar multiplies by its reciprocal instead), so an all-true
    mask gives the dense result bit for bit on the CPU and on the card.

    The learner axes, which are adjacent, are flattened in place (a view),
    and the division writes the broadcast output directly, so no input is
    copied on the dense path."""
    axes = tuple(sorted(axes))
    d, e = axes[0], axes[-1]
    if axes != tuple(range(d, e + 1)):
        raise ValueError(f"learner axes {axes} are not adjacent")
    if not xs:
        return []
    ys = [(x.float() if x.dtype in (torch.bfloat16, torch.float16) else x)
          for x in xs]
    dev = ys[0].device
    if mask is None:
        count = torch.full((), ys[0].shape[d:e + 1].numel(),
                           dtype=torch.float32, device=dev)
    else:
        w = mask.to(device=dev, dtype=torch.float32)
        ys = [y * w.reshape(tuple(w.shape) + (1,) * (y.dim() - w.dim()))
              for y in ys]
        count = torch.clamp(_tree_sum([w.flatten(d, e)], d)[0], min=1)
    sums = _tree_sum([y.flatten(d, e) for y in ys], d)
    out = []
    for x, s in zip(xs, sums):
        keep = tuple(1 if i in axes else k for i, k in enumerate(x.shape))
        c = count if mask is None else count.reshape(
            keep[:mask.dim()] + (1,) * (x.dim() - mask.dim()))
        o = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        torch.div(s.reshape(keep).expand_as(x), c, out=o)
        out.append(o)
    return out


def where_active(mask: torch.Tensor, new_tree, old_tree):
    """Per-learner select: active learners take ``new_tree``, absent ones
    keep ``old_tree`` (how elastic rounds keep an absent learner's params
    and its EF state untouched across a missed fire).

    Leaf alignment is by shape, as in the reference: leaves carrying the
    full stacked lead (``shape[:3] == mask.shape``: params, optimizer
    state, param- and bucket-space EF) select per learner; codec-view
    leaves ``[pods, G, S*F, ...]`` repeat each learner's bit over its F
    rows; all other leaves (RNG carries, scalars) take ``new``.  With an
    all-true mask every leaf is ``new`` exactly."""
    pg, s = tuple(mask.shape[:2]), mask.shape[2]

    def sel(new, old):
        shape = tuple(getattr(new, "shape", ()))
        if len(shape) >= 3 and shape[:3] == tuple(mask.shape):
            m = mask
        elif (len(shape) >= 3 and shape[:2] == pg and shape[2] != s
                and shape[2] % s == 0):
            m = torch.repeat_interleave(mask, shape[2] // s, dim=2)
        else:
            return new
        return torch.where(_mask_weights(m.to(new.device), len(shape),
                                         torch.bool), new, old)

    return tree_map(sel, new_tree, old_tree)


def local_average(tree, constraint_fn=None, bucket_specs=None, mask=None,
                  mesh=None):
    """The paper's local reduction: mean within each cluster of S learners."""
    return average_over(tree, LOCAL_ARRAY_AXES, constraint_fn, bucket_specs,
                        mask, mesh)


def global_average(tree, constraint_fn=None, bucket_specs=None, mask=None,
                   mesh=None):
    """The paper's global reduction: mean over all P learners."""
    return average_over(tree, GLOBAL_ARRAY_AXES, constraint_fn, bucket_specs,
                        mask, mesh)


def pod_average(tree, constraint_fn=None, bucket_specs=None, mask=None,
                mesh=None):
    """Beyond-paper: intra-pod reduction (axes group+local, not pod)."""
    return average_over(tree, POD_ARRAY_AXES, constraint_fn, bucket_specs,
                        mask, mesh)
