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

On one card every reduction is a tensor mean over those axes, summed in a
fixed order over the learners (:func:`ordered_means`).  The
explicit reduce-scatter + all-gather lowering of the reference
(``_scatter_mean``, its ``bucket_specs``) belongs to the multi-GPU
hierarchy, ROADMAP Queue 1 item 7, and raises here.
"""
from __future__ import annotations

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


def average_over(tree, axes: Tuple[int, ...], constraint_fn=None,
                 bucket_specs=None, mask=None):
    """Mean over stacked learner axes, broadcast back and materialised
    (== grouped all-reduce).

    ``mask`` — a boolean ``[pods, G, S]`` participation mask; absent
    learners contribute weight 0 and the sum renormalizes by the
    per-group survivor count (a group with no survivors yields 0, never
    NaN).  The masked sums run through the same fixed tree as the dense
    mean (:func:`ordered_means`), so at full participation, where every
    weight is exactly 1.0 and every count exactly n, masked == unmasked
    bit for bit, and a bucket's masked mean equals its leaves'.

    ``constraint_fn`` (GSPMD sharding hints) and ``bucket_specs`` (the
    shard-aware reduce-scatter lowering) belong to the multi-GPU
    hierarchy, ROADMAP Queue 1 item 7, and raise here.
    """
    if constraint_fn is not None or bucket_specs is not None:
        raise NotImplementedError(
            "constraint_fn / bucket_specs (sharded reductions) are not "
            "ported: ROADMAP Queue 1 item 7")
    flat, treedef = flatten(tree)
    return unflatten(treedef, ordered_means(flat, tuple(axes), mask))


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


def local_average(tree, constraint_fn=None, bucket_specs=None, mask=None):
    """The paper's local reduction: mean within each cluster of S learners."""
    return average_over(tree, LOCAL_ARRAY_AXES, constraint_fn, bucket_specs,
                        mask)


def global_average(tree, constraint_fn=None, bucket_specs=None, mask=None):
    """The paper's global reduction: mean over all P learners."""
    return average_over(tree, GLOBAL_ARRAY_AXES, constraint_fn, bucket_specs,
                        mask)


def pod_average(tree, constraint_fn=None, bucket_specs=None, mask=None):
    """Beyond-paper: intra-pod reduction (axes group+local, not pod)."""
    return average_over(tree, POD_ARRAY_AXES, constraint_fn, bucket_specs,
                        mask)
