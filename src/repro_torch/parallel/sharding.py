"""Partition rules and the rank mesh (PyTorch port of
``repro/parallel/sharding.py``).

The reference names a Megatron-style layout on the ``model`` (TP) axis
with ZeRO-style sharding on the ``fsdp`` axis *inside* one learner:

  input-side weights  [d_in, d_out_parallel]  ->  (fsdp, model)
  output-side weights [d_in_parallel, d_out]  ->  (model, fsdp)
  embeddings          [V, d]                  ->  (None, model)
  MoE expert stacks   [E, ...]                ->  (model, fsdp, ...)
  norms / vectors                             ->  replicated

and GSPMD places every array by those specs.  The port keeps the rules,
``resolve_pspec`` / ``safe_pspec`` (which drop an axis whose mesh size
does not divide the dim, and say so) and :class:`ShardPlan`, because the
shard-aware bucket layout (comm/bucket.py) and the cost model
(core/theory.py) read them, but places nothing implicitly.  A
:class:`RankMesh` stands where the reference's ``jax.sharding.Mesh``
stood: one ``torch.distributed`` rank per device of the reference's
mesh, in the same row-major order, so ``replica_groups`` gives the same
groups.  Placement is explicit:

  * a learner axis is on ranks (its mesh size equals the topology's, and
    each rank holds one coordinate of it) or inside every rank (mesh size
    1); nothing in between, as the reference's ``_scatter_mean`` maps an
    axis fully or not at all;
  * the F ranks of one learner (``fsdp``) each hold the learner's full
    parameters and compute its step; only the reduction stack is
    shard-aware (each rank packs, compresses and reduces its own shard's
    runs);
  * ``model`` (tensor parallelism) stays 1 on a mesh of ranks, as in the
    reference's launcher.

A mesh that is not bound to a rank (``rank=None``) is the whole grid in
one process: every axis lives inside it.  That is what accounting
(``payload_bytes``, the cost model) and the single-process shard-aware
layout use.
"""
from __future__ import annotations

import math
import re
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.tree import flatten, leaf_paths, unflatten

# ordered (regex, inner spec relative to the *logical* trailing dims);
# first match wins, matched against the "/"-joined param path
DEFAULT_RULES: List[Tuple[str, Optional[Tuple]]] = [
    # --- MoE expert stacks (leading E dim) ---
    (r"ffn/experts/w_(gate|up)$", ("model", "fsdp", None)),
    (r"ffn/experts/w_down$", ("model", None, "fsdp")),
    (r"ffn/router$", (None, None)),
    # --- rwkv channel-mix (names collide with attention; match parent) ---
    (r"cm/wk$", ("fsdp", "model")),
    (r"cm/wv$", ("model", "fsdp")),
    (r"cm/wr$", ("fsdp", "model")),
    (r"cm/mu_[kr]$", (None,)),
    # --- rwkv time-mix ---
    (r"tm/mu_x$", (None,)),
    (r"tm/mu$", (None, None)),
    (r"tm/mix_A$", ("fsdp", None)),
    (r"tm/mix_B$", (None, "model")),
    (r"tm/decay_(base|A|B)$", None),   # resolved below by rank
    (r"tm/u$", (None,)),
    # --- mamba ---
    (r"ssm/in_proj$", ("fsdp", "model")),
    (r"ssm/conv_[wb]$", None),
    (r"ssm/x_proj$", ("model", None)),
    (r"ssm/dt_proj$", (None, "model")),
    (r"ssm/dt_bias$", ("model",)),
    (r"ssm/A_log$", ("model", None)),
    (r"ssm/D$", ("model",)),
    (r"ssm/out_proj$", ("model", "fsdp")),
    # --- attention (GQA + MLA) ---
    (r"(attn|self_attn|cross_attn)/w[qkv]$", ("fsdp", "model")),
    (r"(attn|self_attn|cross_attn)/wo$", ("model", "fsdp")),
    (r"attn/w_dkv$", ("fsdp", None)),
    (r"attn/w_kr$", ("fsdp", None)),
    (r"attn/w_u[kv]$", (None, "model")),
    (r"attn/kv_norm/.*$", (None,)),
    # --- rwkv top-level projections (wr/wk/wv/wg under tm) ---
    (r"tm/w[rkvg]$", ("fsdp", "model")),
    (r"tm/wo$", ("model", "fsdp")),
    # --- mlp ---
    (r"(mlp|ffn|ffn/shared)/w_(gate|up)$", ("fsdp", "model")),
    (r"(mlp|ffn|ffn/shared)/w_down$", ("model", "fsdp")),
    # --- embeddings / heads ---
    (r"embed$", ("model", None)),
    (r"lm_head$", ("fsdp", "model")),
    (r"head$", ("fsdp", None)),
    # --- norms and leftovers: replicate (resolved by rank) ---
]

# the learner array axes (core/topology.py) -> hier mesh axis names
LEARNER_MESH_AXES = ("pod", "group", "local")


class PartitionSpec:
    """A partition spec: one mesh-axis name (or a tuple of names, or
    None) per array dim, as ``jax.sharding.PartitionSpec`` holds them.
    Not a tuple, so a tree of specs flattens to one leaf per spec."""

    def __init__(self, *axes):
        self.axes = tuple(axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self) -> int:
        return len(self.axes)

    def __getitem__(self, i):
        return self.axes[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            other = other.axes
        return isinstance(other, tuple) and self.axes == other

    def __hash__(self) -> int:
        return hash(self.axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.axes!r}"


P = PartitionSpec


class PartitionRules:
    """Resolve PartitionSpecs for a params tree.

    axis_map renames the logical axes ("pod","group","local","fsdp","model")
    to the actual mesh axes (serving meshes use ("data","model") only).
    """

    def __init__(self, rules: Optional[List[Tuple[str, Optional[Tuple]]]]
                 = None, *, learner_axes: Sequence[Optional[str]] =
                 LEARNER_MESH_AXES,
                 axis_map: Optional[Dict[str, Optional[str]]] = None):
        self.rules = [(re.compile(pat), spec)
                      for pat, spec in (rules or DEFAULT_RULES)]
        self.learner_axes = tuple(learner_axes)
        self.axis_map = axis_map or {}

    def _rename(self, ax):
        if ax is None:
            return None
        return self.axis_map.get(ax, ax)

    def inner_spec(self, path: str, rank: int) -> Tuple:
        for pat, spec in self.rules:
            if pat.search(path):
                if spec is not None and len(spec) <= rank:
                    return spec
                break
        # fallback by rank: replicate vectors; 2-D -> (fsdp, model)
        if rank >= 2:
            return ("fsdp", "model") + (None,) * (rank - 2)
        return (None,) * rank

    def spec_for(self, path: str, shape: Tuple[int, ...],
                 *, stacked_learners: bool) -> PartitionSpec:
        rank = len(shape)
        lead = len(self.learner_axes) if stacked_learners else 0
        # try decreasing inner rank until it fits (extra dims: layer stacks)
        for inner_rank in range(min(rank - lead, rank), -1, -1):
            inner = self.inner_spec(path, inner_rank)
            if len(inner) == inner_rank:
                break
        extras = rank - lead - len(inner)
        if extras < 0:           # tiny leaf, fewer dims than learner axes
            lead, extras, inner = 0, 0, (None,) * rank
        axes = (tuple(self.learner_axes[:lead]) + (None,) * extras
                + tuple(inner))
        return P(*(self._rename(a) for a in axes))


class PSpecDropWarning(UserWarning):
    """A requested partition axis was dropped (non-dividing dim): the leaf
    stays replicated over that mesh axis.  Layout and billing must use the
    *resolved* spec — see ``resolve_pspec``."""


def resolve_pspec(spec, shape: Tuple[int, ...], mesh
                  ) -> Tuple[PartitionSpec, Tuple[Tuple[int, object], ...]]:
    """Resolve ``spec`` against ``shape``/``mesh``: drop axis names whose
    mesh size does not divide the array dim, and *return the drops* as
    ``(dim_index, axis_name)`` pairs so callers can bill / warn from the
    resolved layout instead of the requested one."""
    out, dropped = [], []
    for d, (dim, ax) in enumerate(
            zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec)))):
        if ax is None:
            out.append(None)
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        size = 1
        for n in names:
            size *= mesh.shape[n]
        if dim % size == 0:
            out.append(ax)
        else:
            out.append(None)
            dropped.append((d, ax))
    return P(*out), tuple(dropped)


def safe_pspec(spec, shape: Tuple[int, ...], mesh,
               *, warn: bool = True) -> PartitionSpec:
    """Drop axis names whose mesh size does not divide the array dim.

    Dropping means the leaf stays *replicated* over that mesh axis, which
    matters to anything that assumes the spec it asked for (shard-aware
    bucket layouts, comm billing), so the drop warns by default; pass
    ``warn=False`` where the replicated fallback is expected, or use
    ``resolve_pspec`` to inspect the drops.
    """
    out, dropped = resolve_pspec(spec, shape, mesh)
    if warn and dropped:
        warnings.warn(
            f"safe_pspec: dropping non-dividing axes {list(dropped)} of "
            f"spec {spec} for shape {tuple(shape)} — those dims stay "
            f"replicated; layouts/billing must use the resolved spec "
            f"{out}", PSpecDropWarning, stacklevel=2)
    return out


# the axis sets whose process groups a bound mesh creates, in this order
# on every rank: each plan level's learner axes, each learner axis alone
# (one reduce-scatter per axis), and the fsdp axis (the regather)
_GROUP_AXIS_SETS = (("local",), ("group", "local"), ("pod", "group", "local"),
                    ("pod",), ("group",), ("fsdp",))


class RankMesh:
    """A named grid of ``torch.distributed`` ranks, row-major, as the
    reference's hier mesh names its devices.

    ``devices`` holds the rank ids in the grid's shape, ``shape`` maps
    each axis name to its size (the ``jax.sharding.Mesh`` attributes the
    rules and ``replica_groups`` read).  ``rank`` binds the mesh to this
    process: a bound mesh spreads each axis over that many ranks, and
    owns the process groups its reductions run on
    (:meth:`process_group`).  An unbound mesh (``rank=None``) is the
    whole grid inside one process."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: Optional[int] = None):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or min(shape, default=1) < 1:
            raise ValueError(f"mesh shape {shape} does not name "
                             f"{axis_names}")
        self.axis_names = axis_names
        self.devices = np.arange(math.prod(shape)).reshape(shape)
        self.shape = dict(zip(axis_names, shape))
        self.rank = None if rank is None else int(rank)
        if self.rank is not None:
            if not 0 <= self.rank < self.size:
                raise ValueError(f"rank {rank} is not on a mesh of "
                                 f"{self.size}")
            if self.shape.get("model", 1) != 1:
                raise ValueError("the port has no tensor parallelism: a "
                                 "mesh of ranks keeps model = 1")
        self._groups: Optional[Dict[Tuple[int, ...], object]] = None

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def bound(self) -> bool:
        return self.rank is not None

    def __repr__(self) -> str:
        return (f"RankMesh({tuple(self.shape.values())}, {self.axis_names}"
                + (f", rank={self.rank})" if self.bound else ")"))

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 on an absent axis)."""
        if not self.bound:
            raise ValueError("an unbound mesh has no rank coordinates")
        if axis not in self.shape:
            return 0
        pos = np.argwhere(self.devices == self.rank)[0]
        return int(pos[self.axis_names.index(axis)])

    def spread(self, axis: str) -> int:
        """How many ranks ``axis`` is spread over: its size on a bound
        mesh, 1 on an unbound one (or an absent axis)."""
        return int(self.shape.get(axis, 1)) if self.bound else 1

    # -- learner blocks ------------------------------------------------- #

    def block_topology(self, topo):
        """The ``[pods, G, S]`` block of ``topo`` that this rank holds:
        an axis spread over ranks keeps one coordinate, any other axis
        stays whole.  Raises unless each learner axis is either all on
        ranks (mesh size == topology size) or all inside every rank
        (mesh size 1)."""
        from repro_torch.core.topology import HierTopology
        sizes = []
        for ax, n in zip(LEARNER_MESH_AXES, topo.shape):
            m = int(self.shape.get(ax, 1))
            if m not in (1, n):
                raise ValueError(
                    f"learner axis {ax!r} of size {n} on a mesh axis of "
                    f"size {m}: an axis is either all on ranks (mesh size "
                    f"{n}) or all inside every rank (mesh size 1)")
            sizes.append(n // self.spread(ax))
        return HierTopology(*sizes)

    def take_block(self, x, dim: int = 0):
        """This rank's block of a tensor whose dims ``dim..dim+2`` are the
        global ``[pods, G, S]`` learner axes."""
        for i, ax in enumerate(LEARNER_MESH_AXES):
            if self.spread(ax) > 1:
                x = x.narrow(dim + i, self.coord(ax), 1)
        return x

    # -- process groups ------------------------------------------------- #

    def init_process_groups(self) -> None:
        """Create the process groups of every plan level, of each learner
        axis alone and of the fsdp axis: one ``dist.new_group`` per
        distinct group of more than one rank, in one fixed order.  Every
        rank must call this (``process_group`` does, at its first use),
        or the world hangs in ``new_group``."""
        import torch.distributed as dist
        if self._groups is not None:
            return
        if not self.bound:
            raise ValueError("an unbound mesh has no process groups")
        if dist.get_world_size() != self.size:
            raise ValueError(f"world of {dist.get_world_size()} ranks for "
                             f"a mesh of {self.size}")
        groups: Dict[Tuple[int, ...], object] = {}
        for axes in _GROUP_AXIS_SETS:
            if not all(a in self.shape for a in axes):
                continue
            for ranks in replica_groups(self, axes):
                key = tuple(ranks)
                if len(key) > 1 and key not in groups:
                    groups[key] = dist.new_group(list(key))
        self._groups = groups

    def process_group(self, axes: Sequence[str]):
        """This rank's process group over the mesh axes ``axes`` (the
        other axes kept), or None when the group is this rank alone."""
        if self._groups is None:
            self.init_process_groups()
        for ranks in replica_groups(self, tuple(axes)):
            if self.rank in ranks:
                return self._groups[tuple(ranks)] if len(ranks) > 1 \
                    else None
        raise ValueError(f"rank {self.rank} is in no group over {axes}")


@dataclass(frozen=True)
class ShardPlan:
    """How an ``fsdp > 1`` layout shards the per-learner trailing dims:
    the one handle the reduction stack keys off.

      * ``comm/bucket.py`` packs a per-shard run per bucket from
        ``leaf_shard_dim`` (the same rules + divisibility resolution as
        ``safe_pspec``),
      * ``core/topology.py`` runs each sharded bucket's grouped mean as
        reduce-scatter + all-gather over ``mesh``'s groups,
      * ``core/theory.py`` bills shard-local wire payloads (1/``size``).

    On a bound mesh each rank holds one shard (``local_shards == 1``, its
    coordinate ``shard_index``); on an unbound one the process holds all
    ``size`` of them.  ``rules`` is excluded from eq/hash.
    """

    mesh: RankMesh
    axis: str = "fsdp"
    lead: Tuple[str, ...] = LEARNER_MESH_AXES
    rules: Optional[PartitionRules] = field(default=None, compare=False,
                                            hash=False)

    @property
    def size(self) -> int:
        """Shards per learner (the fsdp mesh-axis size)."""
        return int(self.mesh.shape[self.axis])

    @property
    def n_lead(self) -> int:
        """Learner count on the mesh: bucket runs are padded to a multiple
        of it so every level's reduce-scatter tiles evenly."""
        n = 1
        for a in self.lead:
            n *= int(self.mesh.shape.get(a, 1))
        return n

    @property
    def local_shards(self) -> int:
        """Shards of each learner held in this process."""
        return self.size // self.mesh.spread(self.axis)

    @property
    def shard_index(self) -> Optional[int]:
        """This rank's shard, or None when the process holds them all."""
        return self.mesh.coord(self.axis) if self.local_shards == 1 \
            and self.size > 1 else None

    def leaf_shard_dim(self, path: str, shape: Tuple[int, ...]
                       ) -> Optional[int]:
        """Which *trailing* (per-learner) dim of the leaf at ``path`` the
        shard axis lands on, or None when the leaf stays replicated (the
        rules put the axis nowhere, or it does not divide: exactly the
        ``safe_pspec``/``resolve_pspec`` drop)."""
        if self.size <= 1:
            return None
        rules = self.rules or PartitionRules()
        spec = rules.spec_for(path, shape, stacked_learners=False)
        resolved, _ = resolve_pspec(spec, shape, self.mesh)
        for d, ax in enumerate(tuple(resolved)):
            if ax == self.axis:
                return d
        return None


def shard_plan(mesh: RankMesh, *, axis: str = "fsdp",
               lead: Tuple[str, ...] = LEARNER_MESH_AXES,
               rules: Optional[PartitionRules] = None
               ) -> Optional[ShardPlan]:
    """ShardPlan for ``mesh``, or None when the shard axis is absent or
    trivial (``fsdp=1`` layouts run the replicated path)."""
    if axis not in mesh.shape or mesh.shape[axis] <= 1:
        return None
    return ShardPlan(mesh=mesh, axis=axis, lead=lead, rules=rules)


def replica_groups(mesh, reduce_axes: Sequence[str]) -> List[List[int]]:
    """Rank-id groups of the grouped collective that reduces over
    ``reduce_axes``: one group per coordinate of the *kept* axes
    (row-major rank order, reduced axes minor).  E.g. a global reduction
    on a (pod, group, local, fsdp) mesh keeps fsdp, so each fsdp shard
    averages only with its peers."""
    shape = mesh.devices.shape
    ids = np.arange(math.prod(shape)).reshape(shape)
    names = mesh.axis_names
    red = [i for i, n in enumerate(names) if n in tuple(reduce_axes)]
    keep = [i for i in range(len(names)) if i not in red]
    group_n = math.prod(shape[i] for i in red) if red else 1
    grouped = ids.transpose(keep + red).reshape(-1, group_n)
    return [[int(d) for d in row] for row in grouped]


def param_pspecs(params, mesh, *, stacked_learners: bool,
                 rules: Optional[PartitionRules] = None):
    """Tree of PartitionSpecs matching ``params`` (divisibility-safe)."""
    rules = rules or PartitionRules()
    flat, treedef = flatten(params)
    return unflatten(treedef, [
        safe_pspec(rules.spec_for(path, tuple(x.shape),
                                  stacked_learners=stacked_learners),
                   tuple(x.shape), mesh)
        for path, x in zip(leaf_paths(params), flat)])


def batch_pspec(ndim_after_learner: int, *, round_dims: int = 2,
                stacked_learners: bool = True,
                batch_axis: Optional[str] = "fsdp",
                axis_map: Optional[Dict[str, Optional[str]]] = None
                ) -> PartitionSpec:
    """Spec for round batches [beta, K1, pods, G, S, B, ...trailing]."""
    axis_map = axis_map or {}

    def ren(a):
        return axis_map.get(a, a) if a else None

    lead = (None,) * round_dims
    learner = (ren("pod"), ren("group"), ren("local")) if stacked_learners \
        else ()
    tail = (ren(batch_axis),) + (None,) * (ndim_after_learner - 1)
    return P(*(lead + learner + tail))


@dataclass(frozen=True)
class RankSharding:
    """A packed bucket's placement: its spec over ``mesh`` (the port's
    counterpart of a ``NamedSharding``; ``comm/bucket.py``
    ``bucket_shardings``)."""

    mesh: RankMesh
    spec: PartitionSpec


class RankConstraint:
    """The port's ``constraint_fn``: placement is explicit, so there is
    nothing to re-pin; it checks that each leaf has the block shape its
    spec gives this rank (a learner dim spread over ranks holds one
    coordinate; trailing dims stay whole, since the ranks of one learner
    hold its full parameters) and returns the tree unchanged.  The
    grouped means take their mesh from ``mesh=``, never from here."""

    def __init__(self, mesh: RankMesh, specs=None):
        self.mesh = mesh
        self.specs = specs

    def _check(self, x, spec) -> None:
        for d, ax in enumerate(tuple(spec)[:x.dim()]):
            names = ax if isinstance(ax, tuple) else (ax,)
            spread = math.prod(self.mesh.spread(n) for n in names
                               if n in LEARNER_MESH_AXES)
            if spread > 1 and x.shape[d] != 1:
                raise ValueError(
                    f"leaf of shape {tuple(x.shape)} holds {x.shape[d]} "
                    f"coordinates of dim {d} ({ax}), which is spread over "
                    f"{spread} ranks: a rank holds one")

    def __call__(self, tree):
        flat, treedef = flatten(tree)
        specs = None
        if self.specs is not None:
            sflat, sdef = flatten(self.specs)
            if sdef == treedef:
                specs = sflat
        for i, x in enumerate(flat):
            if x.dim() >= len(LEARNER_MESH_AXES):
                self._check(x, specs[i] if specs is not None
                            else P(*LEARNER_MESH_AXES))
        return tree


def make_constraint_fn(mesh: RankMesh, specs=None) -> RankConstraint:
    """constraint_fn for core.hier_avg on a mesh of ranks (see
    :class:`RankConstraint`)."""
    return RankConstraint(mesh, specs)
