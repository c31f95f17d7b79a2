"""Meshes of ranks (PyTorch port of ``repro/launch/mesh.py``).

``make_production_mesh`` is the reference's target spec: a 256-chip pod as
(16, 16) ("data", "model"), or 2 pods as (2, 16, 16) ("pod", "data",
"model").  ``make_hier_mesh`` is the same device set with the 16-way data
axis factored ``groups x local x fsdp``, so the Hier-AVG communicators are
named mesh axes: the local reduction runs over "local", the global one
over ("pod", "group", "local").  Both return unbound
:class:`~repro_torch.parallel.sharding.RankMesh` grids (shapes and rank
ids only): the partition rules and the cost model read them without a
process group.

:func:`rank_mesh` lays a training run's learners over the ranks of a
``torch.distributed`` world, and :func:`level_process_groups` gives each
plan level its process group on that mesh.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ParallelLayout
from repro_torch.parallel.sharding import (LEARNER_MESH_AXES, RankMesh,
                                           replica_groups)

DATA_AXIS = 16
TP_AXIS = 16
PODS_MULTI = 2
HIER_AXES = ("pod", "group", "local", "fsdp", "model")


def make_production_mesh(*, multi_pod: bool = False) -> RankMesh:
    shape = (PODS_MULTI, DATA_AXIS, TP_AXIS) if multi_pod \
        else (DATA_AXIS, TP_AXIS)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return RankMesh(shape, axes)


def make_hier_mesh(layout: ParallelLayout, *,
                   multi_pod: bool = False) -> RankMesh:
    layout.validate(DATA_AXIS * TP_AXIS)
    pods = PODS_MULTI if multi_pod else 1
    return RankMesh((pods, layout.groups, layout.local, layout.fsdp,
                     layout.tp), HIER_AXES)


def device_count_required(*, multi_pod: bool = False) -> int:
    return (PODS_MULTI if multi_pod else 1) * DATA_AXIS * TP_AXIS


def level_replica_groups(mesh, level: str):
    """Rank-id groups of the grouped collective one plan level runs on a
    hier mesh: the reduction spans the level's learner mesh axes and
    *keeps* the fsdp/model axes, so each fsdp shard averages only with
    its peers."""
    from repro_torch.core.plan import LEVEL_AXES
    axes = tuple(LEARNER_MESH_AXES[a] for a in LEVEL_AXES[level])
    return replica_groups(mesh, axes)


def level_process_groups(mesh: RankMesh, plan) -> Dict[str, object]:
    """This rank's process group for each level of ``plan`` (None where
    the level's group is this rank alone).  The first call creates every
    group of the mesh (``RankMesh.init_process_groups``: one
    ``dist.new_group`` per group, in one fixed order, on every rank), and
    the mesh keeps them."""
    from repro_torch.core.plan import LEVEL_AXES
    mesh.init_process_groups()
    return {lvl.name: mesh.process_group(
        tuple(LEARNER_MESH_AXES[a] for a in LEVEL_AXES[lvl.name]))
        for lvl in plan.levels}


def rank_mesh(topo, fsdp: int, world_size: int, rank: int) -> RankMesh:
    """The hier mesh ``(pod, group, local, fsdp, model=1)`` that lays
    ``topo``'s learners, each on ``fsdp`` ranks, over a world of
    ``world_size`` ranks, bound to ``rank``: every learner on ranks of
    its own, or each cluster of S learners on ranks of its own (the
    paper's deployment; the local level stays inside the rank), or the
    whole grid on one rank.  Each axis is either all on ranks or all
    inside every rank."""
    P, G, S = topo.shape
    for shape in ((P, G, S), (P, G, 1)):
        if shape[0] * shape[1] * shape[2] * fsdp == world_size:
            return RankMesh(shape + (fsdp, 1), HIER_AXES, rank=rank)
    if world_size == fsdp == 1:
        return RankMesh((1, 1, 1, 1, 1), HIER_AXES, rank=rank)
    raise ValueError(
        f"a world of {world_size} ranks does not hold {topo.describe()} "
        f"with fsdp {fsdp}: it takes learners x fsdp or clusters x fsdp "
        f"ranks, or one")
