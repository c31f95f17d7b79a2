"""Round batches for Hier-AVG (PyTorch port of the host half of
``repro/data/loader.py``).

  * per-learner INDEPENDENT streams: cell (step, learner) of round r draws
    from its own generator, seeded by ``stream_seed(seed, r, cell)`` (the
    counterpart of the reference's ``fold_in`` / ``split``), so the
    paper's i.i.d. assumption holds and a learner's data does not depend
    on the others';
  * round batching: leaves shaped [*plan.batch_dims, pods, G, S, B, ...]
    to feed ``make_hier_round`` ([beta, K1, ...] for the 2-level plan).

  * placement on a mesh of ranks (``mesh=``, or the ``shardings=`` of
    :func:`round_batch_shardings`): each rank draws only the cells of its
    own block of learners, from the same per-cell streams, so every
    learner's batch equals the one-process run's exactly.  The ranks of
    one learner (fsdp) each draw its whole batch: they compute its step
    redundantly.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch.comm.sparse import stream_seed
from repro_torch.configs.base import HierAvgParams
from repro_torch.core.topology import LEARNER_AXES, HierTopology
from repro_torch.tree import leaves, tree_map


def round_batch_pspec(batch_dims, leaf_ndim: int, mesh, leaf_shape=None,
                      data_axis: Optional[str] = "fsdp"):
    """PartitionSpec of one round-batch leaf under a plan of any depth:
    the ``len(batch_dims)`` step axes replicated, the three learner axes
    over the mesh's learner axes, the per-learner example dim over
    ``data_axis`` (when the mesh has it), trailing dims replicated; with
    ``leaf_shape`` the spec is divisibility-checked (``safe_pspec``).
    The port reads the learner entries only: a rank keeps its block of
    learners and each learner's whole batch."""
    from repro_torch.parallel.sharding import P, safe_pspec
    n_lead = len(tuple(batch_dims))
    if leaf_ndim < n_lead + len(LEARNER_AXES):
        raise ValueError(
            f"round-batch leaf has {leaf_ndim} dims but the plan needs "
            f"{n_lead} step dims + {len(LEARNER_AXES)} learner dims "
            f"(batch_dims={tuple(batch_dims)})")
    tail = (data_axis,) if (data_axis and data_axis in mesh.shape) else ()
    spec = (None,) * n_lead + LEARNER_AXES + tail
    spec = spec + (None,) * (leaf_ndim - len(spec))
    spec = P(*spec[:leaf_ndim])
    if leaf_shape is not None:
        spec = safe_pspec(spec, tuple(leaf_shape), mesh)
    return spec


def round_batch_shardings(mesh, hier: HierAvgParams, batch,
                          data_axis: Optional[str] = "fsdp"):
    """``RankSharding``\\ s for a whole round batch (tensors or meta
    tensors), in any plan depth through ``hier.batch_dims``."""
    from repro_torch.parallel.sharding import RankSharding
    dims = hier.batch_dims
    return tree_map(
        lambda leaf: RankSharding(mesh, round_batch_pspec(
            dims, leaf.dim(), mesh, leaf_shape=tuple(leaf.shape),
            data_axis=data_axis)), batch)


class HierDataLoader:
    """sample_fn(generator, n) -> batch with leading example dim n, drawn
    on ``device`` (the generator lives there).

    ``mesh`` (a bound ``RankMesh``) or ``shardings`` (a tree of
    ``RankSharding``, whose mesh it is) makes each round this rank's
    block ``[*batch_dims, *block, B, ...]`` of the whole grid's."""

    def __init__(self, sample_fn: Callable, *, topo: HierTopology,
                 hier: HierAvgParams, per_learner_batch: int,
                 seed: int = 0, shardings: Optional[Any] = None,
                 mesh: Optional[Any] = None, device="cuda"):
        if shardings is not None:
            found = leaves(shardings)[0].mesh
            if mesh is not None and found is not mesh:
                raise ValueError("shardings= and mesh= name two meshes")
            mesh = found
        self.mesh = mesh if mesh is not None and mesh.bound else None
        self.block = topo if self.mesh is None \
            else self.mesh.block_topology(topo)
        self.sample = sample_fn
        self.topo = topo
        self.hier = hier
        self.B = per_learner_batch
        self.seed = seed
        self.device = torch.device(device)
        self._round = 0

    @property
    def tokens_per_round(self) -> int:
        return self.hier.steps_per_round * self.topo.n_learners * self.B

    def next_round(self) -> Dict[str, torch.Tensor]:
        r = self._round
        self._round += 1
        shape = self.hier.batch_dims + self.block.shape
        # cell (step, learner) draws from its own stream: this process
        # draws the cells of the learners it holds
        ids = torch.arange(self.topo.n_learners).reshape(self.topo.shape)
        if self.mesh is not None:
            ids = self.mesh.take_block(ids)
        mine = ids.flatten().tolist()
        flat = []
        for step in range(self.hier.steps_per_round):
            for learner in mine:
                gen = torch.Generator(device=self.device).manual_seed(
                    stream_seed(self.seed, r,
                                step * self.topo.n_learners + learner))
                flat.append(self.sample(gen, self.B))
        batch = tree_map(lambda *xs: torch.stack(xs), *flat)
        return tree_map(lambda x: x.reshape(shape + tuple(x.shape[1:])),
                        batch)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            yield self.next_round()
