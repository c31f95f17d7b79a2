"""Round batches for Hier-AVG (PyTorch port of the host half of
``repro/data/loader.py``).

  * per-learner INDEPENDENT streams: cell (step, learner) of round r draws
    from its own generator, seeded by ``stream_seed(seed, r, cell)`` (the
    counterpart of the reference's ``fold_in`` / ``split``), so the
    paper's i.i.d. assumption holds and a learner's data does not depend
    on the others';
  * round batching: leaves shaped [*plan.batch_dims, pods, G, S, B, ...]
    to feed ``make_hier_round`` ([beta, K1, ...] for the 2-level plan).

Device placement with shardings (``mesh=`` / ``shardings=``) is not
ported yet and raises: ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch.comm.sparse import stream_seed
from repro_torch.configs.base import HierAvgParams
from repro_torch.core.topology import HierTopology
from repro_torch.tree import tree_map


class HierDataLoader:
    """sample_fn(generator, n) -> batch with leading example dim n, drawn
    on ``device`` (the generator lives there)."""

    def __init__(self, sample_fn: Callable, *, topo: HierTopology,
                 hier: HierAvgParams, per_learner_batch: int,
                 seed: int = 0, shardings: Optional[Any] = None,
                 mesh: Optional[Any] = None, device="cuda"):
        if shardings is not None or mesh is not None:
            raise NotImplementedError(
                "HierDataLoader(mesh=, shardings=) is not ported yet: "
                "ROADMAP Queue 1 item 7")
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
        shape = self.hier.batch_dims + self.topo.shape
        n_cells = self.hier.steps_per_round * self.topo.n_learners
        flat = []
        for cell in range(n_cells):
            gen = torch.Generator(device=self.device).manual_seed(
                stream_seed(self.seed, r, cell))
            flat.append(self.sample(gen, self.B))
        batch = tree_map(lambda *xs: torch.stack(xs), *flat)
        return tree_map(lambda x: x.reshape(shape + tuple(x.shape[1:])),
                        batch)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            yield self.next_round()
