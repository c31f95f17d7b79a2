"""Single-device Hier-AVG simulator (PyTorch port of
``repro/core/simulator.py``).

Runs P learners on one device — the card unless the caller asks for
``device="cpu"`` — with the stacked-learner code of core/hier_avg.py.
Used for the paper-shape runs (K2 / K1 / S sweeps, vs-K-AVG) and by
``chip_smoke.py`` to train ResNet-18 at full width.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.comm import Reducer
from repro_torch.configs.base import HierAvgParams
from repro_torch.core.baselines import make_kavg_round, make_sync_sgd_round
from repro_torch.core.hier_avg import TrainState, init_state, make_hier_round
from repro_torch.core.plan import (LEVEL_AXES, ReductionLevel, ReductionPlan,
                                   resolve_plan)
from repro_torch.core.topology import HierTopology, unstack_first
from repro_torch.optim import Optimizer, sgd
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass
class SimResult:
    losses: np.ndarray          # per-round mean training loss
    accs: np.ndarray            # per-round mean training accuracy
    eval_losses: np.ndarray     # per-round eval loss of the averaged model
    eval_accs: np.ndarray
    grad_sq_norms: np.ndarray   # ||grad F(w~_n)||^2 proxy at global syncs
    state: TrainState

    @property
    def final_eval_acc(self) -> float:
        return float(self.eval_accs[-1])


class Simulator:
    """Hier-AVG / K-AVG / sync-SGD on one device.

    loss_fn(params, batch) -> (loss, metrics with 'loss' and 'accuracy').
    init_fn(generator) -> single-learner params.
    sample_batch(generator, n) -> batch with leading dim n (example axis 0
    on every leaf).  Batches and the init are drawn from one
    ``torch.Generator`` on ``device``, seeded by ``seed``.

    Not ported yet, and refused: ``faults``, ``telemetry``, ``metrics``
    and ``comm_model`` (ROADMAP Queue 1 item 5).
    """

    def __init__(self, loss_fn: Callable, init_fn: Callable,
                 sample_batch: Callable, *, topo: HierTopology,
                 hier: HierAvgParams, optimizer: Optional[Optimizer] = None,
                 algo: str = "hier", per_learner_batch: int = 32,
                 eval_batch: Optional[Any] = None, seed: int = 0,
                 reducer: Optional[Any] = None, faults: Optional[Any] = None,
                 comm_model: Optional[Any] = None,
                 telemetry: Any = None, metrics: Optional[Any] = None,
                 device="cuda"):
        for name, val in (("faults=", faults), ("comm_model=", comm_model),
                          ("telemetry=", telemetry), ("metrics=", metrics)):
            if val is not None and val is not False:
                raise NotImplementedError(
                    f"Simulator({name}) is not ported yet: ROADMAP Queue 1 "
                    f"item 5")
        self.loss_fn = loss_fn
        self.init_fn = init_fn
        self.sample = sample_batch
        self.topo = topo
        self.hier = hier
        self.optimizer = optimizer or sgd(0.1)
        self.B = per_learner_batch
        self.eval_batch = eval_batch
        self.seed = seed
        self.device = torch.device(device)
        # the plan actually trained: hier.plan / legacy (k1,k2,reducer),
        # with an explicit ``reducer`` spec/instance overriding every level
        self.plan: ReductionPlan = resolve_plan(hier, reducer)
        # outermost level's reducer == the legacy single-reducer view
        self.reducer: Reducer = self.plan.levels[-1].reducer
        # the baselines are 2-level rounds, so an N-level hier's batch
        # collapses to (1, steps) for them
        legacy_dims = hier.batch_dims if len(hier.batch_dims) == 2 \
            else (1, hier.steps_per_round)
        if algo == "hier":
            self.round_fn = make_hier_round(loss_fn, self.optimizer, hier,
                                            reducer=reducer)
            self._batch_dims = self.plan.batch_dims
            self._init_plan = self.plan
        elif algo == "kavg":
            self.round_fn = make_kavg_round(loss_fn, self.optimizer, hier.k2,
                                            reducer=self.reducer)
            self._batch_dims = legacy_dims
            # the baselines only ever reduce globally (skip_local), so a
            # 1-level plan avoids carrying an unused "local" EF state
            self._init_plan = ReductionPlan((ReductionLevel(
                "global", LEVEL_AXES["global"], hier.k2, self.reducer),))
        elif algo == "sync":
            self.round_fn = make_sync_sgd_round(loss_fn, self.optimizer,
                                                reducer=self.reducer)
            self._batch_dims = legacy_dims
            self._init_plan = ReductionPlan((ReductionLevel(
                "global", LEVEL_AXES["global"], 1, self.reducer),))
        else:
            raise ValueError(algo)

    def _eval(self, params1, batch):
        with torch.no_grad():
            return self.loss_fn(params1, batch)

    def _grad_sq(self, params1, batch) -> torch.Tensor:
        g = torch.func.grad(lambda p: self.loss_fn(p, batch)[0])(params1)
        return sum(torch.sum(torch.square(x.float())) for x in leaves(g))

    def _round_batch(self, generator: torch.Generator):
        n = self.hier.steps_per_round * self.topo.n_learners * self.B
        batch = self.sample(generator, n)
        shape = self._batch_dims + self.topo.shape + (self.B,)
        return tree_map(lambda x: x.reshape(shape + tuple(x.shape[1:])),
                        batch)

    def run(self, n_rounds: int,
            generator: Optional[torch.Generator] = None) -> SimResult:
        """Train ``n_rounds`` rounds from a fresh init.  Per-round scalars
        stay on the device until the end, then come back in one copy."""
        if generator is None:
            generator = torch.Generator(device=self.device) \
                .manual_seed(self.seed)
        state = init_state(self.topo, self.init_fn, self.optimizer,
                           generator, plan=self._init_plan,
                           device=self.device)
        rounds, evals = [], []
        for _ in range(n_rounds):
            batch = self._round_batch(generator)
            state, metrics = self.round_fn(state, batch)
            rounds.append(torch.stack([
                metrics["loss"].float(),
                metrics.get("accuracy", torch.tensor(float("nan"),
                                                     device=self.device))
                .float()]))
            if self.eval_batch is not None:
                p1 = unstack_first(state.params)
                el, em = self._eval(p1, self.eval_batch)
                evals.append(torch.stack([
                    el.float(),
                    em.get("accuracy", torch.full_like(el, float("nan")))
                    .float(),
                    self._grad_sq(p1, self.eval_batch).float()]))
        r = torch.stack(rounds).cpu().numpy() if rounds \
            else np.zeros((0, 2), np.float32)
        e = torch.stack(evals).cpu().numpy() if evals \
            else np.zeros((0, 3), np.float32)
        return SimResult(r[:, 0], r[:, 1], e[:, 0], e[:, 1], e[:, 2], state)


def run_algo_comparison(loss_fn, init_fn, sample_batch, eval_batch, *,
                        variants: Dict[str, Dict], n_rounds: int,
                        per_learner_batch: int = 32, seed: int = 0,
                        device="cuda") -> Dict[str, SimResult]:
    """Run several (algo, topo, hier) variants with the same seed/data."""
    out = {}
    for name, spec in variants.items():
        sim = Simulator(loss_fn, init_fn, sample_batch,
                        topo=spec["topo"], hier=spec["hier"],
                        optimizer=spec.get("optimizer"),
                        algo=spec.get("algo", "hier"),
                        reducer=spec.get("reducer"),
                        faults=spec.get("faults"),
                        per_learner_batch=per_learner_batch,
                        eval_batch=eval_batch, seed=seed, device=device)
        out[name] = sim.run(n_rounds)
    return out
