"""Single-device Hier-AVG simulator (PyTorch port of
``repro/core/simulator.py``).

Runs P learners on one device — the card unless the caller asks for
``device="cpu"`` — with the stacked-learner code of core/hier_avg.py.
Used for the paper-shape runs (K2 / K1 / S sweeps, vs-K-AVG) and by
``chip_smoke.py`` to train ResNet-18 at full width.
"""
from __future__ import annotations

import dataclasses
import time
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
    # elastic (faults=) runs only: per-round participation fraction per
    # plan level [n_rounds, n_levels] and the modeled round wall seconds
    # under that round's actual participation
    active_fracs: Optional[np.ndarray] = None
    round_wall_s: Optional[np.ndarray] = None
    # metrics= runs only: measured per-round wall seconds (each round is
    # fenced by a synchronize — the documented telemetry cost)
    measured_wall_s: Optional[np.ndarray] = None
    # telemetry= runs only: per-round means of every device-side
    # ``telemetry/...`` stat key (gradstats.py), [n_rounds] each
    stats: Optional[Dict[str, np.ndarray]] = None

    @property
    def final_eval_acc(self) -> float:
        return float(self.eval_accs[-1])


def init_template(init_fn: Callable, device) -> Any:
    """The single-learner parameter tree of ``init_fn`` as meta tensors
    (shapes and dtypes): ``init_fn`` runs once under ``FakeTensorMode``
    with a generator of its own, so nothing is allocated on the device
    and the caller's generators are not drawn from."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    gen = torch.Generator(device=device).manual_seed(0)
    with FakeTensorMode(allow_non_fake_inputs=True):
        tree = init_fn(gen)
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), tree)


class Simulator:
    """Hier-AVG / K-AVG / sync-SGD on one device.

    loss_fn(params, batch) -> (loss, metrics with 'loss' and 'accuracy').
    init_fn(generator) -> single-learner params.
    sample_batch(generator, n) -> batch with leading dim n (example axis 0
    on every leaf).  Batches and the init are drawn from one
    ``torch.Generator`` on ``device``, seeded by ``seed``.

    ``faults`` (a FaultSchedule or a spec string, hier only) drives
    per-round participation masks through the elastic round;
    ``comm_model`` prices straggler deadlines and modeled round walls
    (core/theory.py); ``telemetry`` adds the device-side statistics of
    telemetry/gradstats.py; ``metrics`` (a MetricsLogger) receives one
    ``train_round`` row per round, with each round fenced so that its
    wall is measured.  The parameter template these need comes from
    :func:`init_template`: shapes only, nothing allocated.
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
        # elastic membership: a FaultSchedule (or spec string — parsed
        # against this plan's levels, with straggler deadlines priced
        # from the CommModel level walls) drives per-round participation
        # masks through the elastic round
        self.comm_model = comm_model
        self._template = None
        self._wall_cache: Dict[tuple, float] = {}
        self.faults = None
        if faults is not None:
            if algo != "hier":
                raise ValueError(
                    f"fault injection needs the elastic hier round; "
                    f"algo={algo!r} does not take masks")
            from repro_torch.elastic import FaultSchedule, level_deadlines
            if isinstance(faults, FaultSchedule):
                self.faults = faults
            else:
                self.faults = FaultSchedule(
                    faults, topo, [lvl.name for lvl in self.plan.levels],
                    seed=seed,
                    deadlines=level_deadlines(self.plan, topo,
                                              self.template(), comm_model))
        # the baselines are 2-level rounds, so an N-level hier's batch
        # collapses to (1, steps) for them
        legacy_dims = hier.batch_dims if len(hier.batch_dims) == 2 \
            else (1, hier.steps_per_round)
        self.telemetry = telemetry
        self.metrics = metrics
        if telemetry and algo != "hier":
            raise ValueError(
                f"telemetry= needs the hier round; algo={algo!r} has no "
                f"per-level reduction to instrument")
        if algo == "hier":
            self.round_fn = make_hier_round(loss_fn, self.optimizer, hier,
                                            reducer=reducer,
                                            elastic=self.faults is not None,
                                            telemetry=telemetry)
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

    def template(self):
        """The single-learner parameter template (meta tensors), built
        once."""
        if self._template is None:
            self._template = init_template(self.init_fn, self.device)
        return self._template

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

    def payload_bytes_per_reduction(self) -> int:
        """Analytic per-learner wire bytes of one outermost (global)
        reduction under the configured plan (dense fp32 for "mean")."""
        return self.reducer.payload_bytes(self.template())

    def payload_bytes_per_level(self) -> Dict[str, int]:
        """Per-level analytic wire bytes of one reduction at each plan
        level (per learner)."""
        return {lvl.name: lvl.reducer.payload_bytes(self.template())
                for lvl in self.plan.levels}

    def round_wall_estimate(self, fracs) -> float:
        """Modeled wall seconds of one round whose per-level participation
        fractions were ``fracs`` (aligned with ``plan.levels``): each
        level's billable count times its scheduled wall at an effective
        drop probability of ``1 - frac`` (core/theory.py n_eff billing).
        Memoized on the fraction tuple — a fleet takes few distinct
        participation patterns."""
        from repro_torch.core.theory import level_reduction_seconds
        key = tuple(round(float(f), 6) for f in fracs)
        if key in self._wall_cache:
            return self._wall_cache[key]
        counts = dict(self.plan.counts_per_round())
        wall = 0.0
        for lvl, f in zip(self.plan.levels, key):
            wall += counts[lvl.name] * level_reduction_seconds(
                lvl, self.topo, self.template(), self.comm_model,
                drop_prob=1.0 - f)[2]
        self._wall_cache[key] = wall
        return wall

    def run(self, n_rounds: int,
            generator: Optional[torch.Generator] = None) -> SimResult:
        """Train ``n_rounds`` rounds from a fresh init.  Per-round scalars
        stay on the device until the end, then come back in one copy.
        Participation fractions come from the host-side FaultSchedule
        mask (no device read).  With a ``metrics=`` logger each round is
        fenced by a synchronize to measure its wall — that serialization
        is the logger's documented cost, off by default."""
        if generator is None:
            generator = torch.Generator(device=self.device) \
                .manual_seed(self.seed)
        state = init_state(self.topo, self.init_fn, self.optimizer,
                           generator, plan=self._init_plan,
                           device=self.device)
        rounds, evals, stats = [], [], []
        fracs, walls, measured = [], [], []
        observe = self.metrics is not None
        stat_keys = None
        for r in range(n_rounds):
            batch = self._round_batch(generator)
            t0 = time.perf_counter() if observe else 0.0
            if self.faults is not None:
                state, metrics = self.round_fn(state, batch,
                                               self.faults.active(r))
                f = [float(x) for x in self.faults.active_frac(r)]
                fracs.append(f)
                walls.append(self.round_wall_estimate(f))
            else:
                state, metrics = self.round_fn(state, batch)
            if observe:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                measured.append(time.perf_counter() - t0)
            rounds.append(torch.stack([
                metrics["loss"].float(),
                metrics.get("accuracy", torch.tensor(float("nan"),
                                                     device=self.device))
                .float()]))
            if stat_keys is None:
                stat_keys = sorted(k for k in metrics
                                   if k.startswith("telemetry/"))
            if stat_keys:
                stats.append(torch.stack([metrics[k].float()
                                          for k in stat_keys]))
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
        st = torch.stack(stats).cpu().numpy() if stats else None
        res = SimResult(
            r[:, 0], r[:, 1], e[:, 0], e[:, 1], e[:, 2], state,
            active_fracs=np.array(fracs) if fracs else None,
            round_wall_s=np.array(walls) if walls else None,
            measured_wall_s=np.array(measured) if measured else None,
            stats=({k: st[:, i] for i, k in enumerate(stat_keys)}
                   if st is not None else None))
        if observe:
            self._log_rows(res, n_rounds)
        return res

    def _log_rows(self, res: SimResult, n_rounds: int) -> None:
        """One schema-versioned train_round row per round (telemetry/
        metrics.py) plus the typed-channel aggregates."""
        names = [lvl.name for lvl in self.plan.levels]
        for r in range(n_rounds):
            row = {"round": r, "loss": float(res.losses[r]),
                   "accuracy": float(res.accs[r]),
                   "wall_s": float(res.measured_wall_s[r]),
                   "plan": self.plan.describe()}
            if res.active_fracs is not None:
                row["active_frac"] = dict(
                    zip(names, (float(f) for f in res.active_fracs[r])))
                row["modeled_wall_s"] = float(res.round_wall_s[r])
            if res.stats:
                row.update({k: float(v[r]) for k, v in res.stats.items()})
            self.metrics.log_row("train_round", **row)
            self.metrics.count("train/rounds")
            self.metrics.histogram("train/round_wall_s", row["wall_s"])
        self.metrics.gauge("train/loss", float(res.losses[-1]))
        self.metrics.flush()


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
