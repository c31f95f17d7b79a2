"""Quickstart: Hier-AVG in ~40 lines (the port of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Trains P=8 learners (2 clusters of S=4) on a Markov LM task with K1=2
local steps between local reductions and K2=4 between global ones.
"""
import argparse

import torch

from repro_torch.configs import HierAvgParams, get_config
from repro_torch.core import HierTopology, Simulator
from repro_torch.data.synthetic import make_markov_task, markov_lm_batch
from repro_torch.examples import example_device
from repro_torch.models import build
from repro_torch.optim import sgd


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = example_device(ap.parse_args(argv).device)

    # 1. a model from the assigned pool (reduced so it runs on CPU)
    cfg = get_config("rwkv6-1.6b").reduced()
    bundle = build(cfg, device=dev)

    # 2. a data source — each learner will draw i.i.d. batches from it
    chain, entropy_floor = make_markov_task(cfg.vocab_size, temperature=2.0,
                                            device=dev)
    sample = lambda gen, n: markov_lm_batch(gen, n, 32, chain)  # noqa: E731

    # 3. the paper's knobs: P = pods*groups*local learners, S = local
    topo = HierTopology(pods=1, groups=2, local=4)       # P=8, S=4
    hier = HierAvgParams(k1=2, k2=4)                     # beta = 2

    # 4. run rounds: K1 local SGD steps -> local average -> ... -> global
    sim = Simulator(bundle.loss_fn, bundle.init_train, sample, topo=topo,
                    hier=hier, optimizer=sgd(0.5), per_learner_batch=4,
                    eval_batch=sample(torch.Generator(device=dev)
                                      .manual_seed(0), 64),
                    seed=0, device=dev)
    result = sim.run(n_rounds=5)

    print(f"topology: {topo.describe()}, K1={hier.k1}, K2={hier.k2}")
    print(f"entropy floor of the task: {entropy_floor:.3f} nats")
    for r, (tr, ev) in enumerate(zip(result.losses, result.eval_losses)):
        print(f"round {r}: train_loss={tr:.4f}  eval_loss={ev:.4f}")
    assert result.eval_losses[-1] < result.eval_losses[0]
    print("OK: loss decreased under hierarchical averaging.")


if __name__ == "__main__":
    main()
