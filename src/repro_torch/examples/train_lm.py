"""End-to-end training example (the port of ``examples/train_lm.py``): a
~100M-parameter decoder LM trained with Hier-AVG for a few hundred steps
on a Markov corpus, with eval + checkpoint.

The default --preset 25m is the small example; --preset 100m is the
full-size one (same code).  On the card the attention runs through the
hand-written flash-attention kernels, forward and backward.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 64 \\
        [--preset 100m] [--device cpu]
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import HierAvgParams
from repro_torch.configs.base import ArchConfig, ParallelLayout
from repro_torch.core import HierTopology, Simulator, unstack_first
from repro_torch.data.synthetic import make_markov_task, markov_lm_batch
from repro_torch.examples import example_device
from repro_torch.models import build
from repro_torch.models.common import count_params
from repro_torch.optim import sgd, step_decay_lr

PRESETS = {
    # ~26M params
    "25m": dict(n_layers=4, d_model=384, n_heads=6, n_kv_heads=2,
                head_dim=64, d_ff=1152, vocab_size=4096),
    # ~101M params
    "100m": dict(n_layers=8, d_model=640, n_heads=10, n_kv_heads=2,
                 head_dim=64, d_ff=2048, vocab_size=8192),
}


def preset_config(preset: str) -> ArchConfig:
    return ArchConfig(name=f"lm-{preset}", family="dense",
                      source="examples/train_lm.py",
                      layout=ParallelLayout(1, 1, 1, 1), **PRESETS[preset])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=PRESETS, default="25m")
    ap.add_argument("--steps", type=int, default=256,
                    help="total local SGD steps (rounds = steps / k2)")
    ap.add_argument("--k1", type=int, default=2)
    ap.add_argument("--k2", type=int, default=8)
    ap.add_argument("--learners", type=int, default=4)
    ap.add_argument("--s", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "hier_avg_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    cfg = preset_config(args.preset)
    bundle = build(cfg, device=dev)
    from repro_torch.core.simulator import init_template
    n_params = count_params(init_template(bundle.init_train, dev))
    chain, floor = make_markov_task(cfg.vocab_size, temperature=1.8,
                                    device=dev)

    def sample(gen, n):
        return markov_lm_batch(gen, n, args.seq, chain)

    topo = HierTopology(1, args.learners // args.s, args.s)
    hier = HierAvgParams(k1=args.k1, k2=args.k2)
    rounds = max(1, args.steps // hier.k2)
    lr = step_decay_lr(args.lr, [3 * args.steps // 4], [0.1])

    print(f"model: {n_params/1e6:.1f}M params | task entropy floor "
          f"{floor:.3f} nats | {topo.describe()} K1={hier.k1} K2={hier.k2}")
    sim = Simulator(bundle.loss_fn, bundle.init_train, sample, topo=topo,
                    hier=hier, optimizer=sgd(lr),
                    per_learner_batch=args.batch,
                    eval_batch=sample(torch.Generator(device=dev)
                                      .manual_seed(1), 32),
                    seed=0, device=dev)
    t0 = time.time()
    res = sim.run(rounds)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    toks = rounds * hier.k2 * topo.n_learners * args.batch * args.seq
    for r in range(0, rounds, max(1, rounds // 8)):
        print(f"round {r:4d}  train={res.losses[r]:.4f} "
              f"eval={res.eval_losses[r]:.4f}")
    print(f"final: train={res.losses[-1]:.4f} eval={res.eval_losses[-1]:.4f} "
          f"(floor {floor:.3f}) | {toks} tokens in {dt:.0f}s "
          f"({toks/dt:.0f} tok/s)")
    save_checkpoint(args.ckpt, unstack_first(res.state.params),
                    step=int(res.state.step),
                    metadata={"preset": args.preset})
    print(f"checkpoint -> {args.ckpt}")
    assert np.isfinite(res.eval_losses).all()
    assert res.eval_losses[-1] < res.eval_losses[0]


if __name__ == "__main__":
    main()
