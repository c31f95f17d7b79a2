"""Hier-AVG training driver (PyTorch port of ``repro/launch/train.py``).

Trains the arch's ``.reduced()`` smoke variant (as the reference's CLI
always does) with the Hier-AVG round on one device: the card by default,
the CPU with ``--device cpu`` (the kernels' plain versions).

  # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
      --rounds 2 --learners 4 --s 2 --batch 2 --seq 64
  # on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
      --rounds 1 --learners 4 --s 2 --batch 2 --seq 32 --device cpu

The flags are the reference's.  Not ported yet, and refused with
``NotImplementedError``: ``--ckpt``, ``--faults``, ``--telemetry``,
``--metrics-out``, ``--trace-out``, ``--profile-dir`` (ROADMAP Queue 1
item 5), ``--autotune`` (item 8) and ``--fsdp`` above 1 (item 7).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.comm import DEFAULT_BUCKET_BYTES
from repro_torch.configs import get_config
from repro_torch.configs.base import HierAvgParams
from repro_torch.core import HierTopology, init_state, make_hier_round
from repro_torch.data.loader import HierDataLoader
from repro_torch.models import build
from repro_torch.models.stubs import make_train_batch
from repro_torch.optim import sgd, step_decay_lr

_UNPORTED = (("ckpt", "--ckpt", "5"), ("faults", "--faults", "5"),
             ("telemetry", "--telemetry", "5"),
             ("metrics_out", "--metrics-out", "5"),
             ("trace_out", "--trace-out", "5"),
             ("profile_dir", "--profile-dir", "5"),
             ("autotune", "--autotune", "8"))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--k1", type=int, default=2)
    ap.add_argument("--k2", type=int, default=4)
    ap.add_argument("--learners", type=int, default=4)
    ap.add_argument("--s", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--reducer", default="mean",
                    help="reduction payload spec (comm/): mean | "
                         "cast[:dtype] | topk[:ratio] | randk[:ratio] | "
                         "qint8[:block] | powersgd[:rank]")
    ap.add_argument("--plan", default=None,
                    help="N-level reduction plan spec, e.g. "
                         "'local@4:cast:bfloat16/pod@8/global@16:topk:0.05'"
                         " - wins over --k1/--k2/--reducer")
    ap.add_argument("--bucket-bytes", type=int,
                    default=DEFAULT_BUCKET_BYTES,
                    help="flat-buffer bucket cap for compressed reducers "
                         "(comm/bucket.py); 0 = per-leaf reductions")
    ap.add_argument("--no-overlap", action="store_true",
                    help="pin the serial bucket schedule (default: the "
                         "pipelined engine)")
    ap.add_argument("--fsdp", type=int, default=1,
                    help="shard the per-learner trailing dims F ways "
                         "(not ported: ROADMAP Queue 1 item 7)")
    ap.add_argument("--autotune", default=None, metavar="CALIB_JSON",
                    help="cost-aware plan search (not ported: item 8)")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="elastic fault schedule (not ported: item 5)")
    ap.add_argument("--drop-prob", type=float, default=0.0,
                    help="miss probability the --autotune search bills "
                         "rounds under")
    ap.add_argument("--telemetry", action="store_true",
                    help="gradient statistics (not ported: item 5)")
    ap.add_argument("--metrics-out", default=None, metavar="JSONL",
                    help="train_round rows (not ported: item 5)")
    ap.add_argument("--trace-out", default=None, metavar="TRACE_JSON",
                    help="Chrome trace of round spans (not ported: item 5)")
    ap.add_argument("--profile-dir", default=None,
                    help="profiler traces (not ported: item 5)")
    ap.add_argument("--ckpt", default=None,
                    help="save the averaged model (not ported: item 5)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "kernel versions)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    for attr, flag, item in _UNPORTED:
        if getattr(args, attr):
            raise NotImplementedError(f"{flag} is not ported yet: ROADMAP "
                                      f"Queue 1 item {item}")
    if args.fsdp > 1:
        raise NotImplementedError("--fsdp > 1 is not ported yet: ROADMAP "
                                  "Queue 1 item 7")
    if args.learners % args.s:
        raise ValueError(f"--learners {args.learners} is not a multiple of "
                         f"--s {args.s}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available; pass "
                           "--device cpu to run on the CPU")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    topo = HierTopology(pods=1, groups=args.learners // args.s,
                        local=args.s)
    hier = HierAvgParams(k1=args.k1, k2=args.k2, reducer=args.reducer,
                         plan=args.plan, bucket_bytes=args.bucket_bytes,
                         overlap=not args.no_overlap)
    bundle = build(cfg, device=device)
    plan = hier.resolved_plan
    optimizer = sgd(step_decay_lr(
        args.lr, [args.rounds * hier.steps_per_round * 3 // 4], [0.1]))

    def sample(gen, n):
        return make_train_batch(gen, cfg, batch=n, seq_len=args.seq)

    loader = HierDataLoader(sample, topo=topo, hier=hier,
                            per_learner_batch=args.batch, seed=args.seed,
                            device=device)
    round_fn = make_hier_round(bundle.loss_fn, optimizer, hier)
    state = init_state(topo, bundle.init_train, optimizer,
                       torch.Generator(device=device).manual_seed(args.seed),
                       plan=plan, device=device)

    print(f"Hier-AVG: {topo.describe()}  plan={plan.describe()} "
          f"arch={cfg.name} device={device}")
    for r in range(args.rounds):
        t0 = time.time()
        batch = loader.next_round()
        state, metrics = round_fn(state, batch)
        # one device->host copy for the round's metrics
        m = {k: float(v) for k, v in
             zip(metrics, torch.stack([v.float() for v in
                                       metrics.values()]).tolist())}
        wall = time.time() - t0
        print(f"round {r:3d}  loss={m['loss']:.4f} "
              f"acc={m.get('accuracy', float('nan')):.3f} "
              f"({wall:.1f}s, "
              f"{loader.tokens_per_round * args.seq} tokens)", flush=True)


if __name__ == "__main__":
    main()
