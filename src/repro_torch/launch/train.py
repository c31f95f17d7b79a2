"""Hier-AVG training driver (PyTorch port of ``repro/launch/train.py``).

Trains the arch's ``.reduced()`` smoke variant (as the reference's CLI
always does) with the Hier-AVG round on one device: the card by default,
the CPU with ``--device cpu`` (the kernels' plain versions).  ``--arch``
takes every family the port trains: the RWKV-6 LM and the dense, MoE,
MLA and VLM decoders (the VLM's batches carry the stub's patch
embeddings).

  # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
      --rounds 2 --learners 4 --s 2 --batch 2 --seq 64
  # on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
      --rounds 1 --learners 4 --s 2 --batch 2 --seq 32 --device cpu

The flags are the reference's: ``--faults`` trains elastic rounds under a
seeded fault schedule, ``--telemetry`` adds the device-side statistics,
``--metrics-out`` writes one ``train_round`` JSONL row per round,
``--trace-out`` exports the round spans as a Chrome trace,
``--profile-dir`` writes a ``torch.profiler`` trace there, and ``--ckpt``
saves the averaged model in the reference's checkpoint format.  Not
ported yet, and refused with ``NotImplementedError``: ``--autotune``
(ROADMAP Queue 1 item 8) and ``--fsdp`` above 1 (item 7).
"""
from __future__ import annotations

import argparse
import time
from contextlib import nullcontext

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.comm import DEFAULT_BUCKET_BYTES
from repro_torch.configs import get_config
from repro_torch.configs.base import HierAvgParams
from repro_torch.core import (HierTopology, init_state, make_hier_round,
                              unstack_first)
from repro_torch.core.simulator import init_template
from repro_torch.core.theory import level_reduction_seconds
from repro_torch.data.loader import HierDataLoader
from repro_torch.elastic import FaultSchedule, level_deadlines
from repro_torch.models import build
from repro_torch.models.stubs import make_train_batch
from repro_torch.optim import sgd, step_decay_lr
from repro_torch.telemetry import MetricsLogger, SpanTracer


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
                    help="elastic membership: a deterministic fault "
                         "schedule (repro_torch/elastic) driving per-round "
                         "participation masks, e.g. "
                         "'crash:0.02/flaky:pod:0.2:3/straggler:0.1:1.5' "
                         "- seeded by --seed, straggler deadlines priced "
                         "from the CommModel level walls")
    ap.add_argument("--drop-prob", type=float, default=0.0,
                    help="miss probability the --autotune search bills "
                         "rounds under")
    ap.add_argument("--telemetry", action="store_true",
                    help="device-side gradient/divergence statistics in "
                         "the round (telemetry/gradstats.py; losses bit "
                         "for bit the same, extra telemetry/* keys)")
    ap.add_argument("--metrics-out", default=None, metavar="JSONL",
                    help="write one schema-versioned train_round row "
                         "per round (telemetry/metrics.py JSONL sink)")
    ap.add_argument("--trace-out", default=None, metavar="TRACE_JSON",
                    help="export host-side round spans as a Chrome "
                         "trace (open in ui.perfetto.dev)")
    ap.add_argument("--profile-dir", default=None,
                    help="bracket rounds with torch.profiler annotations "
                         "and write the profiler's trace here")
    ap.add_argument("--ckpt", default=None,
                    help="save the averaged model here (the reference's "
                         "npz + manifest format)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "kernel versions)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.autotune:
        raise NotImplementedError("--autotune is not ported yet: ROADMAP "
                                  "Queue 1 item 8")
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
    counts = dict(plan.counts_per_round())
    template = None
    if args.faults or args.trace_out or args.profile_dir:
        template = init_template(bundle.init_train, device)
    faults = None
    if args.faults:
        faults = FaultSchedule(args.faults, topo,
                               [lvl.name for lvl in plan.levels],
                               seed=args.seed,
                               deadlines=level_deadlines(plan, topo,
                                                         template, None))

        def round_wall(fracs):
            return sum(
                counts[lvl.name] * level_reduction_seconds(
                    lvl, topo, template, None,
                    drop_prob=1.0 - float(f))[2]
                for lvl, f in zip(plan.levels, fracs))

    round_fn = make_hier_round(bundle.loss_fn, optimizer, hier,
                               elastic=faults is not None,
                               telemetry=args.telemetry or None)
    state = init_state(topo, bundle.init_train, optimizer,
                       torch.Generator(device=device).manual_seed(args.seed),
                       plan=plan, device=device)

    logger = MetricsLogger(args.metrics_out) if args.metrics_out else None
    tracer = (SpanTracer(profile_dir=args.profile_dir)
              if (args.trace_out or args.profile_dir) else None)
    modeled_phases = None
    if tracer is not None:
        # the per-level compress/collective split rides as MODELED child
        # spans priced by the same bill every analytic surface reports
        modeled_phases = []
        for lvl in plan.levels:
            comm_s, compute_s, _ = level_reduction_seconds(
                lvl, topo, template, None)
            if counts[lvl.name]:
                modeled_phases += [
                    (f"{lvl.name}/compress", compute_s * counts[lvl.name]),
                    (f"{lvl.name}/collective", comm_s * counts[lvl.name])]
        tracer.start_profiler()

    print(f"Hier-AVG: {topo.describe()}  plan={plan.describe()} "
          f"arch={cfg.name} device={device}"
          + (f"  faults={faults.describe()}" if faults else ""))
    for r in range(args.rounds):
        t0 = time.time()
        drec = None
        with (tracer.span(f"round[{r}]", args={"round": r})
              if tracer else nullcontext()):
            with tracer.span("data") if tracer else nullcontext():
                batch = loader.next_round()
            with (tracer.span("device", cat="device")
                  if tracer else nullcontext()) as drec:
                if faults is not None:
                    state, metrics = round_fn(state, batch, faults.active(r))
                else:
                    state, metrics = round_fn(state, batch)
                if tracer:
                    # bill the device wait to this span, not host_sync
                    tracer.fence(metrics)
            with (tracer.span("host_sync")
                  if tracer else nullcontext()):
                # one device->host copy for the round's metrics
                m = {k: float(v) for k, v in
                     zip(metrics, torch.stack([v.float() for v in
                                               metrics.values()]).tolist())}
        wall = time.time() - t0
        if tracer and modeled_phases:
            tracer.add_modeled_children(drec, modeled_phases)
        if faults is not None:
            # host-side schedule mask: no extra device read for fracs
            fracs = [float(f) for f in faults.active_frac(r)]
            extra = ("  active=" + "/".join(
                f"{lvl.name}:{f:.2f}" for lvl, f in zip(plan.levels, fracs))
                + f" wall~{round_wall(fracs) * 1e3:.2f}ms")
        else:
            fracs, extra = None, ""
        print(f"round {r:3d}  loss={m['loss']:.4f} "
              f"acc={m.get('accuracy', float('nan')):.3f} "
              f"({wall:.1f}s, "
              f"{loader.tokens_per_round * args.seq} tokens)" + extra,
              flush=True)
        if logger is not None:
            row = {"round": r, "loss": m["loss"],
                   "accuracy": m.get("accuracy", float("nan")),
                   "wall_s": wall, "plan": plan.describe()}
            row.update({k: v for k, v in m.items()
                        if k.startswith("telemetry/")})
            if fracs is not None:
                row["active_frac"] = {
                    lvl.name: f for lvl, f in zip(plan.levels, fracs)}
                row["modeled_wall_s"] = round_wall(fracs)
            logger.log_row("train_round", **row)

    if tracer is not None:
        tracer.stop_profiler()
        if args.trace_out:
            tracer.export_chrome_trace(args.trace_out)
            print(f"wrote Chrome trace to {args.trace_out} "
                  f"(open in ui.perfetto.dev)")
    if logger is not None:
        logger.close()
        print(f"wrote {args.rounds} train_round rows to "
              f"{args.metrics_out}")
    if args.ckpt:
        save_checkpoint(args.ckpt, unstack_first(state.params),
                        step=int(state.step))
        print(f"saved averaged model to {args.ckpt}")


if __name__ == "__main__":
    main()
