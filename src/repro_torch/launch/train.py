"""Hier-AVG training driver (PyTorch port of ``repro/launch/train.py``).

Trains the arch's ``.reduced()`` smoke variant (as the reference's CLI
always does) with the Hier-AVG round on one device: the card by default,
the CPU with ``--device cpu`` (the kernels' plain versions).  ``--arch``
takes every family: the RWKV-6 and Hymba LMs, the dense, MoE, MLA and VLM
decoders (the VLM's batches carry the stub's patch embeddings) and the
encoder-decoder (its batches carry stub audio frames).

  # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
      --rounds 2 --learners 4 --s 2 --batch 2 --seq 64
  # on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
      --rounds 1 --learners 4 --s 2 --batch 2 --seq 32 --device cpu

The flags are the reference's: ``--faults`` trains elastic rounds under a
seeded fault schedule, ``--telemetry`` adds the device-side statistics,
``--metrics-out`` writes one ``train_round`` JSONL row per round,
``--trace-out`` exports the rounds' spans as a Chrome trace (``data``,
``device``, ``host_sync`` and the round's own ``hier.*`` and ``comm.*``,
telemetry/spans.py), ``--profile-dir`` writes a ``torch.profiler`` trace
there, on the same clock as ``--trace-out``'s, ``--ckpt``
saves the averaged model in the reference's checkpoint format, and
``--autotune CALIB_JSON`` ranks plans under a calibration artifact
(``repro_torch.autotune``: probe, then calibrate), trains the top one
and reports its measured round wall against the calibrated bill:

  PYTHONPATH=src python -m repro_torch.autotune.probe --out probe.json
  PYTHONPATH=src python -m repro_torch.autotune.calibrate probe.json \
      --out calib.json
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
      --rounds 2 --autotune calib.json

Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT`` set) the learners spread over the ranks
of the world as the reference's hier mesh lays them
(``launch/mesh.py::rank_mesh``), ``--fsdp F`` giving each learner F ranks
whose shard-aware buckets reduce by reduce-scatter + all-gather.  Each
rank runs on ``cuda:LOCAL_RANK``, or all on ``cuda:0`` with
``--share-device`` (gloo only: NCCL refuses two ranks on one card).
Rank 0 alone prints and writes metrics, traces and checkpoints; the
printed loss is the whole grid's, and so are the ``telemetry/*``
statistics (computed across the ranks).  Each round starts on a barrier
and its wall is the largest over the ranks.  With ``--autotune`` every
rank runs the search, and the ranks' plans are checked to be one before
any level's process group is made.

  torchrun --nproc_per_node 2 -m repro_torch.launch.train \
      --arch rwkv6-1.6b --fsdp 2 --backend gloo --share-device
"""
from __future__ import annotations

import argparse
import json
import os
import time
from contextlib import nullcontext

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.comm import DEFAULT_BUCKET_BYTES
from repro_torch.configs import get_config
from repro_torch.configs.base import HierAvgParams
from repro_torch.core import (HierTopology, init_state, make_hier_round,
                              unstack_first)
from repro_torch.core.plan import apply_shards
from repro_torch.launch.mesh import level_process_groups
from repro_torch.core.simulator import init_template
from repro_torch.core.theory import level_reduction_seconds
from repro_torch.data.loader import HierDataLoader
from repro_torch.elastic import FaultSchedule, level_deadlines
from repro_torch.models import build
from repro_torch.models.stubs import make_train_batch
from repro_torch.optim import sgd, step_decay_lr
from repro_torch.telemetry import MetricsLogger, SpanTracer
from repro_torch.telemetry.spans import installed


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
                    help="F ranks per learner (parallel/sharding.py "
                         "ShardPlan): bucketed reductions pack shard-local "
                         "runs and reduce them by reduce-scatter + "
                         "all-gather; needs torchrun with learners x F "
                         "or clusters x F ranks")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="torch.distributed backend under torchrun "
                         "(default nccl on cuda, gloo on cpu)")
    ap.add_argument("--share-device", action="store_true",
                    help="put every rank on cuda:0 (gloo; for one card)")
    ap.add_argument("--autotune", default=None, metavar="CALIB_JSON",
                    help="calibration artifact (autotune/calibrate.py); "
                         "runs the cost-aware plan search over the "
                         "model's parameter tree and trains the "
                         "recommended plan - wins over --plan/--k1/--k2")
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
                         "for bit the same, extra telemetry/* keys; under "
                         "torchrun the whole grid's, across the ranks)")
    ap.add_argument("--metrics-out", default=None, metavar="JSONL",
                    help="write one schema-versioned train_round row "
                         "per round (telemetry/metrics.py JSONL sink)")
    ap.add_argument("--trace-out", default=None, metavar="TRACE_JSON",
                    help="export the rounds' host-side spans, the "
                         "round's own hier.*/comm.* included, as a "
                         "Chrome trace (open in ui.perfetto.dev)")
    ap.add_argument("--profile-dir", default=None,
                    help="run the rounds under torch.profiler, the "
                         "spans as its annotations, and write its trace "
                         "here (on --trace-out's clock)")
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
    if args.learners % args.s:
        raise ValueError(f"--learners {args.learners} is not a multiple of "
                         f"--s {args.s}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available; pass "
                           "--device cpu to run on the CPU")
    topo = HierTopology(pods=1, groups=args.learners // args.s,
                        local=args.s)
    mesh = None
    if "WORLD_SIZE" in os.environ:
        mesh, device = _join_world(args, topo, device)
    elif args.fsdp > 1:
        raise RuntimeError(f"--fsdp {args.fsdp} needs a process group: "
                           f"start the run with torchrun (--nproc_per_node "
                           f"= learners x fsdp or clusters x fsdp)")
    try:
        _train(args, topo, mesh, device)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _join_world(args, topo, device):
    """Join the torchrun world and lay the learners over it: (the bound
    mesh, this rank's device)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import rank_mesh
    from repro_torch.parallel import collectives
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device.type == "cuda":
        device = torch.device("cuda", 0 if args.share_device
                              else int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and args.share_device and world > 1:
        raise ValueError("NCCL refuses two ranks on one card: use "
                         "--backend gloo with --share-device")
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ.get("MASTER_PORT", "29500")
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world)
    mesh = rank_mesh(topo, args.fsdp, world, rank)
    if backend == "gloo" and device.type == "cuda":
        refused = collectives.probe_gloo_cuda(device)
        if refused:
            raise RuntimeError(f"this gloo build refuses {refused} on CUDA "
                               f"tensors: run one rank per card on NCCL")
    return mesh, device


def _train(args, topo, mesh, device) -> None:
    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import make_constraint_fn, shard_plan
    lead = mesh is None or mesh.rank == 0
    shards = None if mesh is None else shard_plan(mesh)
    cf = None if mesh is None else make_constraint_fn(mesh)
    block = topo if mesh is None else mesh.block_topology(topo)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    hier = HierAvgParams(k1=args.k1, k2=args.k2, reducer=args.reducer,
                         plan=args.plan, bucket_bytes=args.bucket_bytes,
                         overlap=not args.no_overlap)
    bundle = build(cfg, device=device)
    controller = None
    if args.autotune:
        hier, controller = _autotune(args, topo, hier, bundle, shards,
                                     device, lead)
        if mesh is not None:
            _same_plan_on_every_rank(hier.plan, device)
    plan = apply_shards(hier.resolved_plan, shards)
    groups = {} if mesh is None else level_process_groups(mesh, plan)
    optimizer = sgd(step_decay_lr(
        args.lr, [args.rounds * hier.steps_per_round * 3 // 4], [0.1]))

    def sample(gen, n):
        return make_train_batch(gen, cfg, batch=n, seq_len=args.seq)

    loader = HierDataLoader(sample, topo=topo, hier=hier,
                            per_learner_batch=args.batch, seed=args.seed,
                            mesh=mesh, device=device)
    counts = dict(plan.counts_per_round())
    faults = None
    if args.faults:
        template = init_template(bundle.init_train, device)
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
                               telemetry=args.telemetry or None,
                               mesh=mesh, constraint_fn=cf, shards=shards)
    state = init_state(block, bundle.init_train, optimizer,
                       torch.Generator(device=device).manual_seed(args.seed),
                       plan=plan, shards=shards, device=device)

    logger = (MetricsLogger(args.metrics_out)
              if args.metrics_out and lead else None)
    tracer = (SpanTracer(profile_dir=args.profile_dir)
              if (args.trace_out or args.profile_dir) and lead else None)
    if tracer is not None:
        tracer.start_profiler()

    if lead:
        print(f"Hier-AVG: {topo.describe()}  plan={plan.describe()} "
              f"arch={cfg.name} device={device}"
              + (f"  faults={faults.describe()}" if faults else "")
              + ("" if mesh is None else
                 f"  mesh={tuple(mesh.shape.values())} ranks="
                 f"{mesh.size} backend={_backend()} level groups="
                 + "/".join(f"{k}:{_ranks(g)}" for k, g in groups.items())))
    # installed, the tracer also records the round's own spans
    # (hier.*, comm.*)
    with installed(tracer):
        for r in range(args.rounds):
            if mesh is not None:
                # the round's wall is the world's: every rank starts
                # together
                collectives.barrier()
            t0 = time.time()
            with (tracer.span(f"round[{r}]", args={"round": r})
                  if tracer else nullcontext()):
                with tracer.span("data") if tracer else nullcontext():
                    batch = loader.next_round()
                with (tracer.span("device", cat="device")
                      if tracer else nullcontext()):
                    if faults is not None:
                        state, metrics = round_fn(state, batch,
                                                  faults.active(r))
                    else:
                        state, metrics = round_fn(state, batch)
                    if tracer:
                        # bill the device wait to this span, not host_sync
                        tracer.fence(metrics)
                with (tracer.span("host_sync")
                      if tracer else nullcontext()):
                    # one device->host copy for the round's metrics (the
                    # whole grid's: one all-reduce over the world; the
                    # telemetry statistics are the grid's on every rank)
                    vec = torch.stack([v.float() for v in metrics.values()])
                    if mesh is not None:
                        vec = torch.where(
                            torch.tensor([k.startswith("telemetry/")
                                          for k in metrics],
                                         device=vec.device),
                            vec, collectives.world_mean(vec))
                    m = {k: float(v) for k, v in zip(metrics, vec.tolist())}
            wall = time.time() - t0
            if mesh is not None:
                wall = collectives.world_max(wall, device)
            if faults is not None:
                # host-side schedule mask: no extra device read for fracs
                fracs = [float(f) for f in faults.active_frac(r)]
                extra = ("  active=" + "/".join(
                    f"{lvl.name}:{f:.2f}"
                    for lvl, f in zip(plan.levels, fracs))
                    + f" wall~{round_wall(fracs) * 1e3:.2f}ms")
            else:
                fracs, extra = None, ""
            if lead:
                print(f"round {r:3d}  loss={m['loss']:.4f} "
                      f"acc={m.get('accuracy', float('nan')):.3f} "
                      f"({wall:.1f}s, "
                      f"{loader.tokens_per_round * args.seq} tokens)" + extra,
                      flush=True)
            if logger is not None or controller is not None:
                row = {"round": r, "loss": m["loss"],
                       "accuracy": m.get("accuracy", float("nan")),
                       "wall_s": wall, "plan": plan.describe()}
                row.update({k: v for k, v in m.items()
                            if k.startswith("telemetry/")})
                if fracs is not None:
                    row["active_frac"] = {
                        lvl.name: f for lvl, f in zip(plan.levels, fracs)}
                    row["modeled_wall_s"] = round_wall(fracs)
                if logger is not None:
                    logger.log_row("train_round", **row)
                if controller is not None:
                    controller.observe(row)

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
    if (controller is not None and lead
            and controller.observed_wall_s is not None):
        print(f"controller: measured {controller.observed_wall_s * 1e3:.2f}"
              f"ms/round vs modeled comm "
              f"{controller.modeled_round_wall_s * 1e3:.3f}ms "
              f"(x{controller.wall_bias():.0f} incl. compute/host; "
              f"wall_bias={controller.wall_bias():.6g})")
    if mesh is not None and lead:
        print(f"collectives: {json.dumps(collectives.counts())}")
    if args.ckpt and lead:
        # rank 0's first learner is the grid's learner (0, 0, 0)
        save_checkpoint(args.ckpt, unstack_first(state.params),
                        step=int(state.step))
        print(f"saved averaged model to {args.ckpt}")


def _autotune(args, topo, hier, bundle, shards, device, lead):
    """The reference's ``--autotune``: load the calibration, rank the plans
    over the model's parameter tree (meta tensors), print the top 3, and
    return (``hier`` training the first, a ``CostAwarePlan`` observing
    its rounds)."""
    import dataclasses

    from repro_torch.autotune import (Calibration, CostAwarePlan,
                                      search_plans)
    cal = Calibration.load(args.autotune)
    template = init_template(bundle.init_train, device)
    ranked = search_plans(topo, cal, template=template, B=args.batch,
                          T_ref=args.rounds * hier.steps_per_round,
                          bucket_bytes=hier.bucket_bytes,
                          overlap=hier.overlap, top=3,
                          drop_prob=args.drop_prob)
    if lead:
        print(f"autotune [{args.autotune}; fitted {list(cal.fitted)}"
              + (f"; drop_prob={args.drop_prob:g}" if args.drop_prob
                 else "") + "]:")
        for i, sp in enumerate(ranked):
            print(f"  #{i} {sp.spec}  comm_ms/step="
                  f"{sp.comm_s_per_step * 1e3:.3f} score={sp.score:.3e} "
                  f"feasible={sp.feasible}")
    hier = dataclasses.replace(hier, plan=ranked[0].spec)
    controller = CostAwarePlan(plan=ranked[0].spec, topo=topo, comm=cal,
                               template=template,
                               bucket_bytes=hier.bucket_bytes,
                               overlap=hier.overlap, shards=shards,
                               drop_prob=args.drop_prob)
    return hier, controller


def _plan_hash(spec: str) -> int:
    """A plan spec's sha256, cut to a non-negative int64."""
    import hashlib
    return int.from_bytes(hashlib.sha256(spec.encode()).digest()[:7], "big")


def _same_plan_on_every_rank(spec: str, device) -> None:
    """Fail unless every rank of the world chose ``spec``: each rank's
    plan hash, gathered.  Different plans would make different process
    groups and collectives, and the world would hang."""
    import torch.distributed as dist

    from repro_torch.parallel import collectives
    got = collectives.all_gather(
        torch.tensor([_plan_hash(spec)], dtype=torch.int64, device=device),
        None, dist.get_world_size()).tolist()
    if len(set(got)) != 1:
        raise RuntimeError(f"--autotune: the ranks chose different plans "
                           f"(plan hashes by rank {got}; this rank "
                           f"{dist.get_rank()} chose {spec!r})")


def _backend() -> str:
    import torch.distributed as dist
    return str(dist.get_backend())


def _ranks(group) -> int:
    """The ranks of a level's process group (1: inside this rank)."""
    import torch.distributed as dist
    return 1 if group is None else dist.get_world_size(group)


if __name__ == "__main__":
    main()
