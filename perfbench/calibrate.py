#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, for one
cell, in one process on the card: the program against the plain
reference over many seeds (the sound runs), the reference computed with
TF32 on against itself with TF32 off (the control), and planted faults
(half of each batch left out; the learner mean left out; the top-k
residual left out) against the reference.  A round that returns its
state unchanged reads 1 on change_gap, and a top-k reference left where
it was reads 1 on ref_gap, by the measure's definition: neither is run.

  python3 perfbench/calibrate.py --workload resnet18-p16-topk \
      --seeds 11 12 13 --control 3 --faults 3

Prints one JSON line per reading, then each number's largest sound
reading and smallest control and fault readings.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def worst(prog, ref, key, n=4):
    import statistics
    med = statistics.median(ref[key].values())
    gaps = sorted(((abs(prog[key][k] - ref[key][k]) / max(ref[key][k], med),
                    k) for k in ref[key]), reverse=True)[:n]
    return [[k, g] for g, k in gaps]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3,
                    help="how many of the seeds also read the control")
    ap.add_argument("--faults", type=int, default=3,
                    help="how many of the seeds also read each fault")
    ap.add_argument("--witness", action="store_true",
                    help="also read the program with its models' plain "
                         "kernels (impl='plain') against the reference")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from perfbench.bench import check, faults, harness
    from perfbench.bench.spec import Spec

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    adapter = spec.model(cfg["model"])
    specs = adapter.param_specs(cfg)
    harness.set_precision(cfg["precision"])
    dev = "cuda"
    from repro_torch.kernels import _build
    _build.build_all(cfg.get("kernels", []) + traffic.get("kernels", []))
    best = {}

    def note(kind, seed, prog, ref, t0):
        nums = check.numbers(prog, ref)
        row = {"kind": kind, "seed": seed,
               "seconds": round(time.perf_counter() - t0, 2),
               "numbers": nums, "loss": prog["loss"],
               "ref_loss": ref["loss"],
               "grad_leaves": worst(prog, ref, "grad_norms"),
               "change_leaves": worst(prog, ref, "change_norms")}
        print(json.dumps(row), flush=True)
        for name in ("loss_gap", "grad_gap", "change_gap", "change_median",
                     "ef_gap", "ref_gap"):
            if name not in nums:
                continue
            v = nums[name]["value"]
            key = (kind, name)
            if kind == "sound":
                best[key] = max(best.get(key, 0.0), v)
            else:
                best[key] = min(best.get(key, float("inf")), v)

    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        prog, mine, feed = harness.program_readings(cfg, traffic, adapter,
                                                    specs, seed, dev)
        del prog
        harness.free(dev)
        ref = harness.reference_readings(cfg, traffic, adapter, specs, seed,
                                         feed, dev)
        note("sound", seed, mine, ref, t0)
        if args.witness:
            t0 = time.perf_counter()
            p, wit, _ = harness.program_readings(cfg, traffic, adapter, specs,
                                                 seed, dev, impl="plain")
            del p
            harness.free(dev)
            note("witness_plain", seed, wit, ref, t0)
        if i < args.control:
            t0 = time.perf_counter()
            ctl = harness.reference_readings(cfg, traffic, adapter, specs,
                                             seed, feed, dev, tf32=True)
            note("control_tf32", seed, ctl, ref, t0)
        if i < args.faults:
            for name in ("half_batch",):
                t0 = time.perf_counter()
                p, bad, _ = harness.program_readings(
                    cfg, traffic, adapter, specs, seed, dev,
                    faults.WRAPS[name])
                del p
                harness.free(dev)
                note(name, seed, bad, ref, t0)
            for name in ("no_exchange", "dropped_residual"):
                t0 = time.perf_counter()
                with faults.PATCHES[name]():
                    p, bad, _ = harness.program_readings(
                        cfg, traffic, adapter, specs, seed, dev)
                del p
                harness.free(dev)
                note(name, seed, bad, ref, t0)
        del feed
        harness.free(dev)
    print(json.dumps({"summary": {f"{k}/{n}": v
                                  for (k, n), v in sorted(best.items())},
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
