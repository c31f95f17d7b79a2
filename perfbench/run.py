#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch and CUDA port once, and
print its result as the last line of standard output.

  python3 perfbench/run.py --workload resnet18-p16-topk --seed 7 \
      --seconds 10 --trace 0

from the root of a checkout, on a machine with the cards the cell asks
for.  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics (the same window, then the parts of a round timed
alone and rounds under torch.profiler).  Every run checks the window's
program against the plain reference and prints each compared number
beside its limit, last on standard error and last in the result's line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# top-level modules the process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def smi(query: str) -> str:
    """``nvidia-smi``'s reading of ``query`` for the card, one line."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / "perfbench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from perfbench.bench.spec import Spec
    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from perfbench.bench import harness
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), spec=spec)
    found = sorted({m.split(".")[0] for m in list(sys.modules)}
                   & set(FORBIDDEN))
    if found:
        print(f"the process holds {found} after the window: the benchmark "
              f"measures the PyTorch port alone", file=sys.stderr)
        return 3
    line = out["line"]
    line["device"]["power"] = smi("name,power.limit")
    print("seconds from the process's start: " + ", ".join(
        f"{k} {v:.2f}" for k, v in out["marks"].items()), file=sys.stderr)
    print("window rounds (ms, CUDA events between round boundaries): "
          + " ".join(f"{ms:.1f}" for ms in out["round_ms"]), file=sys.stderr)
    for name, ms in out["fire_ms"].items():
        print(f"fires of {name} alone (ms of device time each): "
              + " ".join(f"{x:.3f}" for x in ms), file=sys.stderr)
    print("card after the run (SM clock, its max, power, temperature): "
          + smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu"),
          file=sys.stderr)
    print(f"card {line['device']['power']}; peaks: fp32 67e12 FLOP/s, "
          f"HBM 3.35e12 B/s; left out of the leaf numbers: "
          f"{out['numbers']['left_out']} leaves", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    line["checks"] = out["checks"]
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
