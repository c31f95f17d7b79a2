#!/usr/bin/env python3
"""Phase 21's fit gate twice on one card: once as ``chip_smoke.py`` runs
it, once beside CPU-burning processes that stand in for a slow host.

The gate (``chip_smoke.autotune_gate``) fits the probe's device times
(CUDA events behind a device sleep), so that a host that cannot keep up
with the eager reductions moves the host walls and not the gate.  Both
runs must pass it, and both controls must miss it in both.  The burners
are this script's own processes (a busy loop each); nothing of the
machine's settings changes.

    python3 scripts/autotune_gate_witness.py [--burners 8]

from the root of a checkout, on a machine with a card.  Prints each
run's gate line and the host walls beside the device times of the
fire-size points; exits non-zero if either run fails the gate.
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def _burn() -> None:
    x = 0
    while True:
        x = (x * 1103515245 + 12345) & 0xFFFFFFFF


def gate_run(torch, chip_smoke, label: str) -> dict:
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        _, _, _, fire_rel = chip_smoke.autotune_gate(torch, out_dir,
                                                     label=label)
        secs = time.perf_counter() - t0
    print(f"{label}: gate passed in {secs:.1f}s: "
          f"{ {k: round(v, 4) for k, v in fire_rel.items()} }", flush=True)
    return fire_rel


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--burners", type=int, default=8)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("this witness runs on a card")
    import chip_smoke
    from repro_torch.kernels import _build

    print(chip_smoke.smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(("topk_compress", "qint8_pack", "batched_qr"))
    gate_run(torch, chip_smoke, "plain host")
    ctx = multiprocessing.get_context("spawn")
    burners = [ctx.Process(target=_burn, daemon=True)
               for _ in range(args.burners)]
    for p in burners:
        p.start()
    try:
        gate_run(torch, chip_smoke, f"beside {args.burners} CPU burners")
    finally:
        for p in burners:
            p.terminate()
        for p in burners:
            p.join()


if __name__ == "__main__":
    main()
