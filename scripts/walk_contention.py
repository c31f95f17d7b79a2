#!/usr/bin/env python3
"""Phases 4, 4b and 7 of ``chip_smoke.py`` without the dry run's walk and
beside it, on one card.

``chip_smoke.py`` runs phase 24b's walk (the dry run of every arch and
shape: host work in background processes at the lowest CPU priority)
beside its timed phases.  This script reads what the walk could move:
phase 4's serving rate and step times and phase 4b's wall and idle share
per decode step (host-bound), phase 4b's device time and phase 7's round
walls (device-bound).  It runs the three phases four times, alone, beside
the walk, beside the walk, alone, and prints each run's readings on one
line and the processes that hold the card.

    python3 scripts/walk_contention.py

from the root of a checkout, on a machine with a card.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

# (phase, the reading's name in its printed line)
READINGS = (("4", "tokens_per_s"), ("4", "decode_ms_median"),
            ("4", "prefill_ms_median"), ("4b", "wall_ms_per_step"),
            ("4b", "device_ms_per_step"), ("4b", "idle_share"))


class _Tee(io.TextIOBase):
    def __init__(self, *outs):
        self.outs = outs

    def write(self, s):
        for o in self.outs:
            o.write(s)
        return len(s)

    def flush(self):
        for o in self.outs:
            o.flush()


def run_phases(torch, np, chip_smoke, label: str) -> dict:
    """Phases 4, 4b and 7 once; their readings and seconds."""
    buf = io.StringIO()
    secs = {}
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        t0 = time.perf_counter()
        cfg, _, params, engine, _ = chip_smoke.phase_serve(torch, np)
        secs["4"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        chip_smoke.phase_profile(torch, np, cfg, params, engine)
        secs["4b"] = time.perf_counter() - t0
        del cfg, params, engine, _
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _, _, walls, _ = chip_smoke.phase_train(torch)
        secs["7"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    lines = buf.getvalue().splitlines()
    rec = {"label": label, "seconds": {k: round(v, 1)
                                       for k, v in secs.items()}}
    for phase, key in READINGS:
        head = f"phase {phase} "
        for ln in lines:
            m = re.search(rf"\b{key}=([0-9.]+)", ln)
            if ln.startswith(head) and m:
                rec[f"{phase}:{key}"] = float(m.group(1))
                break
    rec["7:round_wall_ms"] = [round(w, 3) for w in walls]
    print("READING " + json.dumps(rec), flush=True)
    return rec


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("this script runs on a card")
    import chip_smoke
    from repro_torch.kernels import _build

    print(chip_smoke.smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all(("flash_attention", "flash_decode", "topk_compress"))
    print(f"cores: {os.cpu_count()}", flush=True)
    recs = [run_phases(torch, np, chip_smoke, "alone")]
    with tempfile.TemporaryDirectory() as walk_dir:
        walks, t_walk, _ = chip_smoke.start_dryrun_walk(walk_dir)
        try:
            for _ in range(2):
                recs.append(run_phases(torch, np, chip_smoke,
                                       "beside the walk"))
            apps = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid,used_memory",
                 "--format=csv,noheader"], capture_output=True, text=True)
            done = len([f for f in os.listdir(walk_dir)
                        if f.endswith(".json")])
            print(f"the walk after {time.time() - t_walk:.1f}s: "
                  f"{done} records written; processes on the card: "
                  f"{apps.stdout.strip() or '(none listed)'}", flush=True)
        finally:
            for p in walks:
                chip_smoke.stop_group(p)
    recs.append(run_phases(torch, np, chip_smoke, "alone"))
    print("SUMMARY " + json.dumps(recs), flush=True)


if __name__ == "__main__":
    main()
