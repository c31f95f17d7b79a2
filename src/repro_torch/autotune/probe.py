"""On-device measurement harness for comm-model calibration (PyTorch port
of ``repro/autotune/probe.py``).

Times REAL grouped reductions — compress + grouped mean + finalize, the
reduction ``repro_torch.testing.build_ab_reduction`` builds for the
bucket-engine tests — per plan level, payload size, reducer codec and
bucket count.  The samples feed ``autotune/calibrate.py``'s
least-squares fit of :class:`repro_torch.core.theory.CommModel`.  The
points, the grid and the sample record are the reference's; a point
whose reducer has a kernel launches that kernel on the card (top-k,
qint8 pack/unpack, the PowerSGD QR).

How the harness differs from the reference's, and why:

* every point of one device runs in THIS process.  The reference starts
  a fresh subprocess per point because XLA:CPU's compile state leaks
  from one point into the next and its 8-device count must be forced
  before JAX initializes; torch has neither (an eager reduction compiles
  nothing, and a kernel's build is cached by its source hash), so one
  process measures them all;
* ``compile_s`` holds the first call's seconds (any kernel build
  included), and each of the ``reps`` executions is timed on the host
  clock across a ``torch.cuda.synchronize()``;
* with a bound ``mesh`` the point runs on the ranks of a
  ``torch.distributed`` world (gloo on the CPU, or ranks sharing one
  card): every execution starts on a barrier, and its time is the
  largest over the ranks;
* probes pin the SERIAL bucket schedule, as the reference's do, and the
  fit consumes ``min_us``; ``warm_us`` (median) is kept for diagnostics;
* on the card, in one process, each point also carries its device time
  (``device_min_us``, ``device_warm_us``): each execution timed again by
  CUDA events, enqueued behind a device sleep long enough that the whole
  reduction is queued before the card reaches it, so that the reading
  holds no host time (a point whose enqueue outlasts the sleep is read
  again behind a longer one).  The host-wall fields keep the reference's
  meaning; a fit that must not see the host reads the device fields
  (``fit_comm_model(time_field="device_min_us")``).

The ``tier`` of a sample is the reference's label (``tier_for``): "dci"
for a global level over several pods.  In one process, or on ranks that
share one card, no sample crosses a slower link than another: a "dci"
sample there measures the same device as an "ici" one, and a fit that
reads ``slow_bw`` from it invents a tier.  Fit such samples' ``ici``
subset, and read ``Calibration.fitted`` for what the fit identified.

Standalone (the card by default; ``--device cpu`` on the CPU):

    PYTHONPATH=src python -m repro_torch.autotune.probe --out probe.json \\
        [--smoke] [--reps N] [--device cpu]
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

PROBE_CAP_LARGE = 4 << 20     # one bucket: isolates the wire-bytes term
PROBE_CAP_SMALL = 32 << 10    # many buckets: exposes per-message latency


@dataclass(frozen=True)
class ProbePoint:
    """One measured configuration: a ``level`` reduction on ``topo``
    with ``n_leaves`` leaves of ``leaf_shape`` fp32, reducer ``spec``,
    bucket cap ``cap`` (serial schedule)."""

    level: str = "global"
    topo: Tuple[int, int, int] = (1, 2, 4)
    spec: str = "mean"
    n_leaves: int = 8
    leaf_shape: Tuple[int, int] = (64, 64)
    cap: int = PROBE_CAP_LARGE

    def describe(self) -> str:
        p, g, s = self.topo
        return (f"{self.level}@{p}x{g}x{s}:{self.spec}:"
                f"{self.n_leaves}x{self.leaf_shape[0]}x"
                f"{self.leaf_shape[1]}:cap{self.cap}")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "ProbePoint":
        d = json.loads(s)
        d["topo"] = tuple(d["topo"])
        d["leaf_shape"] = tuple(d["leaf_shape"])
        return cls(**d)


def default_grid(smoke: bool = False) -> List[ProbePoint]:
    """The reference's probe grid.  Designed so every CommModel parameter
    is identifiable: two payload sizes per tier (bandwidth slope vs
    intercept), a multi-bucket point (per-message latency), mean vs
    codec reducers at matched payloads (compress_bw), and a 2-pod
    topology whose global level classifies as DCI
    (``CommModel.bw_for_level``).  The smoke grid keeps one point per
    identifiable parameter."""
    ici = (1, 2, 4)     # 8 learners, one pod: every level rides ICI
    dci = (2, 2, 2)     # 8 learners, two pods: global crosses DCI
    pts = [
        # ICI bandwidth: two sizes, one bucket each
        ProbePoint("global", ici, "mean", 8, (64, 64)),
        ProbePoint("global", ici, "mean", 8, (160, 160)),
        # per-message latency: same bytes, many buckets
        ProbePoint("global", ici, "mean", 8, (64, 64), PROBE_CAP_SMALL),
        # codec compute: matched sizes, compressing reducers
        ProbePoint("global", ici, "topk:0.05", 8, (160, 160)),
        # DCI tier: 2-pod global, two sizes
        ProbePoint("global", dci, "mean", 8, (64, 64)),
        ProbePoint("global", dci, "mean", 8, (160, 160)),
    ]
    if smoke:
        return pts
    pts += [
        # more sizes per tier for a better-conditioned slope
        ProbePoint("global", ici, "mean", 8, (96, 96)),
        ProbePoint("global", dci, "mean", 8, (96, 96)),
        # sub-global scopes (fewer participants at the same tier)
        ProbePoint("local", ici, "mean", 8, (96, 96)),
        ProbePoint("pod", ici, "mean", 8, (96, 96)),
        ProbePoint("pod", dci, "mean", 8, (96, 96)),
        # codec variety: cast halves the payload, topk ~10x
        ProbePoint("global", ici, "cast:bfloat16", 8, (160, 160)),
        ProbePoint("global", ici, "topk:0.05", 8, (64, 64)),
        ProbePoint("global", dci, "topk:0.05", 8, (96, 96)),
        # per-codec compute rates at the matched 160x160 payload
        ProbePoint("global", ici, "qint8:128", 8, (160, 160)),
        ProbePoint("global", ici, "powersgd:2", 8, (160, 160)),
        # a second multi-bucket latency point
        ProbePoint("global", dci, "mean", 8, (64, 64), PROBE_CAP_SMALL),
    ]
    return pts


def _device(device):
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the probe runs on the card by default, and CUDA "
                           "is not available: pass device='cpu' "
                           "(--device cpu) to probe the CPU")
    return dev


def measure_point(point: ProbePoint, reps: int = 12, *, device="cuda",
                  mesh=None) -> Dict:
    """Measure one probe point in this process on ``device`` (the card by
    default): build the A/B reduction on the serial schedule, run it once
    (``compile_s``), then ``reps`` times, each across a synchronize.  On
    a bound ``mesh`` (this rank's block of a world) every execution
    starts on a barrier and is timed as the largest over the ranks."""
    import numpy as np
    import torch

    from repro_torch.core.plan import LEVEL_AXES
    from repro_torch.core.theory import tier_for
    from repro_torch.parallel import collectives
    from repro_torch.testing import ab_tree, build_ab_reduction

    dev = _device(device)
    b = build_ab_reduction("serial", point.cap, mesh=mesh, spec=point.spec,
                           topo_shape=tuple(point.topo), level=point.level,
                           tree1=ab_tree(0, point.n_leaves,
                                         tuple(point.leaf_shape)),
                           device=dev)
    params, state, fn = b["params"], b["state"], b["fn"]
    on_ranks = mesh is not None and mesh.bound

    def run() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if on_ranks:
            collectives.barrier()
        t0 = time.perf_counter()
        fn(params, state)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter() - t0
        if on_ranks:
            t = collectives.world_max(t, dev)
        return t

    compile_s = run()
    per_exec = [run() for _ in range(reps)]
    device = None
    if dev.type == "cuda" and not on_ranks:
        device = [_device_seconds(torch, fn, params, state, dev,
                                  max(per_exec)) for _ in range(reps)]

    red, tree1 = b["reducer"], b["tree1"]
    pods = point.topo[0]
    n = 1
    for a in LEVEL_AXES[point.level]:
        n *= point.topo[a]
    dense = int(sum(x.numel() * x.element_size() for x in tree1.values()))
    rec = dataclasses.asdict(point)
    rec.update({
        "n": n,
        # the same classifier CommModel.bw_for_level bills with (a label:
        # see the module docstring)
        "tier": tier_for(LEVEL_AXES[point.level], pods),
        "dense_bytes": dense,
        "payload_bytes": int(red.payload_bytes(tree1)),
        # per-device bytes on the wire: differs from payload_bytes only
        # for fsdp-sharded layouts
        "wire_bytes": int(red.wire_payload_bytes(tree1)),
        "messages": int(red.n_messages(tree1)),
        "has_codec": bool(getattr(red, "has_codec", True)),
        # codec family label ("" for the identity mean): calibrate.py fits
        # a compress_bw column per label
        "codec": str(getattr(red, "codec_name", "")),
        "reps": reps,
        "compile_s": round(compile_s, 3),
        "warm_us": round(float(np.median(per_exec)) * 1e6, 1),
        "min_us": round(min(per_exec) * 1e6, 1),
    })
    if device is not None:
        rec["device_warm_us"] = round(float(np.median(device)) * 1e6, 1)
        rec["device_min_us"] = round(min(device) * 1e6, 1)
    return rec


# the card's clock, rounded up (an H100 SXM boosts to 1.98 GHz): sleep
# cycles per second of host enqueue time to cover
_SLEEP_HZ = 2.0e9


def _device_seconds(torch, fn, params, state, dev, host_s: float,
                    tries: int = 6) -> float:
    """One execution of ``fn`` timed by CUDA events on ``dev``'s stream,
    behind a device sleep: if the sleep is still running when the host
    has enqueued the whole reduction, the events bracket device work
    alone.  Otherwise the sleep is doubled and the execution read again;
    a reduction that never queues (one that waits on the device from the
    host) raises."""
    cycles = int(2.0 * host_s * _SLEEP_HZ) + 1_000_000
    for _ in range(tries):
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn(params, state)
        end.record()
        queued = not start.query()
        torch.cuda.synchronize(dev)
        if queued:
            return start.elapsed_time(end) * 1e-3
        cycles *= 2
    raise RuntimeError(f"the reduction was not queued behind a sleep of "
                       f"{cycles // 2} cycles: it waits on the device from "
                       f"the host, so its device time cannot be read")


def run_probe(points: Optional[Sequence[ProbePoint]] = None, *,
              reps: int = 12, out: Optional[str] = None,
              smoke: bool = False, device="cuda", mesh=None) -> List[Dict]:
    """Measure every point in this process (see the module docstring) on
    ``device`` (the card by default), and optionally write the samples to
    ``out`` as the probe artifact ``autotune/calibrate.py`` consumes."""
    points = list(points) if points is not None else default_grid(smoke)
    dev = _device(device)
    samples = [measure_point(pt, reps, device=dev, mesh=mesh)
               for pt in points]
    if out and (mesh is None or not mesh.bound or mesh.rank == 0):
        with open(out, "w") as f:
            json.dump({"meta": {"reps": reps, "smoke": smoke,
                                "n_points": len(samples),
                                "time_field": "min_us"},
                       "samples": samples}, f, indent=2)
    return samples


def load_samples(path: str) -> List[Dict]:
    with open(path) as f:
        d = json.load(f)
    return d["samples"] if isinstance(d, dict) else d


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=12)
    ap.add_argument("--smoke", action="store_true",
                    help="few probe points (the CI grid)")
    ap.add_argument("--out", default="probe.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu probes the CPU)")
    args = ap.parse_args(argv)
    samples = run_probe(reps=args.reps, out=args.out, smoke=args.smoke,
                        device=args.device)
    for s in samples:
        print(f"{s['level']}@{s['tier']} {s['spec']:14s} "
              f"payload={s['payload_bytes']:>8d}B msgs={s['messages']:>2d} "
              f"min={s['min_us']:>9.1f}us warm={s['warm_us']:>9.1f}us "
              f"compile={s['compile_s']:.2f}s")
    print(f"# wrote {args.out} ({len(samples)} samples)", file=sys.stderr)


if __name__ == "__main__":
    main()
