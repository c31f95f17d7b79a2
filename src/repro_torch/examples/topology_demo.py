"""Topology & communication demo (the port of ``examples/topology_demo.py``):
how each assigned architecture maps onto the production pod, what
Hier-AVG saves versus K-AVG in reduction time, and the per-level
payload/cost table of a 3-level ReductionPlan.  Host arithmetic over the
ported cost model: its tables equal the reference script's line for line.

    PYTHONPATH=src python -m repro_torch.examples.topology_demo [--device cpu]
"""
import argparse

from repro_torch.autotune.calibrate import resolve_comm_model
from repro_torch.comm import DEFAULT_BUCKET_BYTES
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core import HierTopology, ReductionPlan
from repro_torch.core.plan import apply_bucketing
from repro_torch.core.theory import (CommModel, comm_per_k2_steps,
                                     param_template, plan_comm_per_round)
from repro_torch.examples import example_device

PLAN = "local@4:cast:bfloat16/pod@8:mean/global@16:topk:0.05"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    example_device(ap.parse_args(argv).device)
    print(f"{'arch':26s} {'params':>8s} {'layout G.S.F.TP':>16s} "
          f"{'learners/pod':>12s}  hier ms/step  kavg ms/step  saving")
    # $REPRO_CALIBRATION (autotune/calibrate.py) swaps in measured constants
    cal = resolve_comm_model()
    cm = cal or CommModel()
    if cal is not None:
        print(f"[calibrated comm model: fast_bw={cm.fast_bw:.3e} "
              f"slow_bw={cm.slow_bw:.3e} latency={cm.latency:.2e} "
              f"compress_bw={cm.compress_bw:.3e}]")
        if cm.codec_bw:
            print("[per-codec compress_bw: "
                  + " ".join(f"{c}={bw:.3e}" for c, bw in cm.codec_bw) + "]")
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        lay = cfg.layout
        topo = HierTopology(2, lay.groups, lay.local)   # 2-pod view
        mb = cfg.param_count() * 2
        P, S = max(topo.n_learners, 2), max(lay.local, 2)
        loc, glo = comm_per_k2_steps(mb, 4, 8, P, S, cm)
        hier = (loc + glo) / 8 * 1e3
        _, glo_k = comm_per_k2_steps(mb, 4, 4, P, 1, cm)
        kavg = glo_k / 4 * 1e3
        print(f"{arch:26s} {cfg.param_count()/1e9:7.1f}B "
              f"{lay.groups}x{lay.local}x{lay.fsdp}x{lay.tp:>2d}      "
              f"{lay.learners_per_pod:>8d}     {hier:9.2f}    {kavg:9.2f}  "
              f"{1 - hier/kavg:6.1%}")

    print("""
Communicator mapping (DESIGN.md §4):
  local reduction  = mean over the 'local' mesh axis   (intra-pod ICI)
  global reduction = mean over ('pod','group','local') (crosses DCI)
K-AVG at the same effective cadence pays the global (DCI) price every time;
Hier-AVG pays it once per K2 steps and rides ICI in between — the paper's
"trade local reductions for global reductions".""")

    # ------------------------------------------------------------------ #
    # 3-level ReductionPlan: per-level payload / cost table
    # ------------------------------------------------------------------ #

    plan = apply_bucketing(ReductionPlan.parse(PLAN), DEFAULT_BUCKET_BYTES)
    print(f"\n3-level plan {plan.describe()} (2-pod view):\n")
    print(f"{'arch':26s} {'level':7s} {'period':>6s} {'n':>4s} "
          f"{'payload MB':>10s} {'compress':>8s} {'x/round':>7s} "
          f"{'tier':>4s} {'msgs':>5s} {'codec':>6s} {'cdc ms':>7s} "
          f"{'ms/step':>8s} {'piped':>8s} {'overlap':>7s}")
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        lay = cfg.layout
        topo = HierTopology(2, lay.groups, lay.local)
        dense = cfg.param_count() * 4          # fp32 mean baseline
        template = param_template(cfg.param_count(), dtype="float32",
                                  n_leaves=max(1, 8 * cfg.n_layers))
        for lc in plan_comm_per_round(plan, topo, template, cm):
            tier = "dci" if lc.bandwidth == cm.slow_bw else "ici"
            print(f"{arch:26s} {lc.name:7s} {lc.period:>6d} "
                  f"{lc.participants:>4d} {lc.payload_bytes / 2**20:>10.1f} "
                  f"{dense / max(lc.payload_bytes, 1):>7.1f}x "
                  f"{lc.count_per_round:>7d} {tier:>4s} {lc.messages:>5d} "
                  f"{lc.codec or '-':>6s} "
                  f"{lc.compute_s / plan.total_period * 1e3:>7.3f} "
                  f"{lc.seconds_per_round / plan.total_period * 1e3:>8.3f} "
                  f"{lc.overlap_s / plan.total_period * 1e3:>8.3f} "
                  f"{lc.overlap_speedup:>6.2f}x")

    print("""
Each level is costed over its own link tier (local/pod ride ICI, global
crosses DCI) and its own compressed payload (cast halves the words, topk
5% transmits value+index pairs for 5% of coordinates).  'codec'/'cdc ms'
are the level's codec family and its compress+reconstruct compute per
step, priced at CommModel.compress_bw_for(codec) — the per-codec rate
when a calibration artifact fitted one from codec-labeled probe points,
else the shared compress_bw constant.  'piped' is the
wall ms/step of the pipelined bucket schedule (comm/bucket.py Pipelined):
each bucket's collective overlaps the next bucket's compress, so a level
pays max(compute, comm) per stage plus the fill/drain ramp instead of the
sum — 'overlap' is the serial/pipelined wall ratio.  No legacy knob can
express this schedule — it is a ReductionPlan-only experiment.""")


if __name__ == "__main__":
    main()
