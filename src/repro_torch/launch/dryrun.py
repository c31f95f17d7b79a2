"""Meta-device dry run (PyTorch port of ``repro/launch/dryrun.py``):
build every (arch x input shape) case on the reference's meshes from fake
tensors, and record its placements, the peak a rank must hold, its FLOPs,
the collectives of a round and the roofline terms.

Run (the card by default, as every entry point of the port; ``--device
cpu`` on the CPU; the trace itself allocates nothing on either):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
      --out experiments/dryrun

How it differs from the reference's, and why: torch has no compiler to
ask for a program's memory, cost and collectives.

* the peak (``memory.peak_est_bytes``) is the traced maximum of live
  device bytes (:class:`LiveBytes`, a dispatch mode that sums the live
  storages through weakref finalizers) over one SGD step and one fire of
  each plan level (a train case; a round's peak repeats every step), one
  decode step or one prefill, on one rank of the port (``port_rank``),
  its arguments included.  The reference's figure is XLA's arguments +
  temporaries + outputs - aliases on one of its devices.  Where a card
  would launch a kernel, the trace takes the kernel's shape function
  (kernels/shapes.py);
* FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` over the
  same trace plus the attention and WKV kernels' FLOPs from their shape
  functions; bytes are the traced unit's argument and output bytes, a
  lower bound;
* the collectives are those of one round of the port on its mesh of
  ranks, derived from the plan and the bucket layouts
  (``hlo_analysis.round_collectives``).  The reference's tensor-parallel
  activation collectives and FSDP compute gathers have no counterpart
  (``model`` stays 1; each rank computes its learner's whole step):
  ``collectives_not_in_port`` says so, and they are not reported as
  zero;
* ``lower_s`` and ``compile_s`` become ``trace_s``.

Exit status is non-zero if any case fails.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ALL_ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch import hlo_analysis as ha
from repro_torch.launch.analytic import analytic_roofline
from repro_torch.launch.cases import (DryrunCase, build_case, parse_layout,
                                      port_rank_bytes, reference_placement)
from repro_torch.tree import leaves


class LiveBytes(TorchDispatchMode):
    """Live storage bytes and their peak over the operations it sees: each
    tensor an operation returns adds its storage's bytes once, and a
    weakref finalizer takes them off when the storage dies (views share
    their base's storage).  :meth:`track` counts tensors that exist
    before the mode."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    def _add(self, t) -> None:
        if not isinstance(t, torch.Tensor) or t.device.type == "meta":
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        self._held[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def track(self, tree) -> None:
        for x in leaves(tree):
            if isinstance(x, torch.nn.Module):
                for p in x.parameters():
                    self._add(p)
            else:
                self._add(x)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in leaves(out if isinstance(out, (list, tuple)) else [out]):
            self._add(t)
        return out


@contextlib.contextmanager
def fake_world(mesh):
    """A bound mesh's collectives without a world, for the trace: every
    process group the mesh would create stands as a placeholder, and each
    collective allocates its output and is counted
    (``collectives.counts()``) but moves nothing."""
    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import _GROUP_AXIS_SETS, replica_groups
    if mesh is None or not mesh.bound:
        yield
        return
    groups = {}
    for axes in _GROUP_AXIS_SETS:
        if all(a in mesh.shape for a in axes):
            for ranks in replica_groups(mesh, axes):
                groups[tuple(ranks)] = ("fake group", tuple(ranks))
    saved_groups, saved_run = mesh._groups, collectives._run

    def run(kind, fn, out, inp):
        collectives._CALLS[kind] += 1
        return out

    mesh._groups, collectives._run = groups, run
    try:
        yield
    finally:
        mesh._groups, collectives._run = saved_groups, saved_run


def trace_unit(case: DryrunCase) -> Dict:
    """Run the case's unit (``case.port.run``) on its fake arguments
    under :class:`LiveBytes` and ``FlopCounterMode``: the peak of live
    device bytes, the FLOPs, the argument and output bytes, the
    collectives the trace called, and its seconds."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import shapes
    from repro_torch.parallel import collectives
    args = case.port.args
    t0 = time.perf_counter()
    shapes.FLOPS[0] = 0.0
    collectives.reset_counts()
    lb = LiveBytes()
    with case.fake_mode, fake_world(case.port.mesh):
        counter = FlopCounterMode(display=False)
        with lb, counter:
            lb.track(args)
            start = lb.live
            out = case.port.run(*args)
        out_bytes = sum(x.numel() * x.element_size() for x in leaves(out)
                        if isinstance(x, torch.Tensor))
    return {"peak_bytes": lb.peak, "arg_bytes": start,
            "out_bytes": out_bytes,
            "flops": float(counter.get_total_flops()) + shapes.FLOPS[0],
            "traced_collectives": collectives.counts(),
            "trace_s": time.perf_counter() - t0}


def _device_memory() -> Optional[int]:
    """The card's memory (``total_memory``), or None without one."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return None


def applicable_shapes(cfg):
    """All 10 pool archs support all 4 shapes (long_500k via rolling-window
    SWA for full-attention archs, MLA latents for deepseek-v2, native state
    for ssm/hybrid)."""
    return list(INPUT_SHAPES)


def run_case(arch: str, shape: str, multi_pod: bool, *, case_kwargs=None,
             layout=None, calibration=None) -> dict:
    case_kwargs = case_kwargs or {}
    cfg = get_config(arch)
    if layout is not None:
        import dataclasses as _dc
        cfg = _dc.replace(cfg, layout=layout)
    t0 = time.perf_counter()
    case = build_case(cfg, shape, multi_pod=multi_pod, **case_kwargs)
    build_s = time.perf_counter() - t0
    tr = trace_unit(case)
    kind = INPUT_SHAPES[shape].kind
    port = case.port
    ops = []
    per_fire = None
    micro_scale = 1.0
    if kind == "train":
        ops = ha.round_collectives(port.plan, port.args[0].params,
                                   port.mesh or _unbound(),
                                   steps=port.hier.steps_per_round)
        per_fire = ha.collective_counts(_one_fire_each(port))
        micro_scale = cfg.layout.microbatch / port.traced_microbatches
    # the unit's FLOPs: a train unit runs one step (of its traced
    # microbatches) and one fire a level
    step_flops = tr["flops"] * micro_scale
    tokens = _tokens_per_rank(cfg, INPUT_SHAPES[shape], case)
    mult = 6.0 if kind == "train" else 2.0
    model_flops = mult * cfg.active_param_count() * tokens * case.steps
    cost = {"flops": step_flops * case.steps,
            "bytes accessed": float(tr["arg_bytes"] + tr["out_bytes"])
            * case.steps}
    terms = ha.roofline_terms(cost, ops, model_flops_per_device=model_flops,
                              steps=case.steps)
    ref = reference_placement(case)
    mine = port_rank_bytes(case)
    total = _device_memory()
    rec = {
        "arch": arch, "shape": shape,
        "mesh": "2pod-512" if multi_pod else "1pod-256",
        "chips": case.mesh.size,
        "notes": case.notes,
        "trace_s": round(build_s + tr["trace_s"], 1),
        "memory": {
            "argument_bytes": tr["arg_bytes"],
            "output_bytes": tr["out_bytes"],
            "peak_est_bytes": tr["peak_bytes"],
            "basis": "traced maximum of live device bytes on one rank of "
                     "the port (one SGD step and one fire per level, a "
                     "decode step or a prefill), arguments included",
            "trace": port.trace_note or None,
            "card_total_bytes": total,
            "fits_one_h100": (None if total is None
                              else tr["peak_bytes"] <= total),
        },
        "reference_placement": ref,
        "port_rank": mine,
        "collectives": ha.collective_summary(ops),
        "collectives_not_in_port": (
            "the reference's tensor-parallel activation collectives and "
            "FSDP compute gathers: model stays 1 and each rank computes "
            "its learner's whole step" if kind == "train" else
            "the reference's tensor- and data-parallel collectives: a "
            "serving case runs in one process on one card"),
        "traced_collectives": tr["traced_collectives"],
        "derived_collectives_one_fire_each": per_fire,
        "roofline_per_step": dict(terms, bytes_basis="the traced unit's "
                                  "argument and output bytes: a lower "
                                  "bound"),
        "roofline": analytic_roofline(
            cfg, shape, multi_pod=multi_pod,
            hier=case_kwargs.get("hier"),
            comm_model=calibration).as_dict(),
    }
    return rec


def _unbound():
    from repro_torch.parallel.sharding import RankMesh
    return RankMesh((1, 1, 1, 1, 1), ("pod", "group", "local", "fsdp",
                                      "model"))


def _one_fire_each(port):
    """The collectives of the traced unit: one fire of each level."""
    import dataclasses
    from types import SimpleNamespace
    out = []
    for lvl in port.plan.levels:
        one = SimpleNamespace(levels=[dataclasses.replace(lvl, period=1)])
        out += ha.round_collectives(one, port.args[0].params,
                                    port.mesh or _unbound(), steps=1)
    return out


def _tokens_per_rank(cfg, shape, case) -> float:
    """Tokens one rank of the port processes per step: a learner's batch
    (its fsdp ranks each compute it whole), or the serving batch."""
    if shape.kind == "decode":
        return shape.global_batch
    if shape.kind == "prefill":
        return shape.global_batch * shape.seq_len
    block = case.port.block
    per_learner = shape.global_batch // _learners(case)
    return per_learner * shape.seq_len * block.n_learners


def _learners(case) -> int:
    lay = case.cfg.layout
    pods = case.mesh.shape.get("pod", 1)
    return pods * lay.groups * lay.local


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--layout", default=None,
                    help="override layout 'GxSxFxTP[:micro]' (hillclimb)")
    ap.add_argument("--k1", type=int, default=None)
    ap.add_argument("--k2", type=int, default=None)
    ap.add_argument("--plan", default=None,
                    help="N-level reduction plan spec (wins over "
                         "--k1/--k2), e.g. "
                         "'local@4:cast:bfloat16/pod@8/global@16:topk:0.05'")
    ap.add_argument("--no-overlap", action="store_true",
                    help="pin the serial bucket schedule (default: the "
                         "pipelined engine)")
    ap.add_argument("--autotune", default=None, metavar="CALIB_JSON",
                    help="calibration artifact (autotune/calibrate.py): "
                         "trace the plan the cost-aware search recommends "
                         "for each arch instead of --plan/--k1/--k2")
    ap.add_argument("--device", default="cuda",
                    help="where the run starts (default cuda; cpu runs "
                         "without a card); the trace allocates nothing")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("launch.dryrun runs on the card by default, and "
                         "CUDA is not available: pass --device cpu")

    cases = []
    archs = ALL_ARCHS if (args.all or not args.arch) else [args.arch]
    for a in archs:
        shapes = applicable_shapes(get_config(a)) \
            if (args.all or not args.shape) else [args.shape]
        for s in shapes:
            meshes = [False, True] if args.both_meshes else [args.multi_pod]
            for mp in meshes:
                cases.append((a, s, mp))

    os.makedirs(args.out, exist_ok=True)
    autotune_cal = None
    autotune_memo = {}
    if args.autotune:
        from repro_torch.autotune import Calibration
        autotune_cal = Calibration.load(args.autotune)
    failures = 0
    for a, s, mp in cases:
        tag = f"{a}__{s}__{'2pod' if mp else '1pod'}"
        lay = parse_layout(args.layout) if args.layout else None
        if lay is not None:
            tag += f"__L{args.layout.replace(':', 'm')}"
        kw = {}
        from repro_torch.configs.base import HierAvgParams
        if args.autotune:
            from repro_torch.autotune import recommend_plan
            from repro_torch.core.theory import param_template
            from repro_torch.core.topology import HierTopology
            cfg = get_config(a)
            layc = lay or cfg.layout
            key = (a, args.layout, mp)
            best = autotune_memo.get(key)
            if best is None:
                best = recommend_plan(
                    HierTopology(pods=2 if mp else 1, groups=layc.groups,
                                 local=layc.local),
                    autotune_cal,
                    template=param_template(
                        cfg.param_count(),
                        n_leaves=max(1, 8 * cfg.n_layers)),
                    overlap=not args.no_overlap)
                autotune_memo[key] = best
                print(f"autotune {a}: {best.spec} "
                      f"(comm_ms/step={best.comm_s_per_step * 1e3:.3f}, "
                      f"feasible={best.feasible})", flush=True)
            kw["hier"] = HierAvgParams(plan=best.spec,
                                       overlap=not args.no_overlap)
            tag += "__AUTO"
        elif args.plan:
            kw["hier"] = HierAvgParams(plan=args.plan,
                                       overlap=not args.no_overlap)
            tag += "__P" + args.plan.replace("/", "-").replace(":", "_")
        elif args.k1 or args.k2 or args.no_overlap:
            hp = HierAvgParams(k1=args.k1 or 4, k2=args.k2 or 8,
                               overlap=not args.no_overlap)
            kw["hier"] = hp
            tag += f"__K{hp.k1}-{hp.k2}"
        try:
            rec = run_case(a, s, mp, layout=lay, case_kwargs=kw,
                           calibration=autotune_cal)
            path = os.path.join(args.out, tag + ".json")
            with open(path, "w") as f:
                json.dump(rec, f, indent=2)
            r = rec["roofline"]
            fits = rec["memory"]["fits_one_h100"]
            print(f"OK   {tag:58s} trace={rec['trace_s']:6.1f}s "
                  f"bottleneck={r['bottleneck']:10s} "
                  f"c/m/coll(ms)={1e3*r['compute_s']:.2f}/"
                  f"{1e3*r['memory_s']:.2f}/{1e3*r['collective_s']:.2f} "
                  f"peakGiB={rec['memory']['peak_est_bytes']/2**30:.2f} "
                  f"fits1={'n/a' if fits is None else fits} "
                  f"colls={ {k: v['count'] for k, v in rec['collectives'].items()} }",
                  flush=True)
        except Exception as e:  # noqa: BLE001
            failures += 1
            print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} dry-run case(s) failed")


if __name__ == "__main__":
    main()
