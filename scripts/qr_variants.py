#!/usr/bin/env python3
"""The batched-QR kernel on the card: phase 8's QR part alone, the parent's
build beside it, and variants of the source.

Runs ``chip_smoke.py``'s ``phase_qr`` (the kernel against its plain
version, against ``batched_qr_blocked_plain`` with its control, grouped
against single calls, against torch.linalg.qr, and the times of fires
(i)-(v)), then, on one card:

  * with ``--parent DIR`` (an unpacked checkout of an earlier commit, e.g.
    ``git archive HEAD~1 | tar -x -C _archive/parent``): builds that
    checkout's ``csrc/batched_qr.cu`` (the one-stack-a-call interface of
    the first port), holds its Q to this kernel's within QR_TOL, and times
    both in turns (parent, this, this, parent) at (i) the Pipelined
    fire's 10 calls of [16, 1536, 2], each after its own flush, and at
    (ii)-(v), where this source makes one grouped call and the parent one
    call a segment, after one flush; then the peak device memory of
    phase 9's plans B and C under the parent's checkout (its own
    ``chip_smoke.train_rounds`` in a subprocess) and under this one;
  * each variant named on the command line, an edit of this source
    (``VARIANTS`` below), held against the source's Q ("holds" or
    "FAILS") and timed in turns with it: (i)'s single call, the rwkv6
    fire and the [4, 65536, 2] panel.  ``cta_reduce_twice`` and
    ``cluster_reduce_twice`` do every reduction of that scope twice
    (the first's result kept alive and dropped), so that their time
    over the source's, per reduction, is what one reduction costs.

The SASS of the source's build is searched for memory fences (a release
cluster arrive compiles to one).  Run from the root of a checkout on one
card:

  python3 scripts/qr_variants.py [--parent DIR] [--no-phase] [variant ...]

The builds go to src/repro_torch/kernels/build/variants/ (gitignored).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import batched_qr as kqr  # noqa: E402

CSRC = "src/repro_torch/kernels/csrc/batched_qr.cu"
OUT = pathlib.Path(ROOT, "src/repro_torch/kernels/build/variants")
_REDUCE_TAIL = """  scope_sync<SCOPE>();
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k < cnt) v[k] = gather<SCOPE>(slots[buf], k);
  buf ^= 1;
}"""


def _twice(scope: str):
    """An edit that runs every reduction of ``scope`` twice."""
    return [(_REDUCE_TAIL, f"""  scope_sync<SCOPE>();
  if (SCOPE == {scope}) {{
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < cnt) {{
        const float d = gather<SCOPE>(slots[buf], k);
        asm volatile("" :: "f"(d));
      }}
    buf ^= 1;
    if (lane == 0) {{
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (k < cnt) slots[buf][warp][k] = v[k];
    }}
    scope_sync<SCOPE>();
  }}
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k < cnt) v[k] = gather<SCOPE>(slots[buf], k);
  buf ^= 1;
}}""")]


# edits of the source: name -> [(text, its replacement), ...]
VARIANTS = {
    "source": [],
    "cta_reduce_twice": _twice("S_CTA"),
    "cluster_reduce_twice": _twice("S_CLUSTER"),
    # the inverse norm as the plain version's torch.rsqrt forms it on the
    # card (rsqrtf), or as a correctly rounded sqrt and a correctly
    # rounded quotient
    "rsqrtf": [("return n > EPS ? __frsqrt_rn(n) : 0.0f;",
                "return n > EPS ? rsqrtf(n) : 0.0f;")],
    "fdiv_fsqrt": [("return n > EPS ? __frsqrt_rn(n) : 0.0f;",
                    "return n > EPS ? __fdiv_rn(1.0f, __fsqrt_rn(n)) : 0.0f;")],
    # 4-byte loads and stores everywhere: what the 16-byte vectors give
    "scalar_loads": [
        ("const bool vin = (reinterpret_cast<uintptr_t>(x) & 15) == 0;",
         "const bool vin = false;"),
        ("const bool vout = (reinterpret_cast<uintptr_t>(q) & 15) == 0;",
         "const bool vout = false;")],
}


def edited(src: str, edits) -> str:
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


def parent_fn(lib):
    """The parent build (one [batch, a, r] stack a call)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.batched_qr_launch.argtypes = [vp, vp, ci, ci, ci, ci, vp]
    lib.batched_qr_launch.restype = ci

    def run(p):
        q = torch.empty_like(p)
        b, a, r = p.shape
        err = lib.batched_qr_launch(p.data_ptr(), q.data_ptr(), b, a, r,
                                    p.device.index,
                                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent launch refused: cudaError {err}")
        return q
    return run


def in_turns(time_this, time_parent):
    """Readings of this and the parent in turns (parent, this, this,
    parent), each turn's a cs.Ms; returns (this, parent) as cs.Ms."""
    got, sleep = {"this": [], "parent": []}, {}
    for who, fn in (("parent", time_parent), ("this", time_this),
                    ("this", time_this), ("parent", time_parent)):
        ms = fn()
        got[who] += ms.readings
        sleep[who] = ms.sleep
    return (cs.Ms(got["this"], sleep["this"]),
            cs.Ms(got["parent"], sleep["parent"]))


def fire_ms(fn, flush) -> "cs.Ms":
    """A fire after one flush (cs.fire_ms, whose sleep covers the host's
    enqueue of one call a segment), as a cs.Ms of its readings."""
    readings, _ = cs.fire_ms(torch, fn, flush, 5, strict=False)
    return cs.Ms(readings, cs.TOPK_SLEEP_CYCLES)


def compare_parent(parent_dir: str, flush, gen):
    text = pathlib.Path(parent_dir, CSRC).read_text()
    run_parent = parent_fn(_build.build_variants(
        {"parent": text}, OUT, "qr")["parent"])
    fires = [("(i) 10 calls of [16,1536,2]", [(16, 1536, 2)] * 10)]
    fires += cs.qr_fires() + [("(v) [4,65536,2]", [(4, 65536, 2)])]
    for label, shapes in fires:
        ps = [torch.randn(sh, generator=gen, device="cuda") for sh in shapes]
        for p, q in zip(ps, kqr.batched_qr_many(ps)):
            qp = run_parent(p)
            rel = ((q - qp).abs().max() / qp.abs().max()).item()
            if not rel <= cs.QR_TOL:
                cs.fail(f"the parent's build differs at {label}: {rel:.3e}")
        if label.startswith("(i)"):
            # each call after its own flush, as phase 8 reads (i)
            this, parent = in_turns(
                lambda: cs.fire_each_ms(torch, kqr.batched_qr, ps, flush, 5,
                                        cs.LONG_SLEEP_CYCLES),
                lambda: cs.fire_each_ms(torch, run_parent, ps, flush, 5,
                                        cs.LONG_SLEEP_CYCLES))
            how = "each call after its own flush"
        else:
            this, parent = in_turns(
                lambda: fire_ms(lambda: kqr.batched_qr_many(ps), flush),
                lambda: fire_ms(lambda: [run_parent(p) for p in ps], flush))
            how = ("one flush a fire; this one grouped call, the parent one "
                   "call a segment")
        print(f"parent {parent_dir} at {label}: Q within {cs.QR_TOL}; ms in "
              f"turns (parent, this, this, parent; {how}): this="
              f"{cs.fmt_ms(this)} parent={cs.fmt_ms(parent)}", flush=True)
        del ps


_PEAK = """
import gc, json, sys
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from repro_torch.configs.base import HierAvgParams
from repro_torch.core.simulator import Simulator
from repro_torch.core.topology import HierTopology
from repro_torch.optim import sgd
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
out = {}
for spec in sys.argv[1:]:
    loss_fn, init_fn, sample, eval_batch = cs.resnet_task(torch)
    sim = Simulator(loss_fn, init_fn, sample, topo=HierTopology(1, 4, 4),
                    hier=HierAvgParams(plan=spec), optimizer=sgd(0.1),
                    per_learner_batch=32, eval_batch=eval_batch, seed=0,
                    device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = sim.run(cs.TRAIN_ROUNDS)
    torch.cuda.synchronize()
    out[spec] = [torch.cuda.max_memory_allocated() / 2 ** 30,
                 [float(x) for x in res.eval_losses]]
    del sim, res
# the compress step alone, per leaf (plan C) and bucketed (plan B's
# serial layout), on a seeded ResNet-18 tree at 16 learners: bytes above
# what was allocated before it
from repro_torch.comm.bucket import Bucketed
from repro_torch.comm.lowrank import PowerSGDReducer
from repro_torch.configs.resnet18_cifar import CNNConfig
from repro_torch.models.resnet import resnet_init
from repro_torch.tree import tree_map
tmpl = resnet_init(None, CNNConfig(width=64), device="meta")
gen = torch.Generator(device="cuda").manual_seed(7)
tree = tree_map(lambda m: torch.randn((1, 4, 4) + tuple(m.shape),
                                      generator=gen, device="cuda"), tmpl)
for name, red in (("per leaf", PowerSGDReducer(2)),
                  ("bucketed", Bucketed(PowerSGDReducer(2)))):
    state = red.init_state(tree_map(torch.zeros_like, tree))
    red.compress(tree, state)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = red.compress(tree, state)
    torch.cuda.synchronize()
    out["compress " + name] = torch.cuda.max_memory_allocated() - base
    del got, state
print(json.dumps(out))
"""


def peaks(parent_dir: str):
    """Peak device memory and eval losses of phase 9's 3 rounds of plans B
    and C, and the peak of PowerSGD's compress alone, each checkout in a
    process of its own (its own Simulator, QR kernel and compress)."""
    plans = list(cs.CODEC_PLANS[1:])
    got = {}
    for who, cwd in (("parent", parent_dir), ("this", ROOT)):
        run = subprocess.run([sys.executable, "-c", _PEAK, *plans], cwd=cwd,
                             capture_output=True, text=True, timeout=900)
        if run.returncode:
            cs.fail(f"{who}'s training failed:\n{run.stderr[-3000:]}")
        got[who] = json.loads(run.stdout.strip().splitlines()[-1])
    print("peak GiB and eval losses of phase 9's 3 rounds, each checkout in "
          "a process of its own (this / parent): " + "; ".join(
              f"{spec} {got['this'][spec][0]:.6f} / "
              f"{got['parent'][spec][0]:.6f} GiB, eval "
              f"{cs.fmt(got['this'][spec][1])} / "
              f"{cs.fmt(got['parent'][spec][1])}" for spec in plans)
          + "; PowerSGD compress alone, bytes above its inputs (this / "
          "parent): " + "; ".join(
              f"{k} {got['this'][k]} / {got['parent'][k]}"
              for k in ("compress per leaf", "compress bucketed")),
          flush=True)


def variants(names, flush, gen):
    src = pathlib.Path(ROOT, CSRC).read_text()
    libs = _build.build_variants({n: edited(src, VARIANTS[n]) for n in
                                  dict.fromkeys(["source", *names])},
                                 OUT, "qr")
    cases = [("(i) single [16,1536,2]", [(16, 1536, 2)]),
             ("(iv) rwkv6 per leaf", list(cs.RWKV_QR_FIRE)),
             ("(v) [4,65536,2]", [(4, 65536, 2)])]
    data = [(label, [torch.randn(sh, generator=gen, device="cuda")
                     for sh in shapes]) for label, shapes in cases]
    kernel = kqr._lib
    try:
        def use(name):
            kqr._lib = lambda lib=libs[name]: kqr.declare(lib)
        use("source")
        want = [kqr.batched_qr_many(ps) for _, ps in data]
        for name in names:
            line = []
            for (label, ps), ref in zip(data, want):
                use(name)
                held = all(cs.same_bits(torch, a, b) for a, b in
                           zip(kqr.batched_qr_many(ps), ref))
                got = {"source": [], name: []}
                for who in ("source", name, name, "source"):
                    use(who)
                    got[who] += cs.time_ms(
                        torch, lambda: kqr.batched_qr_many(ps), flush, 10,
                        cs.LONG_SLEEP_CYCLES).readings
                v = cs.Ms(got[name], cs.LONG_SLEEP_CYCLES)
                s = cs.Ms(got["source"], cs.LONG_SLEEP_CYCLES)
                line.append(f"{label} {'holds' if held else 'FAILS'} "
                            f"ms {cs.fmt_ms(v)} source {cs.fmt_ms(s)}")
            print(f"variant {name} (in turns with the source): "
                  + "; ".join(line), flush=True)
    finally:
        kqr._lib = kernel
    lib = OUT / "libqr_source.so"
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(lib)], capture_output=True, text=True)
    ops = {}
    for ln in sass.stdout.splitlines():
        if "MEMBAR" in ln or "FENCE" in ln or "UCGABAR" in ln \
                or "CCTL" in ln:
            op = ln.split("*/")[1].split(";")[0].strip() if "*/" in ln \
                else ln.strip()
            ops[op] = ops.get(op, 0) + 1
    print(f"SASS of the source's batched_qr_kernel, fences and cluster "
          f"barriers: {ops}", flush=True)


def trajectories(parent_dir, states=1):
    """Phase 9's plans B and C: 2 rounds from one converted state with the
    plain QR, and with each QR below in its place, a panel stack at a time
    (cs.qr_replaced), each read against the plain run (cs.psgd_readings);
    on the source kernel's run, each QR's largest distance from an fp64 QR
    on the trainer's own panels.  With ``states`` > 1 the same from the
    states that 3 rounds train from seeds 0, 1, ..., and each QR's spread
    of readings over them (how far the trajectory limit's verdict depends
    on the state)."""
    import dataclasses

    from repro_torch.comm import get_reducer
    from repro_torch.configs.base import HierAvgParams
    from repro_torch.convert import train_state_to_numpy
    from repro_torch.core.plan import ReductionPlan
    from repro_torch.kernels import ref as kref
    src = pathlib.Path(ROOT, CSRC).read_text()
    names = ["source", "rsqrtf", "fdiv_fsqrt"]
    libs = _build.build_variants({n: edited(src, VARIANTS[n]) for n in names},
                                 OUT, "qr")

    def variant(name):
        def run(p):
            saved = kqr._lib
            kqr._lib = lambda lib=libs[name]: kqr.declare(lib)
            try:
                return kqr.batched_qr(p)
            finally:
                kqr._lib = saved
        return run

    qrs = {n: variant(n) for n in names}
    if parent_dir:
        qrs["parent"] = parent_fn(_build.build_variants(
            {"parent": pathlib.Path(parent_dir, CSRC).read_text()}, OUT,
            "qr")["parent"])
    qrs["plain"] = kref.batched_qr_plain
    spread = {}
    qrs["fp64"] = lambda p: cs.qr_fp64(torch, p).to(p.dtype)
    qrs["no_projection"] = lambda p: cs.no_projection(torch, p)
    for spec, seed in [(s, k) for s in cs.CODEC_PLANS[1:]
                       for k in range(states)]:
        hier = HierAvgParams(plan=spec)
        sim, res, loss_fn, *_ = cs.train_rounds(
            torch, hier, {"batched_qr": kqr.batched_qr}, require_fall=False,
            seed=seed)
        print(f"{spec} state {seed}: eval_loss {cs.fmt(res.eval_losses)}",
              flush=True)
        np_state = train_state_to_numpy(res.state)
        bgen = torch.Generator(device="cuda").manual_seed(8)
        batches = [sim._round_batch(bgen) for _ in range(2)]
        del sim, res
        plan = ReductionPlan.parse(spec)
        plain = ReductionPlan(tuple(
            dataclasses.replace(lvl, reducer=get_reducer(
                lvl.reducer.describe(), **({} if lvl.reducer.name == "mean"
                                           else {"impl": "plain"})))
            for lvl in plan.levels))
        sp, lp = cs.rounds_from(torch, loss_fn, hier, plain, np_state,
                                batches)
        dist = {n: 0.0 for n in qrs if n != "no_projection"}

        def recording(p):
            q64 = cs.qr_fp64(torch, p)
            for n in dist:
                dist[n] = max(dist[n],
                              (qrs[n](p).double() - q64).abs().max().item())
            return qrs["source"](p)

        line = []
        for name, fn in [("source (recorded)", recording)] + [
                (n, f) for n, f in qrs.items() if n not in ("source",
                                                            "plain")]:
            with cs.qr_replaced(fn):
                sk, lk = cs.rounds_from(torch, loss_fn, hier, plan, np_state,
                                        batches)
            read = cs.psgd_readings(torch, sk, sp, lk, lp)
            line.append(f"{name}: {cs.fmt_read(read)} "
                        f"({'within' if cs.within_psgd_limits(read) else 'OUTSIDE'})")
            spread.setdefault((spec, name), []).append(
                (read["losses"], read["params"]))
            del sk
        print(f"trajectories {spec} state {seed} against the plain QR "
              f"after 2 rounds: " + "; ".join(line) + "; largest max|Q - "
              "Q_fp64| on the source run's panels: " + " ".join(
                  f"{n}={v:.3e}" for n, v in dist.items()), flush=True)
        del sp, np_state, batches
        torch.cuda.empty_cache()
    if states > 1:
        for (spec, name), reads in spread.items():
            lo = [min(r[i] for r in reads) for i in (0, 1)]
            hi = [max(r[i] for r in reads) for i in (0, 1)]
            within = sum(r[0] <= cs.PSGD_LOSS_TOL
                         and r[1] <= cs.PSGD_PARAM_TOL for r in reads)
            print(f"spread over {states} states, {spec}, {name}: losses "
                  f"[{lo[0]:.3e}, {hi[0]:.3e}] params [{lo[1]:.3e}, "
                  f"{hi[1]:.3e}], within the limits on {within} of "
                  f"{states}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--no-phase", action="store_true")
    ap.add_argument("--trajectories", action="store_true")
    ap.add_argument("--states", type=int, default=1,
                    help="with --trajectories: read them from the states "
                         "trained from this many seeds, and their spread")
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("qr_variants: no card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    _build.build_all(["batched_qr"])
    for line in _build.BUILD_LOG.get("batched_qr", (0, ""))[1].splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(21)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    if not args.no_phase:
        cs.phase_qr(torch, lambda *shape: torch.randn(
            shape, generator=gen, device="cuda"), flush)
    if args.trajectories:
        trajectories(args.parent, args.states)
    if args.parent:
        compare_parent(args.parent, flush, gen)
        peaks(args.parent)
    if args.variants:
        variants(args.variants, flush, gen)


if __name__ == "__main__":
    main()
