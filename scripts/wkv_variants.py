#!/usr/bin/env python3
"""The WKV6 kernels on the card: phase 10 alone, the parent's build beside
them, and variants of the source.

Runs ``chip_smoke.py`` phase 10 alone (the WKV6 kernels against their
plain versions and their emulations in ``kernels/ref.py``, controls, rerun
bits, times against the bound), then, at the training case of phase 10
(B 8, S 512, H 32, D 64, fp32, L2 flushed before each call):

  * a study of phase 10's forward timing (``timing_study``): its
    lead-in repeated, then ten readings as ``time_ms`` takes them, each
    split into the kernel, the host's lateness and the garbage
    collections inside it;
  * with ``--parent DIR`` (an unpacked checkout of an earlier commit,
    e.g. ``git archive HEAD~1 | tar -x -C _archive/parent``), builds that
    checkout's ``csrc/rwkv6_wkv.cu`` beside this one; holds this
    forward's final state and checkpoints against the parent's bit for
    bit, its y within phase 10's limit of the plain version, at fp32 (the
    training case) and bf16 (S 192), and this backward's gradients within
    phase 10's limit of the parent's; then times the two forwards and the
    two backwards in turns (parent, this, this, parent; 10 calls each).
    A parent whose backward takes a per-CTA scratch (the first port's)
    gets one;
  * times this forward against its number of CTAs (B*H = 132, 264, 396,
    528 at H 4): one CTA an SM, two, and two waves;
  * for each variant of the source named on the command line as
    ``fwd:NAME`` or ``bwd:NAME`` (edits of its text, ``FWD_VARIANTS`` and
    ``BWD_VARIANTS`` below), holds and times that kernel: a forward's
    state and checkpoints bit for bit against this build and its y within
    phase 10's limit of the plain version (fp32, bf16, D 32); a
    backward's gradients within phase 10's limit of the plain version.

Every time is printed as its readings, with their mean and median.  Run
from the root of a checkout on one card:

  python3 scripts/wkv_variants.py [--parent DIR] [fwd:NAME|bwd:NAME ...]

The builds go to src/repro_torch/kernels/build/variants/ (gitignored).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import gc
import os
import pathlib
import re
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import rwkv6_wkv as wkm  # noqa: E402

CSRC = "src/repro_torch/kernels/csrc/rwkv6_wkv.cu"
OUT = pathlib.Path(ROOT, "src/repro_torch/kernels/build/variants")
FLUSH_BYTES = 256 * 2 ** 20       # phase 10's flush buffer
SLEEP_CYCLES = 100_000            # time_ms's sleep before the start event


def _const(name: str, value: int) -> tuple:
    """An edit of one of the forward's constants."""
    return (f"constexpr int {name} = ", f"constexpr int {name} = {value}; //")


def _fwd_ctas(n: int) -> tuple:
    """The forward's CTAs per SM that its registers must allow."""
    return ("__launch_bounds__(fwd_threads(D), 2)",
            f"__launch_bounds__(fwd_threads(D){', ' + str(n) if n else ''})")


# edits of the source: name -> [(text, its replacement), ...].  The
# "skip_*" variants leave out one part of the work and give wrong outputs:
# they are timed to see what that part costs, not held (the compiler also
# drops what only fed the part left out; a forward's states stay right).
FWD_VARIANTS = {
    "source": [],
    "tile_4x4": [_const("FWD_TR", 4)],
    "tile_4x8": [_const("FWD_TR", 4), _const("FWD_TC", 8)],
    "one_cta_per_sm": [_fwd_ctas(1)],
    "three_ctas_per_sm": [_fwd_ctas(3)],
    "stage_8": [_const("FWD_STAGE", 8)],
    "stage_32": [_const("FWD_STAGE", 32)],
    "ring_4": [_const("FWD_RING", 4)],
    # each stage copied and waited for at its own start: no copy in flight
    # while a stage runs
    "sync_copies": [
        ("  for (int n = 0; n < RING - 2; ++n) stage_in(n);\n", ""),
        ("    cp_async_wait<RING - 3>();",
         "    stage_in(n);\n    cp_async_wait<0>();"),
        ("    stage_in(n + RING - 2);\n", "")],
    "skip_y_rows": [("for (int e = 0; e < TC; ++e) part[e] = fmaf(",
                     "for (int e = 0; e < TC * 0; ++e) part[e] = fmaf(")],
    "skip_partials": [("      st_f<TC>(yp + m * RG * D, part);",
                       "      if (n < 0) st_f<TC>(yp + m * RG * D, part);")],
    "skip_combine": [("    if (n > 0) combine(n - 1);", "")],
    "skip_kv": [("fmaf(ww[p], st[p][e], kk[p] * vv[e])",
                 "fmaf(ww[p], st[p][e], kk[p])")],
}
BWD_VARIANTS = {
    "source": [],
    "four_ctas_per_sm": [("__launch_bounds__(BWD_THREADS, 3)",
                          "__launch_bounds__(BWD_THREADS, 4)")],
    "no_min_ctas": [("__launch_bounds__(BWD_THREADS, 3)",
                     "__launch_bounds__(BWD_THREADS)")],
    "skip_interleaved_walk": [("} else if (walking) {",
                               "} else if (walking && n < 0) {")],
    "skip_fetch_loads": [("    if (sm < n) {\n      const size_t off",
                          "    if (sm < n && n < 0) {\n      const size_t off")],
    "skip_dy_reads": [("        load_n<float, CPT>(dy_s + m * D + col, dx);",
                       "        load_n<float, CPT>(v_s + m * D + col, dx);")],
    "skip_dv_butterfly": [("        xreduce<CPT, 16, 16>(dvp, lane);\n", "")],
    "skip_row_butterfly": [
        ("      xreduce<3 * RPT * BWD_SUB, BWD_TPR / 2, 1>(part, lane);\n", "")],
}
TABLES = {"fwd": FWD_VARIANTS, "bwd": BWD_VARIANTS}


def edited(src: str, edits) -> str:
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


def stats(ms) -> str:
    return (f"mean {statistics.fmean(ms):.4f} median "
            f"{statistics.median(ms):.4f} {cs.fmt(ms)}")


def readings(fn, flush, n=10):
    """n single-call readings, as phase 10 times the WKV kernels."""
    return [cs.time_ms(torch, fn, flush, 1) for _ in range(n)]


def in_turns(what: str, parent, this, flush) -> None:
    reads = {"parent": [], "this": []}
    for name in ("parent", "this", "this", "parent"):
        reads[name] += readings(parent if name == "parent" else this, flush)
    print(f"{what} (parent, this, this, parent; 10 calls each): parent "
          f"{stats(reads['parent'])}; this {stats(reads['this'])}",
          flush=True)


def ptxas(log: str, who: str) -> None:
    """Print each kernel's registers and spills from nvcc's log."""
    name = ""
    for line in log.splitlines():
        m = re.search(r"entry function '\w*?(wkv6_\w+?_kernel)I(\w+?)"
                      r"Li(\d+)E", line)
        if m:
            kind = "f32" if m.group(2) == "f" else "bf16"
            name = f"{m.group(1)} {kind} D{m.group(3)}"
        elif "registers" in line or "spill stores" in line:
            print(f"ptxas {who} {name}: {line.split(':', 1)[-1].strip()}",
                  flush=True)


def raw_forward(lib):
    """A build's forward, called through its C entry point, as a function
    of phase 10's inputs."""
    lib = wkm.declare(lib)

    def run(r, k, v, w, u, s0):
        b, s, h, d = r.shape
        out = (torch.empty_like(r),
               torch.empty((b, h, d, d), device="cuda"),
               torch.empty((b, h, -(-s // kref.WKV_CHUNK), d, d),
                           device="cuda"))
        err = lib.wkv6_forward_launch(
            *(x.data_ptr() for x in (r, k, v, w, u, s0, *out)),
            0 if r.dtype == torch.float32 else 1, b, s, h, d,
            r.device.index, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"forward refused: cudaError {err}")
        return out
    return run


def raw_backward(lib, scratch: bool):
    """A build's backward as a function of phase 10's inputs (``scratch``:
    the first port's, which takes a per-CTA scratch)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_backward_launch.argtypes = ([vp] * (15 if scratch else 14)
                                         + [ci] * 6 + [vp])
    lib.wkv6_backward_launch.restype = ci

    def run(r, k, v, w, u, ckpt, dy, dsT):
        b, s, h, d = r.shape
        grads = [torch.empty_like(r) for _ in range(4)]
        du = torch.empty((b, h, d), device="cuda")
        ds0 = torch.empty((b, h, d, d), device="cuda")
        extra = [torch.empty((b * h, kref.WKV_CHUNK, d, d),
                             device="cuda").data_ptr()] if scratch else []
        err = lib.wkv6_backward_launch(
            *(x.data_ptr() for x in (r, k, v, w, u, ckpt, dy, dsT)),
            *(g.data_ptr() for g in grads), du.data_ptr(), ds0.data_ptr(),
            *extra, 0 if r.dtype == torch.float32 else 1, b, s, h, d,
            r.device.index, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"backward refused: cudaError {err}")
        return (*grads, du, ds0)
    return run


def states_held(ours, theirs, want_y, label: str) -> float:
    """sT and the checkpoints bit for bit against ``theirs``, y within
    phase 10's limit of ``want_y``; returns y's measure."""
    torch.cuda.synchronize()
    if not all(cs.same_bits(torch, a, b) for a, b in zip(ours[1:],
                                                           theirs[1:])):
        cs.fail(f"{label}: the final state or a checkpoint differs")
    return cs.hold(torch, f"{label} y", ours[0], want_y)[1]


def timing_study() -> None:
    """Phase 10's forward readings taken apart.  Each run repeats phase
    10's lead-in (the rerun check: forward, backward, forward, backward,
    outputs compared; then a freshly allocated flush buffer) and takes ten
    readings as time_ms does, at its sleep and at phase 10's longer one
    for the forward.  Per reading: the window
    (start to end event); for the C entry point, the kernel alone (events
    around its launch, which a late host does not stretch) and the host's
    lateness (start event to the launch's); the host's time from the
    flush's launch to the forward's return; the card's time for the flush
    and the sleep (the host's slack); the Python garbage collections in
    the reading, with their generation and length."""
    collections = []

    def on_gc(phase, info):
        collections.append((phase, info["generation"], time.perf_counter()))

    r, k, v, w, u, s0, dy, dsT = cs.wkv_inputs(torch, 8, 512, 32, 64,
                                               torch.float32, seed=40)
    x = (r, k, v, w, u, s0)
    lib = wkm._lib()

    def entry(marks):
        out = (torch.empty_like(r), torch.empty_like(s0),
               torch.empty((8, 32, 8, 64, 64), device="cuda"))
        if marks:
            marks[0].record()
        lib.wkv6_forward_launch(
            *(t.data_ptr() for t in (*x, *out)), 0, 8, 512, 32, 64,
            r.device.index, torch.cuda.current_stream().cuda_stream)
        if marks:
            marks[1].record()

    gc.callbacks.append(on_gc)
    try:
        for run, sleep in (("C entry point", SLEEP_CYCLES),
                           ("wrapper", SLEEP_CYCLES),
                           ("wrapper", cs.WKV_FWD_SLEEP_CYCLES)) * 2:
            ys = [wkm.rwkv6_wkv_forward(*x) for _ in range(2)]
            gs = [wkm.rwkv6_wkv_backward(r, k, v, w, u, y[2], dy, dsT)
                  for y in ys]
            torch.cuda.synchronize()
            if not all(cs.same_bits(torch, a, b) for a, b in
                       zip((*ys[0], *gs[0]), (*ys[1], *gs[1]))):
                cs.fail("timing study: a rerun gave other bits")
            del ys, gs
            torch.cuda.empty_cache()
            flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
            rows = []
            for _ in range(10):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
                marks = ev[3:] if run == "C entry point" else None
                fn = ((lambda: entry(marks)) if marks
                      else (lambda: wkm.rwkv6_wkv_forward(*x)))
                if marks:                           # time_ms's warm call
                    entry(None)
                else:
                    fn()
                torch.cuda.synchronize()
                seen = len(collections)
                t0 = time.perf_counter()
                ev[0].record()
                flush.zero_()
                torch.cuda._sleep(sleep)
                ev[1].record()
                fn()
                host = (time.perf_counter() - t0) * 1e3
                ev[2].record()
                ev[2].synchronize()
                gcs = collections[seen:]
                gcs = " ".join(
                    f"gc{a[1]}:{(b[2] - a[2]) * 1e3:.3f}"
                    for a, b in zip(gcs[0::2], gcs[1::2]))
                split = (f"{marks[0].elapsed_time(marks[1]):.4f}/"
                         f"{ev[1].elapsed_time(marks[0]):.4f}/"
                         if marks else "")
                rows.append((ev[1].elapsed_time(ev[2]),
                             f"{ev[1].elapsed_time(ev[2]):.4f}/{split}"
                             f"{host:.4f}/{ev[0].elapsed_time(ev[1]):.4f}"
                             + (f" {gcs}" if gcs else "")))
            what = ("window/kernel/late/host/slack" if run == "C entry point"
                    else "window/host/slack")
            print(f"timing study, {run}, after phase 10's lead-in, sleep "
                  f"{sleep} cycles, 10 readings ({what} ms; gcN:ms a "
                  f"collection): " + " | ".join(t for _, t in rows)
                  + f"; window {stats([w for w, _ in rows])}", flush=True)
            del flush
    finally:
        gc.callbacks.remove(on_gc)


def compare_parent(parent_dir: str, lib, flush) -> None:
    text = pathlib.Path(parent_dir, CSRC).read_text()
    fwd_parent = raw_forward(lib)
    bwd_parent = raw_backward(lib, "float* scratch" in text)
    same = []
    for dtype, s in ((torch.float32, 512), (torch.bfloat16, 192)):
        r, k, v, w, u, s0, _, _ = cs.wkv_inputs(torch, 8, s, 32, 64, dtype,
                                                seed=60)
        m = states_held(wkm.rwkv6_wkv_forward(r, k, v, w, u, s0),
                        fwd_parent(r, k, v, w, u, s0),
                        kref.rwkv6_wkv_forward_plain(r, k, v, w, u, s0)[0],
                        f"forward at {dtype} against the parent's build")
        same.append(f"{str(dtype).split('.')[-1]} (y {m:.2e})")
    r, k, v, w, u, s0, dy, dsT = cs.wkv_inputs(torch, 8, 512, 32, 64,
                                               torch.float32, seed=40)
    ck = wkm.rwkv6_wkv_forward(r, k, v, w, u, s0)[2]
    bargs = (r, k, v, w, u, ck, dy, dsT)
    for name, a, b in zip(("dr", "dk", "dv", "dw", "du", "ds0"),
                          wkm.rwkv6_wkv_backward(*bargs), bwd_parent(*bargs)):
        cs.hold(torch, f"backward {name} against the parent's", a, b)
    print(f"parent {parent_dir}: forward's final state and checkpoints "
          f"bit-identical, y within phase 10's limit of plain: "
          f"{', '.join(same)}; backward within phase 10's limit of the "
          f"parent's", flush=True)
    fargs = (r, k, v, w, u, s0)
    in_turns("training case fwd_ms", lambda: fwd_parent(*fargs),
             lambda: wkm.rwkv6_wkv_forward(*fargs), flush)
    in_turns("training case bwd_ms", lambda: bwd_parent(*bargs),
             lambda: wkm.rwkv6_wkv_backward(*bargs), flush)


def cta_sweep(flush) -> None:
    parts = []
    for b in (33, 66, 99, 132):
        x = cs.wkv_inputs(torch, b, 512, 4, 64, torch.float32, seed=1)[:6]
        ms = readings(lambda: wkm.rwkv6_wkv_forward(*x), flush)
        parts.append(f"{4 * b}: {statistics.median(ms):.4f}")
    print("fwd_ms median against B*H (S 512, H 4, D 64, fp32, 10 calls "
          "each): " + ", ".join(parts), flush=True)


def forward_variants(libs, flush) -> None:
    inputs = {dtype: cs.wkv_inputs(torch, 8, s, 32, 64, dtype, seed=40)[:6]
              for dtype, s in ((torch.float32, 512), (torch.bfloat16, 192))}
    inputs["D32"] = cs.wkv_inputs(torch, 2, 130, 4, 32, torch.float32,
                                  seed=44)[:6]
    mine = {key: wkm.rwkv6_wkv_forward(*x) for key, x in inputs.items()}
    plain = {key: kref.rwkv6_wkv_forward_plain(*x)[0]
             for key, x in inputs.items()}
    for name, lib in libs.items():
        ptxas(_build.BUILD_LOG[f"wkv_fwd_{name}"][1], f"fwd:{name}")
        run = raw_forward(lib)
        try:
            run(*inputs[torch.float32])
        except RuntimeError as err:   # e.g. more shared memory than a CTA has
            print(f"fwd:{name}: {err}", flush=True)
            continue
        verdict = "timed only (y left wrong)"
        if not name.startswith("skip_"):
            meas = [states_held(run(*x), mine[key], plain[key],
                                f"fwd:{name} {key}")
                    for key, x in inputs.items()]
            verdict = ("states bit-identical to this build, y within phase "
                       "10's limit (fp32, bf16, D32: "
                       + ", ".join(f"{m:.2e}" for m in meas) + ")")
        ms = readings(lambda: run(*inputs[torch.float32]), flush)
        print(f"fwd:{name}: {verdict}; fwd_ms {stats(ms)}", flush=True)


def backward_variants(libs, flush) -> None:
    r, k, v, w, u, s0, dy, dsT = cs.wkv_inputs(torch, 8, 512, 32, 64,
                                               torch.float32, seed=40)
    ck = kref.rwkv6_wkv_forward_plain(r, k, v, w, u, s0)[2]
    args = (r, k, v, w, u, ck, dy, dsT)
    gp = kref.rwkv6_wkv_backward_plain(*args)
    for name, lib in libs.items():
        run = raw_backward(lib, False)
        held = [cs.within(torch, a, b) for a, b in zip(run(*args), gp)]
        verdict = "holds" if all(h[0] for h in held) else "FAILS"
        ms = readings(lambda: run(*args), flush)
        print(f"bwd:{name}: {verdict} phase 10's limit against plain (max "
              f"measure {max(h[2] for h in held):.3e}); bwd_ms {stats(ms)}",
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("variants", nargs="*", help="fwd:NAME or bwd:NAME")
    args = ap.parse_args()
    wanted = {"fwd": [], "bwd": []}
    for v in args.variants:
        kind, _, name = v.partition(":")
        if name not in TABLES.get(kind, {}):
            ap.error(f"unknown variant {v}; known: " + ", ".join(
                f"{k}:{n}" for k, t in TABLES.items() for n in t))
        wanted[kind].append(name)
    if not torch.cuda.is_available():
        sys.exit("wkv_variants: no card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    # this source, its variants and the parent's, built all at once
    src = pathlib.Path(ROOT, CSRC).read_text()
    sources = {f"{kind}_{n}": edited(src, TABLES[kind][n])
               for kind, names in wanted.items() for n in names}
    if args.parent:
        sources["parent"] = pathlib.Path(args.parent, CSRC).read_text()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        own = pool.submit(_build.build_all, ["rwkv6_wkv"])
        libs = _build.build_variants(sources, OUT, "wkv") if sources else {}
        own.result()
    ptxas(_build.BUILD_LOG.get("rwkv6_wkv", (0, ""))[1], "source")
    cs.phase_wkv(torch)
    timing_study()
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    if args.parent:
        compare_parent(args.parent, libs["parent"], flush)
    cta_sweep(flush)
    forward_variants({n: libs[f"fwd_{n}"] for n in wanted["fwd"]}, flush)
    backward_variants({n: libs[f"bwd_{n}"] for n in wanted["bwd"]}, flush)


if __name__ == "__main__":
    main()
