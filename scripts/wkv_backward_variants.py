#!/usr/bin/env python3
"""The WKV6 backward kernel on the card: phase 10 alone, the parent's
build beside it, and variants of the source.

Runs ``chip_smoke.py`` phase 10 alone (the WKV6 kernels against their
plain versions and the backward against
``rwkv6_wkv_backward_blocked_plain``, controls, rerun bits, times against
the bound), then, at the training case of phase 10 (B 8, S 512, H 32,
D 64, fp32, L2 flushed before each call):

  * with ``--parent DIR`` (an unpacked checkout of an earlier commit,
    e.g. ``git archive HEAD~1 | tar -x -C _archive/parent``), builds that
    checkout's ``csrc/rwkv6_wkv.cu`` beside this one and holds its forward
    outputs (y, the final state, the checkpoints) against this one's bit
    for bit, at fp32 and bf16; then times the two backward kernels in
    turns (parent, this, this, parent; 10 calls each) and prints each
    call's time.  A parent whose backward takes a per-CTA scratch (the
    first port's, before the states were kept on chip) gets one;
  * for each variant of this source named on the command line (edits of
    it, ``VARIANTS`` below), says whether the backward holds phase 10's
    limit against the plain version and times it (10 calls).

Run from the root of a checkout on one card:

  python3 scripts/wkv_backward_variants.py [--parent DIR] [variant ...]

The builds go to src/repro_torch/kernels/build/variants/ (gitignored).
"""
from __future__ import annotations

import argparse
import ctypes
import os
import pathlib
import sys

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
# edits of the source: name -> [(text, its replacement), ...].  The
# "skip_*" variants leave out one part of the work and give wrong
# gradients: they are timed to see what that part costs, not held (the
# compiler also drops what only fed the part left out).
VARIANTS = {
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


def edited(src: str, edits) -> str:
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


def parent_backward(lib, scratch: bool):
    """The parent build's backward as a function of phase 10's inputs."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_forward_launch.argtypes = [vp] * 9 + [ci] * 6 + [vp]
    lib.wkv6_forward_launch.restype = ci
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
            raise RuntimeError(f"parent backward refused: cudaError {err}")
        return (*grads, du, ds0)
    return run


def compare_parent(parent_dir: str, flush) -> None:
    text = pathlib.Path(parent_dir, CSRC).read_text()
    lib = _build.build_variants({"parent": text}, OUT, "wkv")["parent"]
    run_parent = parent_backward(lib, "float* scratch" in text)
    same = []
    for dtype, s in ((torch.float32, 512), (torch.bfloat16, 192)):
        r, k, v, w, u, s0, dy, dsT = cs.wkv_inputs(torch, 8, s, 32, 64,
                                                   dtype, seed=60)
        ours = wkm.rwkv6_wkv_forward(r, k, v, w, u, s0)
        theirs = [torch.empty_like(x) for x in ours]
        err = lib.wkv6_forward_launch(
            *(x.data_ptr() for x in (r, k, v, w, u, s0, *theirs)),
            0 if dtype == torch.float32 else 1, 8, s, 32, 64,
            r.device.index, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err or not all(cs.same_bits(torch, a, b)
                          for a, b in zip(ours, theirs)):
            cs.fail(f"forward at {dtype} differs from the parent's build")
        same.append(str(dtype).split(".")[-1])
    r, k, v, w, u, s0, dy, dsT = cs.wkv_inputs(torch, 8, 512, 32, 64,
                                               torch.float32, seed=40)
    _, _, ck = wkm.rwkv6_wkv_forward(r, k, v, w, u, s0)
    args = (r, k, v, w, u, ck, dy, dsT)
    gp, gk = run_parent(*args), wkm.rwkv6_wkv_backward(*args)
    for name, a, b in zip(("dr", "dk", "dv", "dw", "du", "ds0"), gk, gp):
        cs.hold(torch, f"backward {name} against the parent's", a, b)
    order = (("parent", run_parent), ("this", wkm.rwkv6_wkv_backward),
             ("this", wkm.rwkv6_wkv_backward), ("parent", run_parent))
    readings = {"parent": [], "this": []}
    for name, fn in order:
        readings[name] += [cs.time_ms(torch, lambda: fn(*args), flush, 1)
                           for _ in range(10)]
    print(f"parent {parent_dir}: forward bit-identical ({', '.join(same)}); "
          f"backward within phase 10's limit of the parent's; training "
          f"case bwd_ms (parent, this, this, parent, 10 calls each): "
          f"parent={cs.fmt(readings['parent'])} "
          f"this={cs.fmt(readings['this'])}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("wkv_backward_variants: no card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    _build.build_all(["rwkv6_wkv"])
    for line in _build.BUILD_LOG.get("rwkv6_wkv", (0, ""))[1].splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    cs.phase_wkv(torch)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    if args.parent:
        compare_parent(args.parent, flush)
    if not args.variants:
        return
    src = pathlib.Path(ROOT, CSRC).read_text()
    libs = _build.build_variants(
        {n: edited(src, VARIANTS[n]) for n in args.variants}, OUT, "wkv")
    r, k, v, w, u, s0, dy, dsT = cs.wkv_inputs(torch, 8, 512, 32, 64,
                                               torch.float32, seed=40)
    _, _, ck = kref.rwkv6_wkv_forward_plain(r, k, v, w, u, s0)
    gp = kref.rwkv6_wkv_backward_plain(r, k, v, w, u, ck, dy, dsT)
    kernel = wkm._lib
    try:
        for name, lib in libs.items():
            wkm._lib = lambda lib=lib: wkm.declare(lib)
            gk = wkm.rwkv6_wkv_backward(r, k, v, w, u, ck, dy, dsT)
            held = [cs.within(torch, a, b) for a, b in zip(gk, gp)]
            verdict = ("holds" if all(h[0] for h in held) else "FAILS")
            ms = [cs.time_ms(torch, lambda: wkm.rwkv6_wkv_backward(
                r, k, v, w, u, ck, dy, dsT), flush, 1) for _ in range(10)]
            print(f"variant {name}: {verdict} phase 10's limit against plain "
                  f"(max measure {max(h[2] for h in held):.3e}); bwd_ms "
                  f"{sum(ms) / len(ms):.4f} {cs.fmt(ms)}", flush=True)
    finally:
        wkm._lib = kernel


if __name__ == "__main__":
    main()
