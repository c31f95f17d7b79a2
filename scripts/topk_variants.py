#!/usr/bin/env python3
"""The top-k kernel on the card: phase 6 alone, the parent's build beside
it, and variants of the source, one per design step.

Runs ``chip_smoke.py`` phase 6 alone (the kernel, single and grouped,
against ``topk_compress_plain`` and ``topk_compress_radix_plain``, its
control, the ResNet-18 and rwkv6-1.6b fires against torch.topk and the
bound), then times two fires, each after one L2 flush, on one card:

  * ``resnet``: ResNet-18 at width 64, 55 leaves x 16 rows fp32, as the
    reducer runs it (one grouped call);
  * ``rwkv``: rwkv6-1.6b at 4 layers, 25 leaves x 4 rows fp32 (7.85 GB), in
    the reducer's 1 GiB groups.

With ``--parent DIR`` (an unpacked checkout of an earlier commit, e.g.
``git archive HEAD~1 | tar -x -C _archive/parent``) it builds that
checkout's ``csrc/topk_compress.cu`` (the one-leaf-a-call interface of the
first port) and times it leaf by leaf beside this source's grouped calls,
in turns (parent, this, this, parent), after holding its outputs equal.
Each variant named on the command line is an edit of this source
(``VARIANTS`` below) or, for ``per_leaf``, this source called one leaf at
a time; each is held against the source's outputs ("holds" or "FAILS"),
timed at both fires, and its kernels' device time read from a profiler
trace of the ResNet fire.  ``--no-phase`` skips phase 6.

Run from the root of a checkout on one card:

  python3 scripts/topk_variants.py [--parent DIR] [--no-phase] [variant ...]

The builds go to src/repro_torch/kernels/build/variants/ (gitignored).
"""
from __future__ import annotations

import argparse
import ctypes
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.comm.sparse import TopKReducer  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import topk_compress as tkm  # noqa: E402

CSRC = "src/repro_torch/kernels/csrc/topk_compress.cu"
OUT = pathlib.Path(ROOT, "src/repro_torch/kernels/build/variants")
# edits of the source: name -> [(text, its replacement), ...].  "skip_*"
# variants leave out one part of the work and give wrong outputs: they are
# timed to see what that part costs, not held.
VARIANTS = {
    "source": [],
    # pass C re-reads x for every row: no candidate buffer
    "no_candidates": [("constexpr int CAP_SHIFT = 4;",
                       "constexpr int CAP_SHIFT = 31;")],
    # every row takes the four large-row launches
    "no_small_path": [("const bool small = e[F_N] <= SMALL_N;",
                       "const bool small = false;")],
    # a 12-bit first digit (12 + 11 + 8); the small kernel's row shrinks to
    # 4096 elements so that its 16 KB histogram fits shared memory
    "digit1_12": [("constexpr int DIGIT1 = 11;", "constexpr int DIGIT1 = 12;"),
                  ("constexpr int SMALL_N = 8192;",
                   "constexpr int SMALL_N = 4096;")],
    # pass D: 2 CTAs of 512 threads an SM, four loads in flight a thread
    "compact_2x512": [("constexpr int D_U = 2;", "constexpr int D_U = 4;"),
                      ("constexpr int D_MIN_BLOCKS = 3;",
                       "constexpr int D_MIN_BLOCKS = 2;")],
    # pass D: chunks of 8192, 6 CTAs of 256 threads an SM
    "compact_6x256": [("constexpr int D_THREADS = 512;",
                       "constexpr int D_THREADS = 256;"),
                      ("constexpr int CHUNK = 16384;",
                       "constexpr int CHUNK = 8192;"),
                      ("constexpr int D_MIN_BLOCKS = 3;",
                       "constexpr int D_MIN_BLOCKS = 6;")],
    # passes A-C: spans of 32768 elements
    "span_32k": [("constexpr int SPAN = 4 * CHUNK;",
                  "constexpr int SPAN = 2 * CHUNK;")],
    "digit_6_per_sm": [
        ("__global__ void __launch_bounds__(THREADS)\ntopk_digit(",
         "__global__ void __launch_bounds__(THREADS, 6)\ntopk_digit(")],
    # pass D's tickets row by row: the chunks in flight crowd into one row
    "tickets_row_major": [
        ("  const int64_t row = local % e[F_ROWS];\n"
         "  const int chunk = static_cast<int>(local / e[F_ROWS]);",
         "  const int64_t row = local / e[F_NCHUNKS];\n"
         "  const int chunk = static_cast<int>(local % e[F_NCHUNKS]);")],
    # pass D without its compaction (counts and look-back only)
    "skip_compact": [("  if (gt + min(max(fill - eq_before, 0), eq) == 0) return;",
                      "  if (gt + min(max(fill - eq_before, 0), eq) >= 0) return;")],
    # pass D ranks but writes nothing
    "skip_writes": [("      if (slot < k) {", "      if (slot < 0) {")],
}
RATIO = 0.05


def edited(src: str, edits) -> str:
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


def fires():
    """The two fires' inputs and ks, and each fire's call groups."""
    k_for = TopKReducer(RATIO).k_for
    gen = torch.Generator(device="cuda").manual_seed(19)
    out = {}
    for name, sizes, rows in (
            ("resnet", cs.resnet18_leaf_sizes(torch), cs.TOPK_ROWS),
            ("rwkv", cs.rwkv_leaf_sizes(), 4)):
        xs = [torch.randn((rows, n), generator=gen, device="cuda")
              for n in sizes]
        out[name] = (xs, [k_for(n) for n in sizes], cs.topk_groups(sizes,
                                                                   rows))
    return out


def grouped(xs, ks, groups):
    return [o for g in groups for o in tkm.topk_compress_many(
        [xs[i] for i in g], [ks[i] for i in g])]


def parent_fn(lib):
    """The parent build (one leaf a call, zeroed scratch) over a fire."""
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.topk_compress_scratch_ints.argtypes = [ci, cll]
    lib.topk_compress_scratch_ints.restype = cll
    lib.topk_compress_launch.argtypes = [vp, vp, vp, vp, ci, ci, cll, ci, ci,
                                         vp]
    lib.topk_compress_launch.restype = ci

    def run(xs, ks, groups=None):
        outs = []
        for x, k in zip(xs, ks):
            rows, n = x.shape
            v = torch.empty((rows, k), device="cuda")
            i = torch.empty((rows, k), dtype=torch.int32, device="cuda")
            sc = torch.zeros(lib.topk_compress_scratch_ints(rows, n),
                             dtype=torch.int32, device="cuda")
            err = lib.topk_compress_launch(
                x.data_ptr(), v.data_ptr(), i.data_ptr(), sc.data_ptr(), 0,
                rows, n, k, x.device.index,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"parent launch refused: cudaError {err}")
            outs.append((v, i))
        return outs
    return run


def same(a, b) -> bool:
    return all(torch.equal(i, j) and cs.same_bits(torch, v, w)
               for (v, i), (w, j) in zip(a, b))


def kernel_ms(fn):
    """Device time per kernel name in a profiler trace of fn."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda").add_(1)   # the trace's first kernel
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        kernels, _ = cs.trace_kernels(prof, os.path.join(tmp, "t.json.gz"))
    by = {}
    for name, _, dur, _ in kernels:
        m = re.search(r"topk_\w+(<[^>]*>)?", name)
        if m:
            short = m.group(0).replace(" ", "")
            by[short] = by.get(short, 0.0) + dur / 1e3
    return " ".join(f"{k}={v:.4f}" for k, v in sorted(by.items()))


def reducer_walls(flush):
    """Host wall of TopKReducer.compress on a ResNet-18 tree at 16
    learners, grouped (the default budget) and leaf by leaf, in turns,
    each across a synchronize; and the host's CUDA API time of each."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.comm.sparse import TopKReducer
    from repro_torch.configs.resnet18_cifar import CNNConfig
    from repro_torch.models.resnet import resnet_init
    from repro_torch.tree import tree_map
    gen = torch.Generator(device="cuda").manual_seed(7)
    tmpl = resnet_init(None, CNNConfig(width=64), device="meta")
    tree = tree_map(lambda m: torch.randn((1, 4, 4) + tuple(m.shape),
                                          generator=gen, device="cuda"), tmpl)
    walls = {}
    for budget in ("grouped", "per_leaf", "per_leaf", "grouped"):
        red = TopKReducer(RATIO)
        if budget == "per_leaf":
            red.group_bytes = 0
        state = red.init_state(tree_map(torch.zeros_like, tree))
        red.compress(tree, state)
        torch.cuda.synchronize()
        for _ in range(3):
            t0 = time.perf_counter()
            red.compress(tree, state)
            torch.cuda.synchronize()
            walls.setdefault(budget, []).append(
                (time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            red.compress(tree, state)
            torch.cuda.synchronize()
        api = sorted(((e.self_cpu_time_total, e.key) for e in
                      prof.key_averages() if e.key.startswith("cuda")),
                     reverse=True)[:4]
        walls.setdefault(budget + "_api", []).append(
            " ".join(f"{k} {v / 1e3:.3f}" for v, k in api))
    print("reducer compress wall ms (ResNet-18, 16 learners; grouped, per "
          "leaf, per leaf, grouped): " + " ".join(
              f"{k}={cs.fmt(v) if 'api' not in k else v}"
              for k, v in walls.items()), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--no-phase", action="store_true")
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("topk_variants: no card")
    print(cs.smi_line(), flush=True)
    _build.build_all(["topk_compress"])
    for line in _build.BUILD_LOG.get("topk_compress", (0, ""))[1].splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    if not args.no_phase:
        cs.phase_topk(torch)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    reducer_walls(flush)
    data = fires()
    ref = {name: grouped(*d) for name, d in data.items()}
    if args.parent:
        text = pathlib.Path(args.parent, CSRC).read_text()
        run_parent = parent_fn(_build.build_variants(
            {"parent": text}, OUT, "topk")["parent"])
        for name, (xs, ks, groups) in data.items():
            if not same(run_parent(xs, ks), ref[name]):
                cs.fail(f"the parent's build differs at the {name} fire")
            readings = {"parent": [], "this": []}
            for who, fn in (("parent", run_parent), ("this", grouped),
                            ("this", grouped), ("parent", run_parent)):
                readings[who] += cs.fire_ms(
                    torch, lambda: fn(xs, ks, groups), flush, 5,
                    sleep=4 * cs.TOPK_SLEEP_CYCLES)[0]
            print(f"parent {args.parent} at the {name} fire: same outputs; "
                  f"ms in turns (parent, this, this, parent; 5 each): "
                  f"parent={cs.fmt(readings['parent'])} "
                  f"this={cs.fmt(readings['this'])}", flush=True)
    if not args.variants:
        return
    src = pathlib.Path(ROOT, CSRC).read_text()
    libs = _build.build_variants(
        {n: edited(src, VARIANTS[n]) for n in args.variants
         if n != "per_leaf"}, OUT, "topk")
    kernel = tkm._lib
    try:
        for name in args.variants:
            if name == "per_leaf":
                fn = lambda xs, ks, groups: [  # noqa: E731
                    tkm.topk_compress(x, k) for x, k in zip(xs, ks)]
            else:
                tkm._lib = lambda lib=libs[name]: tkm.declare(lib)
                fn = grouped
            line = []
            for fire, (xs, ks, groups) in data.items():
                verdict = "holds" if same(fn(xs, ks, groups), ref[fire]) \
                    else "FAILS"
                ms, host = cs.fire_ms(
                    torch, lambda: fn(xs, ks, groups), flush, 5,
                    sleep=4 * cs.TOPK_SLEEP_CYCLES, strict=name != "per_leaf")
                line.append(f"{fire} {verdict} ms {statistics.median(ms):.4f}"
                            f" {cs.fmt(ms)} (host enqueue {host:.3f} ms)")
            for fire, (xs, ks, groups) in data.items():
                line.append(f"{fire} kernels (ms) " + kernel_ms(
                    lambda: fn(xs, ks, groups)))
            print(f"variant {name}: " + "; ".join(line), flush=True)
    finally:
        tkm._lib = kernel
    # fences in the SASS of each kernel of the source (the look-back's
    # loads and stores are relaxed: only the last-CTA tickets fence)
    lib = next(iter(OUT.glob("libtopk_source*.so")), None)
    if lib is not None:
        sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                               str(lib)], capture_output=True, text=True)
        counts, fn = {}, None
        for ln in sass.stdout.splitlines():
            if "Function :" in ln:
                fn = ln.split("Function :")[1].strip()
                counts[fn] = {}
            elif fn and ("MEMBAR" in ln or "FENCE" in ln or "ERRBAR" in ln):
                op = ln.split("*/")[1].split(";")[0].strip() if "*/" in ln \
                    else ln.strip()
                counts[fn][op] = counts[fn].get(op, 0) + 1
        for fn, ops in counts.items():
            print(f"SASS {fn[:80]}: {ops}", flush=True)

if __name__ == "__main__":
    main()
