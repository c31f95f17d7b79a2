#!/usr/bin/env python3
"""Where the split-K flash-decode kernel loses accuracy: variants on the card.

Builds variants of ``src/repro_torch/kernels/csrc/flash_decode.cu`` that
differ only in how the tensor-core path (bf16 q, bf16 pool) computes its
scores and P.V, and for each reports, at the serving shape of
``chip_smoke.py`` phase 3 (B 8, Hq 48, Hkv 4, D 128, page 16, window 4096):

  * how many bf16 outputs differ from the fp64 result rounded to bf16, and
    how many from the plain version (three seeds);
  * its time (CUDA events, L2 flushed before each launch, as phase 3);
  * max|logits - plain| / max|plain logits| of one decode step of
    starcoder2-15b at full width on the pool that phase 4 served, at 20
    and 40 layers (phase 5's measure; its limit is 1.6e-2).

Variants: ``three_parts`` (the source as it is: P in bf16 hi + mid + lo
parts), ``two_parts`` (hi + lo), ``one_part`` (P rounded to bf16),
``pv_cuda_cores`` (P.V in fp32 FMAs) and ``scores_cuda_cores`` (scores in
fp32 FMAs).  Run from the root of a checkout on one card:

  python3 scripts/flash_decode_variants.py

The builds go to src/repro_torch/kernels/build/variants/ (gitignored).
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_decode as fdm  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402

SOURCE = os.path.join(ROOT, "src/repro_torch/kernels/csrc/flash_decode.cu")
OUT = pathlib.Path(ROOT, "src/repro_torch/kernels/build/variants")
LENGTHS = [0, 1, 16, 1000, 2047, 4096, 4150, 4200]
WINDOW = 4096

SCORES_CUDA = """    {
      const bf16* q0 = reinterpret_cast<const bf16*>(q_s + (mt * 16 + grp) * RS);
      const bf16* q1 = reinterpret_cast<const bf16*>(q_s + (mt * 16 + grp + 8) * RS);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bf16* kr = reinterpret_cast<const bf16*>(
              ks + (kg * 16 + 8 * n + 2 * tig + e) * RS);
          float a0 = 0.0f, a1 = 0.0f;
          for (int d = 0; d < D; ++d) {
            const float kv = __bfloat162float(kr[d]);
            a0 = fmaf(__bfloat162float(q0[d]), kv, a0);
            a1 = fmaf(__bfloat162float(q1[d]), kv, a1);
          }
          sc[n][e] = a0;
          sc[n][2 + e] = a1;
        }
    }
"""

PV_CUDA = """#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int from = (lane & ~3) | ((k & 7) >> 1);
      const float p0 = __shfl_sync(0xffffffffu, pr[k >> 3][k & 1], from);
      const float p1 = __shfl_sync(0xffffffffu, pr[k >> 3][2 + (k & 1)], from);
      const bf16* vr = reinterpret_cast<const bf16*>(vs + (kg * 16 + k) * RS);
#pragma unroll
      for (int n = 0; n < NDT; ++n) {
        const int d = n * 8 + 2 * tig;
        const float v0 = __bfloat162float(vr[d]), v1 = __bfloat162float(vr[d + 1]);
        acc[n][0] = fmaf(p0, v0, acc[n][0]);
        acc[n][1] = fmaf(p0, v1, acc[n][1]);
        acc[n][2] = fmaf(p1, v0, acc[n][2]);
        acc[n][3] = fmaf(p1, v1, acc[n][3]);
      }
    }
  }
"""


def _between(src: str, start: str, end: str) -> str:
    i = src.index(start)
    return src[i:src.index(end, i)]


def variants(src: str) -> dict:
    """name -> source text; each edit must match the source exactly."""
    scores = _between(src, "#pragma unroll\n    for (int kk = 0; kk < D / 16;",
                      "    bool vis[2][2];")
    pv = _between(src, "#pragma unroll\n    for (int dd = 0; dd < D / 16;",
                  "  l0 = quad_sum(l0);")
    mid = ("      mma_bf16(c0, pm, bv[0], bv[1]);\n",
           "      mma_bf16(c1, pm, bv[2], bv[3]);\n")
    low = ("      mma_bf16(c0, pl, bv[0], bv[1]);\n",
           "      mma_bf16(c1, pl, bv[2], bv[3]);\n")
    for line in mid + low:
        assert line in pv, line
    two = pv
    for line in mid:                 # the lo part takes what hi leaves
        two = two.replace(line, "")
    one = two
    for line in low:
        one = one.replace(line, "")
    split = "  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m));"
    assert split in src
    return {
        "three_parts": src,
        "two_parts": src.replace(pv, two).replace(
            split, "  const __nv_bfloat162 l = m;"),
        "one_part": src.replace(pv, one),
        "pv_cuda_cores": src.replace(pv, PV_CUDA),
        "scores_cuda_cores": src.replace(scores, SCORES_CUDA),
    }


def build(sources: dict) -> dict:
    libs = _build.build_variants(sources, OUT, "decode")
    return {name: fdm.declare(lib) for name, lib in libs.items()}


def caller(lib):
    """The wrapper's launch on a variant's library (bf16 q and pool)."""
    def fd(q, kp, vp, tables, lengths, *, window=0, scale=None,
           split_keys=None):
        b, hq, d = q.shape
        hkv, n_pages, page, _ = kp.shape
        g = hq // hkv
        sk, n_splits = fdm.split_plan(tables.shape[1], page, int(window),
                                      split_keys)
        out = torch.empty_like(q)
        acc = torch.empty((b, hkv, n_splits, g, d), dtype=torch.float32,
                          device=q.device)
        ml = torch.empty((b, hkv, n_splits, g, 2), dtype=torch.float32,
                         device=q.device)
        err = lib.flash_decode_launch(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), acc.data_ptr(),
            ml.data_ptr(), 1, 1, b, hkv, g, d, n_pages, page,
            tables.shape[1], int(window),
            float(scale if scale is not None else d ** -0.5), sk, n_splits,
            q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(f"variant launch failed: cudaError {err}")
        return out
    return fd


def truth64(q, kp, vp, tables, lens, window):
    b, hq, d = q.shape
    hkv = kp.shape[0]
    k = kref.gather_pages(kp, tables).double()
    v = kref.gather_pages(vp, tables).double()
    s = torch.einsum("bkgd,btkd->bkgt",
                     q.reshape(b, hkv, hq // hkv, d).double(), k) * d ** -0.5
    ln = lens.long()[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None]
    valid = (kpos < ln) & ((ln - 1 - kpos) < window)
    s = s.masked_fill(~valid[:, None, None], kref.NEG_INF)
    o = torch.einsum("bkgt,btkd->bkgd", torch.softmax(s, -1), v)
    o = torch.where(valid.any(1)[:, None, None, None], o, 0.0)
    return o.reshape(b, hq, d)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("flash_decode_variants: no card")
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(SOURCE) as f:
        libs = build(variants(f.read()))
    print(cs.smi_line())
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for seed in (2, 3, 4):
        case = cs.decode_case(torch, b=8, hkv=4, g=12, d=128, page=16,
                              maxp=272, lengths=LENGTHS,
                              dtype=torch.bfloat16, seed=seed)
        truth = truth64(*case, WINDOW).to(torch.bfloat16)
        plain = kops.flash_decode(*case, window=WINDOW, impl="plain")
        row = [f"plain {int((plain != truth).sum())}"]
        for name, lib in libs.items():
            fd = caller(lib)
            out = fd(*case, window=WINDOW)
            ms = cs.time_ms(torch, lambda: fd(*case, window=WINDOW), flush,
                            30)
            row.append(f"{name} {int((out != truth).sum())}/"
                       f"{int((out != plain).sum())} {ms:.4f} ms")
        print(f"seed {seed}, of {truth.numel()} outputs (differ from the "
              f"rounded fp64 result / from plain, time): " + "; ".join(row))

    cfg, _, params, engine, _ = cs.phase_serve(torch, np)
    from repro_torch.models import build as build_model
    toks, tables, lengths, active = cs.decode_state(torch, np, cfg, engine)
    plain = build_model(dataclasses.replace(cfg), param_dtype=torch.bfloat16,
                        cache_dtype=torch.bfloat16, decode_impl="plain",
                        device="cuda")

    def logits(bundle, depth):
        with torch.no_grad():
            out, _ = bundle.decode_step_paged(params, toks,
                                              engine.pages[:depth], tables,
                                              lengths, active)
        return out.float()

    kernel = fdm.flash_decode
    try:
        for depth in (20, cfg.n_layers):
            ref = logits(plain, depth)
            row = []
            for name, lib in libs.items():
                fdm.flash_decode = caller(lib)
                got = logits(engine.bundle, depth)
                row.append(f"{name} {((got - ref).abs().max() / ref.abs().max()).item():.4e}")
            print(f"logits at {depth} layers, max|diff| / max|logit| "
                  f"against plain: " + "; ".join(row))
    finally:
        fdm.flash_decode = kernel


if __name__ == "__main__":
    main()
