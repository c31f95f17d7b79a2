#!/usr/bin/env python3
"""The tensor-core attention kernels' variants on the card: accuracy and time.

Runs ``chip_smoke.py`` phase 11 alone (the attention kernels against their
plain versions and ``flash_attention_split_plain``, controls, rerun bits,
times against the bound, the plain versions and SDPA), then builds
variants of ``src/repro_torch/kernels/csrc/flash_attention.cu`` and, for
each, at the training case of phase 11 (B 4, S 1024, Hq 48, Hkv 4, D 128,
causal):

  * max|kernel - truth| / max|truth| of o, dQ, dK and dV, the truth in
    fp64 (fp32 inputs) -- the plain version's reading is printed beside;
  * on bf16 inputs, the largest share of phase 11's bf16 limit (BF16_ULPS
    ulps of max(|kernel|, |plain|) plus KERN_REL_TOL of max|plain|) that
    o and dQ, dK, dV (the backward given the plain forward's output and
    lse, as phase 11 gives it) take against the plain version -- over 1
    fails;
  * the forward's and the backward's time (CUDA events, L2 flushed before
    each call, as phase 11 times them), fp32 and bf16.

It also prints SDPA's bf16 output and gradients (one
``F.scaled_dot_product_attention`` call and its autograd backward) as
shares of the same limit: a yardstick, never called by the port.

Variants: ``tf32x3`` (the source as it is: three TF32 products per fp32
product), ``tf32_one_term`` (big.big alone: what a TF32 matmul does, a
control the fp32 limit of 1e-5 must reject), ``bf16_p_one_part`` (P and
dS rounded to one bf16 part against bf16 inputs, as SDPA's bf16 kernels
feed P), ``cvt_rna`` (the TF32 rounding by cvt.rna.tf32.f32 in place of
the source's two integer operations: the same values) and other tile
sizes in the source's ``Cfg`` (``fwd_kb16``, ``dq_w4_kb32``,
``dkdv_w8_qb16``, ``bf16_kb64``, ``bf16_kb16``, ``bf16_qb32``,
``bf16_qc32``).  Name variants on the command line to build only those.
Run from the root of a checkout on one card:

  python3 scripts/flash_attention_variants.py

The builds go to src/repro_torch/kernels/build/variants/ (gitignored).
"""
from __future__ import annotations

import os
import pathlib
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fam  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402

SOURCE = os.path.join(ROOT, "src/repro_torch/kernels/csrc/flash_attention.cu")
OUT = pathlib.Path(ROOT, "src/repro_torch/kernels/build/variants")
THREE_TERMS = """    mma_tf32_z(c, small, bb0, bb1);
    mma_tf32(c, big, bs0, bs1);
    mma_tf32(c, big, bb0, bb1);
"""
THREE_PARTS = """        mma_bf16_z(c0, pl, bv[0], bv[1]);
        mma_bf16(c0, pm, bv[0], bv[1]);
        mma_bf16(c0, ph, bv[0], bv[1]);
        mma_bf16_z(c1, pl, bv[2], bv[3]);
        mma_bf16(c1, pm, bv[2], bv[3]);
        mma_bf16(c1, ph, bv[2], bv[3]);
"""
ONE_PART = """        mma_bf16_z(c0, ph, bv[0], bv[1]);
        mma_bf16_z(c1, ph, bv[2], bv[3]);
"""
# edits of the source: (text, its replacement), ...
EDITS = {
    "fwd_kb16": [("KB = F32 && !BIG ? 64 : 32;", "KB = F32 && !BIG ? 64 : (F32 ? 16 : 32);")],
    "dq_w4_kb32": [("DQ_WQ = F32 ? 8 : 4;", "DQ_WQ = 4;"),
                   ("DQ_KB = BIG ? 16 : (F32 ? 64 : 32);", "DQ_KB = 32;")],
    "dkdv_w8_qb16": [("WK = 4;", "WK = 8;"),
                     ("QB = BIG ? 32 : 64;", "QB = BIG ? 16 : 64;")],
    "bf16_kb64": [("KB = F32 && !BIG ? 64 : 32;", "KB = BIG ? 32 : 64;"),
                  ("DQ_KB = BIG ? 16 : (F32 ? 64 : 32);", "DQ_KB = BIG ? 16 : 64;")],
    "bf16_kb16": [("KB = F32 && !BIG ? 64 : 32;", "KB = F32 ? (BIG ? 32 : 64) : 16;"),
                  ("DQ_KB = BIG ? 16 : (F32 ? 64 : 32);", "DQ_KB = BIG ? 16 : (F32 ? 64 : 16);")],
    "bf16_qb32": [("QB = BIG ? 32 : 64;", "QB = BIG ? 32 : (F32 ? 64 : 32);")],
    "bf16_qc32": [("QC = F32 && !BIG ? 32 : 16;", "QC = F32 ? (BIG ? 16 : 32) : 32;")],
    "cvt_rna": [("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                 '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n'
                 "  return r;")],
}


def variants(src: str) -> dict:
    """name -> source text; each edit must match the source exactly."""
    assert src.count(THREE_TERMS) == 1 and src.count(THREE_PARTS) == 1
    out = {"tf32x3": src,
           "tf32_one_term": src.replace(
               THREE_TERMS, "    mma_tf32_z(c, big, bb0, bb1);\n"),
           "bf16_p_one_part": src.replace(THREE_PARTS, ONE_PART)}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            assert text.count(old) == 1, old
            text = text.replace(old, new)
        out[name] = text
    return out


def build(sources: dict) -> dict:
    libs = _build.build_variants(sources, OUT, "attn")
    return {name: fam.declare(lib) for name, lib in libs.items()}


def truth64(q, k, v, do):
    """o and (dq, dk, dv) of causal GQA attention in fp64, by autograd."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    x = [t.double().requires_grad_() for t in (q, k, v)]
    qg = x[0].reshape(b, s, hkv, hq // hkv, d)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, x[1]) * d ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    sc = sc.masked_fill(~mask, kref.NEG_INF)
    o = torch.einsum("bkgst,btkd->bskgd", torch.softmax(sc, -1), x[2])
    o = o.reshape(b, s, hq, d)
    grads = torch.autograd.grad(o, x, do.double())
    return o.detach(), grads


def rel(a, truth) -> float:
    return ((a.double() - truth).abs().max() / truth.abs().max()).item()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("flash_attention_variants: no card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    _build.build_all(["flash_attention"])
    cs.phase_attention(torch)
    with open(SOURCE) as f:
        sources = variants(f.read())
    if len(sys.argv) > 1:
        sources = {n: t for n, t in sources.items() if n in sys.argv[1:]}
    libs = build(sources)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    q, k, v, do = cs.attn_inputs(torch, 4, 1024, 48, 4, 128, torch.float32,
                                 50)
    o64, g64 = truth64(q, k, v, do)
    op, lp = kref.flash_attention_plain(q, k, v)
    gp = kref.flash_attention_backward_plain(q, k, v, op, lp, do)
    names = ("o", "dq", "dk", "dv")
    print("plain fp32 vs fp64: " + " ".join(
        f"{n}={rel(a, t):.3e}" for n, a, t in zip(names, (op, *gp),
                                                  (o64, *g64))), flush=True)
    bf = [x.to(torch.bfloat16) for x in (q, k, v, do)]
    opb, lpb = kref.flash_attention_plain(*bf[:3])
    gpb = kref.flash_attention_backward_plain(*bf[:3], opb, lpb, bf[3])

    def shares(outs, plain) -> str:
        """Each output's largest share of phase 11's bf16 limit against
        the plain version's."""
        return " ".join(f"{n}={cs.within(torch, a, t)[2]:.3f}" for n, a, t
                        in zip(names, outs, plain))

    # SDPA's backward takes rowsum(dO O) from its own output: its
    # gradients are held to the plain backward given that output
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in bf[:3])
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    gs = torch.autograd.grad(out, (qt, kt, vt), bf[3].transpose(1, 2))
    out = out.detach().transpose(1, 2).contiguous()
    print("sdpa bf16 vs plain (shares of the bf16 limit): " + shares(
        (out, *(x.transpose(1, 2) for x in gs)),
        (opb, *kref.flash_attention_backward_plain(*bf[:3], out, lpb,
                                                   bf[3]))), flush=True)
    kernel = fam._lib
    try:
        for name, lib in libs.items():
            fam._lib = lambda lib=lib: lib
            o, lse = fam.flash_attention_fwd(q, k, v)
            g = fam.flash_attention_backward(q, k, v, o, lse, do)
            errs = " ".join(f"{n}={rel(a, t):.3e}" for n, a, t in
                            zip(names, (o, *g), (o64, *g64)))
            ob, lb = fam.flash_attention_fwd(*bf[:3])
            # the backward given the plain forward's outputs, as phase 11
            gb = fam.flash_attention_backward(*bf[:3], opb, lpb, bf[3])
            times = []
            for args, oo, ll in (((q, k, v), o, lse), (bf[:3], ob, lb)):
                dd = do if args[0].dtype == torch.float32 else bf[3]
                times.append(cs.time_ms(
                    torch, lambda: fam.flash_attention_fwd(*args), flush, 10))
                times.append(cs.time_ms(
                    torch, lambda: fam.flash_attention_backward(
                        *args, oo, ll, dd), flush, 5))
            held = shares((ob, *gb), (opb, *gpb))
            print(f"variant {name}: fp32 vs fp64 {errs}; bf16 vs plain "
                  f"(shares of the bf16 limit) {held}; fp32 fwd_ms="
                  f"{times[0]:.4f} bwd_ms={times[1]:.4f}; bf16 fwd_ms="
                  f"{times[2]:.4f} bwd_ms={times[3]:.4f}", flush=True)
    finally:
        fam._lib = kernel


if __name__ == "__main__":
    main()
