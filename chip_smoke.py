#!/usr/bin/env python3
"""On-card smoke of the PyTorch port on one NVIDIA GPU: paged serving of
StarCoder2-15B at full width through the hand-written flash-decode kernel,
and Hier-AVG training of ResNet-18 at full width with a sparse top-k
global reduction through the hand-written top-k kernel.

  python3 chip_smoke.py            # from the root of a checkout, one card

Phases (each prints one line of numbers; any failure exits non-zero):
  1. device   card name and power limit (nvidia-smi), torch/CUDA versions
  2. build    nvcc builds csrc/flash_decode.cu and csrc/topk_compress.cu
              for sm_90a, both at once (seconds, ptxas)
  3. kernel   flash_decode against its plain PyTorch version on the card,
              at small fp32 shapes (three windows, several tiles and pages)
              and at the serving shape in fp32 and in bf16, with the
              kernel's, the plain version's and SDPA's times and the bound
  4. serve    starcoder2-15b at full width, bf16 random weights from seed 0,
              PagedServeEngine(slots=8, page_size=16, prefill_chunk=256),
              12 seeded requests; the kernel's launch count must equal
              40 x decode steps
  4b. profile device time of five decode steps by kernel class; idle share
              against the unprofiled steps' wall time
  5. logits   one decode step on the served pool state with the kernel and
              with the plain version at 10, 20 and 40 layers; at 40 they
              agree within LOGIT_REL_TOL * max|logit|, and two controls with
              a wrong window must not
  6. topk     topk_compress against its plain version, bit for bit in
              values and indices: 16 fp32 rows at every leaf size of
              ResNet-18 (k at ratio 0.05), k = 1, k = n, bf16 ties, an
              all-zero row, +-1 with a 1e8 outlier, signed zeros,
              subnormals, and 2 rows of 2^24 + 3; then the time of one
              global fire (55 leaves, L2 flushed before each launch) for
              the kernel, the plain version and torch.topk, with the bound
  7. train    Simulator: ResNet-18 at width 64 (11,172,160 params per
              learner, fp32), P = 16 learners as (1, 4, 4), plan
              local@2/global@8:topk:0.05 per leaf, sgd(0.1), 32 examples
              per learner per step of the seeded Gaussian-mixture task as
              32x32x3 images, 3 rounds: per-round losses, walls, peak
              memory, and 165 top-k launches (55 leaves x 3 fires); then
              2 rounds from one converted state with the kernel and with
              the plain top-k, which must agree bit for bit; then one
              profiled round by kernel class, idle share against an
              unprofiled round's wall
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import gzip
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3 peak
BF16_FLOPS = 989e12                 # dense tensor-core peak, bf16
FP32_FLOPS = 67e12                  # fp32 outside the tensor cores
FP32_TOL = 1e-5
# bf16, per element: BF16_ULPS ulps of max(|kernel|, |plain|) for the two
# final roundings, plus FP32_TOL for the fp32 sums before them (an output
# that cancels to near zero keeps their absolute error, not a relative one)
BF16_ULPS = 2.0
# decode logits at 40 layers, max|kernel - plain| / max|logit|: reads
# 1.399e-2 on an H100; plain with the window one page short reads 1.866e-2
# against plain, so the limit sits between them (PERF.md, Findings)
LOGIT_REL_TOL = 1.6e-2
SOURCES = ("flash_decode", "topk_compress")
TOPK_RATIO = 0.05
TOPK_ROWS = 16                      # P = 16 learners: one row each
TRAIN_PLAN = "local@2/global@8:topk:0.05"
TRAIN_ROUNDS = 3


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


# --------------------------------------------------------------------- #
# phase 3: kernel against plain


def decode_case(torch, *, b, hkv, g, d, page, maxp, lengths, dtype, seed,
                poison_null=False):
    """Random paged-decode inputs on the card: pages scattered over the
    pool, table entries past each length on the null page 0; a length past
    the table (maxp * page) sees the table's last keys."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_pages = 1 + b * maxp
    q = torch.randn((b, hkv * g, d), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((hkv, n_pages, page, d), generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn((hkv, n_pages, page, d), generator=gen,
                     device="cuda").to(dtype)
    if poison_null:
        kp[:, 0] = 1e4
        vp[:, 0] = 1e4
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    tables = torch.zeros((b, maxp), dtype=torch.int32, device="cuda")
    for i, n in enumerate(lengths):
        used = min(-(-n // page), maxp)
        tables[i, :used] = perm[i * maxp:i * maxp + used].to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, lens


def time_ms(torch, fn, flush, reps: int) -> float:
    """Mean device time of fn over reps launches, L2 flushed before each
    (the serving path finds each layer's pool cold)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def decode_bound(q, kp, tables, lengths, window):
    """Least time for the call: bytes it must move (visible K/V, q, out,
    lengths, the visible pages' table entries) over HBM bandwidth, against
    its 4 flops per (query head, visible key, dim) over peak."""
    hq, d = q.shape[1], q.shape[2]
    hkv, _, page, _ = kp.shape
    vis = [min(n, window) if window else n for n in lengths.tolist()]
    kv_bytes = 2 * sum(vis) * hkv * d * kp.element_size()
    pages = sum(-(-n // page) for n in vis)
    nbytes = (kv_bytes + 2 * q.numel() * q.element_size()
              + 4 * (lengths.numel() + pages))
    flops = 4 * sum(vis) * hq * d
    peak = BF16_FLOPS if kp.element_size() == 2 else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def bf16_ulp(torch, x):
    """One bf16 ulp at |x| (8 significant bits)."""
    a = x.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def check(torch, label, out_k, out_p, dtype):
    """Holds the kernel's output against the plain version's, per element:
    fp32 within FP32_TOL, bf16 within BF16_ULPS ulps of the larger of the
    two values plus FP32_TOL.  Returns (max |diff|, the largest share of
    its element's bf16 limit, or None for fp32)."""
    k, p = out_k.float(), out_p.float()
    diff = (k - p).abs()
    err = diff.max().item()
    if not torch.isfinite(k).all():
        fail(f"{label}: the kernel gave a value that is not finite")
    if dtype == torch.float32:
        if err > FP32_TOL:
            fail(f"{label}: max|diff| {err:.3e} > {FP32_TOL}")
        return err, None
    ulp = bf16_ulp(torch, torch.maximum(k.abs(), p.abs()))
    share = (diff / (BF16_ULPS * ulp + FP32_TOL)).max().item()
    if share > 1.0:
        fail(f"{label}: an element's |diff| is {share:.2f} x its limit of "
             f"{BF16_ULPS} bf16 ulps + {FP32_TOL} (max abs {err:.3e})")
    return err, share


def phase_kernel(torch, kops, kref):
    # small fp32 cases: lengths 0, 1, a page boundary, several tiles and
    # pages, a full table (128) and one past it; windows that start inside
    # a page and span one or several 32-key tiles
    lengths = [0, 1, 8, 33, 64, 100, 128, 130]
    small = decode_case(torch, b=8, hkv=2, g=3, d=32, page=8, maxp=16,
                        lengths=lengths, dtype=torch.float32, seed=1,
                        poison_null=True)
    for window in (5, 40, 0):
        out_k = kops.flash_decode(*small, window=window, impl="kernel")
        out_p = kops.flash_decode(*small, window=window, impl="plain")
        torch.cuda.synchronize()
        err, _ = check(torch, f"fp32 small window {window}", out_k, out_p,
                       torch.float32)
        if out_k[0].abs().max().item() != 0.0:
            fail("lengths == 0 did not give zeros")
        print(f"phase 3 kernel small fp32 (B8 G3 D32 page8 maxp16 window"
              f"{window} lengths {lengths}): max_abs_err={err:.3e} "
              f"tol={FP32_TOL}")

    # the serving shape: starcoder2-15b decode, 8 slots; fp32, then the
    # bf16 pool and query of the main path
    window, page, maxp = 4096, 16, 272
    lengths = [0, 1, 16, 1000, 2047, 4096, 4150, 4200]
    shape = dict(b=8, hkv=4, g=12, d=128, page=page, maxp=maxp,
                 lengths=lengths)
    case32 = decode_case(torch, **shape, dtype=torch.float32, seed=2)
    out_k = kops.flash_decode(*case32, window=window, impl="kernel")
    out_p = kops.flash_decode(*case32, window=window, impl="plain")
    torch.cuda.synchronize()
    err32, _ = check(torch, "fp32 serving shape", out_k, out_p,
                     torch.float32)
    print(f"phase 3 kernel serving fp32 (B8 Hq48 Hkv4 D128 page16 maxp272 "
          f"window4096 lengths {lengths}): max_abs_err={err32:.3e} "
          f"tol={FP32_TOL}")
    del case32, out_k, out_p

    case = decode_case(torch, **shape, dtype=torch.bfloat16, seed=2)
    q, kp, vp, tables, lens = case
    out_k = kops.flash_decode(*case, window=window, impl="kernel")
    out_p = kops.flash_decode(*case, window=window, impl="plain")
    torch.cuda.synchronize()
    err, share = check(torch, "bf16 serving shape", out_k, out_p,
                       torch.bfloat16)

    # library yardstick: SDPA over the gathered dense K/V (not in the port)
    import torch.nn.functional as F
    kd = kref.gather_pages(kp, tables).permute(0, 2, 1, 3).contiguous()
    vd = kref.gather_pages(vp, tables).permute(0, 2, 1, 3).contiguous()
    t = kd.shape[2]
    kpos = torch.arange(t, device="cuda")[None, :]
    ln = lens.long()[:, None]
    mask = ((kpos < ln) & ((ln - 1 - kpos) < window))[:, None, None, :]
    q4 = q[:, :, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask,
                                              enable_gqa=True)

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    ms = time_ms(torch, lambda: kops.flash_decode(
        *case, window=window, impl="kernel"), flush, 50)
    plain_ms = time_ms(torch, lambda: kops.flash_decode(
        *case, window=window, impl="plain"), flush, 20)
    library_ms = time_ms(torch, sdpa, flush, 50)
    bound_ms, bound_by, nbytes = decode_bound(q, kp, tables, lens, window)
    print(f"phase 3 kernel serving bf16 (B8 Hq48 Hkv4 D128 page16 maxp272 "
          f"window4096 lengths {lengths}): max_abs_err={err:.3e} "
          f"limit_share={share:.3f} (limit {BF16_ULPS} ulps + {FP32_TOL}) "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} "
          f"({bound_by}, {nbytes} B) ctas={8 * 4}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


# --------------------------------------------------------------------- #
# phase 4: full-width serving


def phase_serve(torch, np):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import flash_decode as fd_kernel
    from repro_torch.models import build
    from repro_torch.serve import GenerationConfig, PagedServeEngine

    cfg = get_config("starcoder2-15b")
    t0 = time.perf_counter()
    bundle = build(cfg, param_dtype=torch.bfloat16,
                   cache_dtype=torch.bfloat16, device="cuda")
    params = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    init_s = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    plens = [int(n) for n in rng.integers(512, 4065, size=12)]
    budgets = [int(n) for n in rng.integers(32, 129, size=12)]
    plens[0], budgets[0] = 4064, 128      # decode runs past position 4096
    reqs = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in plens]
    max_len = max(p + n for p, n in zip(plens, budgets))
    engine = PagedServeEngine(
        bundle, params, slots=8, page_size=16, max_len=max_len,
        prefill_chunk=256, cache_dtype=torch.bfloat16,
        gen=GenerationConfig(max_new_tokens=128))

    decode_ms, prefill_ms = [], []

    def timed(fn, sink):
        def run(*a, **k):
            torch.cuda.synchronize()
            s = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            sink.append((time.perf_counter() - s) * 1e3)
            return out
        return run

    engine._decode = timed(engine._decode, decode_ms)
    engine._prefill_chunk = timed(engine._prefill_chunk, prefill_ms)
    torch.cuda.reset_peak_memory_stats()
    fd_kernel.launches = 0
    t0 = time.perf_counter()
    results = engine.serve_queue(reqs, max_new=budgets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fd_kernel.launches

    steps = engine.decode_calls
    if launches != cfg.n_layers * steps or steps == 0:
        fail(f"flash_decode launches {launches} != {cfg.n_layers} x "
             f"{steps} decode steps")
    if [r.request_id for r in results] != list(range(len(reqs))):
        fail("not every request was answered in order")
    for r, n in zip(results, budgets):
        if r.steps != n or not ((r.tokens >= 0).all()
                                and (r.tokens < cfg.vocab_size).all()):
            fail(f"request {r.request_id}: {r.steps} tokens (budget {n}) "
                 f"or a token outside [0, {cfg.vocab_size})")
    reach = max(p + r.steps for p, r in zip(plens, results))
    if reach <= cfg.sliding_window:
        fail(f"no request went past the window ({reach} tokens)")
    tokens = sum(r.steps for r in results)
    s = engine.steady_state_summary()
    print(f"phase 4 serve starcoder2-15b full width bf16 "
          f"({n_params} params, init {init_s:.1f}s): requests={len(results)} "
          f"tokens={tokens} wall_s={wall:.3f} tokens_per_s={tokens / wall:.2f} "
          f"decode_steps={steps} decode_ms_median="
          f"{statistics.median(decode_ms):.3f} prefill_chunks="
          f"{len(prefill_ms)} prefill_ms_median="
          f"{statistics.median(prefill_ms):.3f} peak_mem_gib="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"peak_pages_in_use={s['peak_pages_in_use']}/{s['pool_pages']} "
          f"refill_events={s['refill_events']} kernel_launches={launches} "
          f"longest_seq={reach}")
    return cfg, bundle, params, engine, launches


def decode_state(torch, np, cfg, engine):
    """A decode step's inputs on the served pool: 8 slots, one inactive,
    lengths up to 4150 (the window bites in the longest)."""
    slots, maxp = engine.slots, engine.max_pages_per_seq
    tables = (torch.arange(slots * maxp, dtype=torch.int32, device="cuda")
              .reshape(slots, maxp) + 1)
    lengths = torch.tensor([4150, 4100, 0, 3000, 1500, 700, 31, 4000],
                           dtype=torch.int32, device="cuda")
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=slots), dtype=torch.int32, device="cuda")
    return toks, tables, lengths, lengths > 0


def phase_profile(torch, np, cfg, params, engine):
    """Device time of a decode step by kernel class (torch.profiler,
    CUPTI), and the share of an unprofiled step's wall time that the card
    sat idle: 1 - device ms / wall ms."""
    from torch.profiler import ProfilerActivity, profile
    toks, tables, lengths, active = decode_state(torch, np, cfg, engine)
    step = lambda: engine.bundle.decode_step_paged(  # noqa: E731
        params, toks, engine.pages, tables, lengths, active)
    n = 5
    with torch.no_grad():
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            prof_wall_us = (time.perf_counter() - t0) * 1e6
    by = {"flash_decode": 0.0, "gemm": 0.0, "other": 0.0}
    kernels = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0))
        # device-side events only: an op's CPU event may carry its
        # kernels' time as well
        if dev <= 0 or "CUDA" not in str(getattr(ev, "device_type", "CUDA")):
            continue
        kernels.append((dev, ev.key))
        name = ev.key.lower()
        if "flash_decode" in name:
            by["flash_decode"] += dev
        elif any(k in name for k in ("gemm", "gemv", "cutlass", "sm90_",
                                     "cublas", "matmul", "nvjet")):
            by["gemm"] += dev
        else:
            by["other"] += dev
    busy = sum(by.values())
    if busy <= 0:
        print("phase 4b profile: the profiler saw no device time "
              "(device breakdown not measured)")
        return
    # one stream: its kernels cannot add up to more than the run's wall
    if busy > prof_wall_us:
        fail(f"profiled device time {busy:.0f} us exceeds the profiled "
             f"wall {prof_wall_us:.0f} us: events counted twice")
    print(f"phase 4b profile ({n} decode steps, 7 active slots, lengths to "
          f"4150): wall_ms_per_step={wall_us / n / 1e3:.3f} "
          f"device_ms_per_step={busy / n / 1e3:.3f} "
          f"idle_share={1 - busy / wall_us:.3f} "
          f"profiled_wall_ms_per_step={prof_wall_us / n / 1e3:.3f} "
          + " ".join(f"{k}_ms={v / n / 1e3:.3f} ({v / busy:.3f})"
                     for k, v in by.items()))
    top = sorted(kernels, reverse=True)[:6]
    print("phase 4b top device ops (ms per step): " + " | ".join(
        f"{k[:60]} {v / n / 1e3:.3f}" for v, k in top))


def phase_logits(torch, np, cfg, params, engine):
    """One decode step on the served pool, through the kernel and through
    the plain version, at depths 10, 20 and all 40 layers (the first L
    layers of the model and pool, then the final norm and unembedding).
    Each run writes this step's K/V at the same positions before it reads
    them, so every run sees the pool it wrote itself.

    Two controls, plain against plain with a wrong window (one page short,
    and none), must exceed the limit: they show that it fails an
    attention that is wrong on 16 to 55 of some 4100 keys of two slots."""
    import dataclasses

    from repro_torch.models import build

    def bundle(impl, window):
        return build(dataclasses.replace(cfg, sliding_window=window),
                     param_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
                     decode_impl=impl, device="cuda")

    toks, tables, lengths, active = decode_state(torch, np, cfg, engine)

    def logits(b, depth):
        with torch.no_grad():
            out, _ = b.decode_step_paged(params, toks, engine.pages[:depth],
                                         tables, lengths, active)
        return out.float()

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    w = cfg.sliding_window
    kern, plain = engine.bundle, bundle("plain", w)
    sound = {}
    for depth in (10, 20, cfg.n_layers):
        sound[depth] = rel(logits(kern, depth), logits(plain, depth))
    ref = logits(plain, cfg.n_layers)
    controls = {
        "window_one_page_short": rel(
            logits(bundle("plain", w - engine.page_size), cfg.n_layers), ref),
        "no_window": rel(logits(bundle("plain", 0), cfg.n_layers), ref)}
    torch.cuda.synchronize()
    full = sound[cfg.n_layers]
    if not math.isfinite(full) or full > LOGIT_REL_TOL:
        fail(f"decode logits kernel vs plain max|diff| / max|logit| "
             f"{full:.4e} > {LOGIT_REL_TOL}")
    for k, v in controls.items():
        if not v > LOGIT_REL_TOL:
            fail(f"control {k} reads {v:.4e} <= {LOGIT_REL_TOL}: the logits "
                 f"limit would not fail that fault")
    print(f"phase 5 logits kernel vs plain (one decode step, 8 slots, one "
          f"inactive; max|diff| / max|logit|): "
          + " ".join(f"layers{d}={v:.4e}" for d, v in sound.items())
          + f" tol={LOGIT_REL_TOL} controls (plain vs plain, 40 layers): "
          + " ".join(f"{k}={v:.4e}" for k, v in controls.items()))


# --------------------------------------------------------------------- #
# phase 6: topk_compress against plain


def resnet18_leaf_sizes(torch):
    """Per-learner sizes of ResNet-18's 55 leaves at width 64, in the
    reference's leaf order (shapes only, on the meta device)."""
    from repro_torch.configs.resnet18_cifar import CNNConfig
    from repro_torch.models.resnet import resnet_init
    from repro_torch.tree import leaves
    return [p.numel() for p in leaves(
        resnet_init(None, CNNConfig(width=64), device="meta"))]


def same_bits(torch, a, b) -> bool:
    """Equal bit for bit (so -0.0 differs from +0.0)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.view(view), b.view(view))


def phase_topk(torch):
    from repro_torch.comm.sparse import TopKReducer
    from repro_torch.kernels import ops as kops
    k_for = TopKReducer(TOPK_RATIO).k_for
    gen = torch.Generator(device="cuda").manual_seed(6)

    def randn(rows, n):
        return torch.randn((rows, n), generator=gen, device="cuda")

    sizes = resnet18_leaf_sizes(torch)
    cases = [(f"fp32 n{n}", randn(TOPK_ROWS, n), k_for(n))
             for n in sorted(set(sizes))]
    cases += [("k=1", randn(TOPK_ROWS, 5120), 1),
              ("k=n", randn(TOPK_ROWS, 5120), 5120),
              ("bf16 ties", (randn(TOPK_ROWS, 36864) * 2).round()
               .to(torch.bfloat16), k_for(36864)),
              ("all zero", torch.zeros((TOPK_ROWS, 8192), device="cuda"),
               k_for(8192))]
    ones = torch.sign(randn(TOPK_ROWS, 73728))
    ones[:, 40000] = 1e8
    cases.append(("+-1 and 1e8", ones, k_for(73728)))
    signed = torch.where(torch.rand((TOPK_ROWS, 5120), generator=gen,
                                    device="cuda") < 0.5, -0.0, 0.0)
    signed[:, ::9] = -torch.rand((TOPK_ROWS, len(range(0, 5120, 9))),
                                 generator=gen, device="cuda") - 0.5
    cases.append(("negatives and -0.0", signed, 700))
    cases.append(("subnormals", randn(TOPK_ROWS, 5120) * 1e-40, 256))
    big_n = 2 ** 24 + 3
    big = randn(2, big_n)
    big[:, 2 ** 24 + 1] = 1e3              # past 2^24: an fp32 index rounds
    cases.append(("rows 2 n 2^24+3", big, k_for(big_n)))
    t0 = time.perf_counter()
    worst = 0.0
    for label, x, k in cases:
        v, i = kops.topk_compress(x, k, impl="kernel")
        vp, ip = kops.topk_compress(x, k, impl="plain")
        torch.cuda.synchronize()
        if not torch.equal(i, ip):
            bad = (i != ip).nonzero()[:4].tolist()
            fail(f"topk {label} (rows {x.shape[0]} n {x.shape[1]} k {k}): "
                 f"indices differ from the plain version at {bad}")
        if not same_bits(torch, v, vp):
            fail(f"topk {label}: values differ from the plain version "
                 f"in their bits")
        worst = max(worst, (v.float() - vp.float()).abs().max().item())
    if int(cases[-1][1].shape[1]) != big_n or \
            2 ** 24 + 1 not in i[0].tolist():
        fail("topk: the row past 2^24 did not select its outlier there")
    check_s = time.perf_counter() - t0
    del cases, big, ones, signed, v, i, vp, ip

    # one global fire: the 55 leaves of ResNet-18, 16 learner rows each
    fire = [(randn(TOPK_ROWS, n), k_for(n)) for n in sizes]
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def fire_ms(fn, reps):
        fn(*fire[0])
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            for x, k in fire:
                total += time_ms(torch, lambda: fn(x, k), flush, 1)
        return total / reps

    ms = fire_ms(lambda x, k: kops.topk_compress(x, k, impl="kernel"), 5)
    plain_ms = fire_ms(lambda x, k: kops.topk_compress(x, k, impl="plain"),
                       2)
    library_ms = fire_ms(lambda x, k: torch.topk(x.abs(), k, sorted=False),
                         5)
    nbytes = sum(x.numel() * x.element_size() + k * x.shape[0] * (
        x.element_size() + 4) for x, k in fire)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"phase 6 topk: the {len(set(sizes))} leaf sizes of ResNet-18 "
          f"checked bit for bit at rows {TOPK_ROWS}, plus k=1, k=n, "
          f"bf16 ties, all zero, +-1 and 1e8, negatives and -0.0, "
          f"subnormals, rows 2 n 2^24+3 in {check_s:.2f}s: "
          f"max_abs_err={worst:.3e}; one global fire ({len(fire)} launches, "
          f"L2 flushed before each): ms={ms:.4f} "
          f"ms_per_launch={ms / len(fire):.4f} plain_ms={plain_ms:.4f} "
          f"torch_topk_ms={library_ms:.4f} (torch.topk(|x|, k, "
          f"sorted=False) leaves the tie order unspecified) "
          f"bound_ms={bound_ms:.4f} (bytes, {nbytes} B)")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes"}


# --------------------------------------------------------------------- #
# phase 7: full-width Hier-AVG training


def trace_kernels(prof, path):
    """The device kernels of a torch.profiler run, from its Chrome trace:
    (name, start us, duration us, stream) each."""
    prof.export_chrome_trace(path)
    with gzip.open(path, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    return [(e["name"], float(e["ts"]), float(e["dur"]),
             e.get("args", {}).get("stream"))
            for e in events
            if e.get("ph") == "X" and str(e.get("cat", "")).lower() == "kernel"]


def busy_us(kernels) -> float:
    """Time at least one kernel ran: the union of their intervals."""
    total, end = 0.0, -1.0
    for _, ts, dur, _ in sorted(kernels, key=lambda k: k[1]):
        if ts + dur > end:
            total += ts + dur - max(ts, end)
            end = ts + dur
    return total


TRAIN_CLASSES = (
    ("topk_compress", ("topk_",)),
    ("conv_backward", ("dgrad", "wgrad")),
    ("conv_forward", ("fprop",)),
    ("cudnn_transpose", ("transpose",)),
    ("cudnn_other", ("cudnn", "xmma", "implicit", "winograd", "fft")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("reduce", ("reduce",)),
)


def by_class(kernels, classes):
    """Summed kernel time per class (first matching substring wins)."""
    by = {name: 0.0 for name, _ in classes}
    by["other"] = 0.0
    for name, _, dur, _ in kernels:
        low = name.lower()
        for cls, keys in classes:
            if any(k in low for k in keys):
                by[cls] += dur
                break
        else:
            by["other"] += dur
    return by


def phase_train(torch):
    import dataclasses

    from repro_torch.comm import reduce_with
    from repro_torch.comm.sparse import TopKReducer
    from repro_torch.configs.base import HierAvgParams
    from repro_torch.configs.resnet18_cifar import CNNConfig
    from repro_torch.convert import train_state_from_jax, train_state_to_numpy
    from repro_torch.core.hier_avg import make_hier_round, make_sgd_step
    from repro_torch.core.plan import ReductionPlan
    from repro_torch.core.simulator import Simulator
    from repro_torch.core.topology import HierTopology, average_over
    from repro_torch.data.synthetic import make_classification_task
    from repro_torch.kernels.topk_compress import topk_compress as tk
    from repro_torch.models.resnet import resnet_init, resnet_loss
    from repro_torch.optim import sgd
    from repro_torch.tree import leaves

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = CNNConfig(width=64)
    topo = HierTopology(1, 4, 4)
    hier = HierAvgParams(plan=TRAIN_PLAN, bucket_bytes=0)
    task = make_classification_task(32 * 32 * 3, cfg.n_classes,
                                    device="cuda")

    def sample(gen, n):
        b = task(gen, n)
        return {"x": b["x"].reshape(n, 32, 32, 3), "y": b["y"]}

    def loss_fn(p, b):
        return resnet_loss(p, b, cfg)

    eval_batch = sample(torch.Generator(device="cuda").manual_seed(1), 512)
    sim = Simulator(loss_fn, lambda g: resnet_init(g, cfg, device="cuda"),
                    sample, topo=topo, hier=hier, optimizer=sgd(0.1),
                    per_learner_batch=32, eval_batch=eval_batch, seed=0,
                    device="cuda")
    walls = []
    round_fn = sim.round_fn

    def timed_round(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = round_fn(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        return out

    sim.round_fn = timed_round
    torch.cuda.reset_peak_memory_stats()
    tk.launches = 0
    t0 = time.perf_counter()
    res = sim.run(TRAIN_ROUNDS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = tk.launches
    n_leaves = len(leaves(res.state.params))
    n_params = sum(p[0, 0, 0].numel() for p in leaves(res.state.params))
    if launches != n_leaves * TRAIN_ROUNDS:
        fail(f"topk_compress launches {launches} != {n_leaves} leaves x "
             f"{TRAIN_ROUNDS} global fires")
    for name in ("losses", "eval_losses", "eval_accs", "grad_sq_norms"):
        if not np_isfinite(getattr(res, name)):
            fail(f"training {name} not finite: {getattr(res, name)}")
    if not res.eval_losses[-1] < res.eval_losses[0]:
        fail(f"eval loss did not fall: {res.eval_losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # the parts of a round, each across a synchronize: one SGD step on all
    # learners, one local mean, one global top-k reduction
    round_batch = sim._round_batch(torch.Generator(device="cuda")
                                   .manual_seed(7))
    step_batch = {k: v[0, 0] for k, v in round_batch.items()}
    step = make_sgd_step(loss_fn, sgd(0.1))
    plan = ReductionPlan.parse(TRAIN_PLAN)
    red = plan.levels[-1].reducer

    def wall_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    step_ms = wall_ms(lambda: step(res.state, step_batch))
    local_ms = wall_ms(lambda: average_over(res.state.params, (2,)))
    global_ms = wall_ms(lambda: reduce_with(
        red, lambda t, cf=None: average_over(t, (0, 1, 2)),
        res.state.params, res.state.comm_state["global"]))
    print(f"phase 7 train resnet18 width 64 ({n_params} params per learner, "
          f"{n_leaves} leaves) P={topo.n_learners} {topo.shape} plan "
          f"{sim.plan.describe()} sgd(0.1) 32 per learner per step: "
          f"rounds={TRAIN_ROUNDS} in {run_s:.2f}s train_loss="
          f"{fmt(res.losses)} eval_loss={fmt(res.eval_losses)} eval_acc="
          f"{fmt(res.eval_accs)} round_wall_ms={fmt(walls)} "
          f"step_wall_ms={step_ms:.3f} local_mean_ms={local_ms:.3f} "
          f"global_topk_reduction_ms={global_ms:.3f} peak_mem_gib="
          f"{peak:.2f} topk_launches={launches}")

    # kernel against plain, through the whole trainer: 2 rounds from one
    # converted state on the same batches
    np_state = train_state_to_numpy(res.state)
    gen = torch.Generator(device="cuda").manual_seed(8)
    batches = [sim._round_batch(gen) for _ in range(2)]
    plain_plan = ReductionPlan(plan.levels[:-1] + (dataclasses.replace(
        plan.levels[-1], reducer=TopKReducer(TOPK_RATIO, impl="plain")),))
    runs = {}
    for impl, p in (("kernel", plan), ("plain", plain_plan)):
        rnd = make_hier_round(loss_fn, sgd(0.1), hier, plan=p)
        state = train_state_from_jax(np_state, device="cuda")
        losses = []
        for b in batches:
            state, m = rnd(state, b)
            losses.append(m["loss"])
        runs[impl] = (state, torch.stack(losses))
        del state
    (sk, lk), (sp, lp) = runs["kernel"], runs["plain"]
    ef_k, ef_p = sk.comm_state["global"], sp.comm_state["global"]
    pairs = (list(zip(leaves(sk.params), leaves(sp.params)))
             + list(zip(leaves(ef_k.err), leaves(ef_p.err)))
             + list(zip(leaves(ef_k.ref), leaves(ef_p.ref))))
    differ = sum(not same_bits(torch, a, b) for a, b in pairs)
    if differ or not same_bits(torch, lk, lp):
        fail(f"kernel and plain top-k trajectories differ: {differ} of "
             f"{len(pairs)} params/err/ref leaves, losses {lk.tolist()} vs "
             f"{lp.tolist()}")
    print(f"phase 7 kernel vs plain top-k: 2 rounds from one converted "
          f"state, {len(pairs)} params/err/ref leaves and the losses "
          f"{fmt(lk.tolist())} bit-identical")
    del runs, sk, sp, ef_k, ef_p, pairs, np_state

    # where a round's device time goes; idle share against the wall of an
    # unprofiled round
    from torch.profiler import ProfilerActivity, profile
    state = res.state
    batch = batches[0]
    rnd = make_hier_round(loss_fn, sgd(0.1), hier)
    rnd(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rnd(state, batch)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rnd(state, batch)
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        kernels = trace_kernels(prof, os.path.join(tmp, "round.json.gz"))
    if not kernels:
        print("phase 7 profile: the profiler saw no device time "
              "(device breakdown not measured)")
        return launches
    busy = busy_us(kernels)
    by = by_class(kernels, TRAIN_CLASSES)
    summed = sum(by.values())
    streams = sorted({str(k[3]) for k in kernels})
    print(f"phase 7 profile (one round, 8 steps + 4 local means + 1 global "
          f"top-k; {len(kernels)} kernels on streams {streams}): "
          f"wall_ms={wall_us / 1e3:.3f} profiled_wall_ms="
          f"{prof_wall_us / 1e3:.3f} device_busy_ms={busy / 1e3:.3f} "
          f"kernel_sum_ms={summed / 1e3:.3f} idle_share="
          f"{1 - busy / wall_us:.3f} "
          + " ".join(f"{k}_ms={v / 1e3:.3f} ({v / summed:.3f})"
                     for k, v in by.items()))
    totals = {}
    for name, _, dur, _ in kernels:
        totals[name] = totals.get(name, 0.0) + dur
    top = sorted(((v, k) for k, v in totals.items()), reverse=True)[:8]
    print("phase 7 top device kernels (ms per round): " + " | ".join(
        f"{k[:70]} {v / 1e3:.3f}" for v, k in top))
    return launches


def np_isfinite(a) -> bool:
    import numpy as np
    return bool(np.isfinite(np.asarray(a)).all())


def fmt(xs) -> str:
    return "[" + ",".join(f"{float(x):.4f}" for x in xs) + "]"



def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke runs on a card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, SRC)
    import numpy as np

    # phase 1: device
    smi = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {name} x{torch.cuda.device_count()}")

    # phase 2: build (every source at once, one nvcc each)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    build_s = time.perf_counter() - t0
    parts = []
    for src in SOURCES:
        secs, log = _build.BUILD_LOG.get(src, (0.0, "(cached build)"))
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        parts.append(f"{src}.cu {secs:.2f}s, {len(ptxas)} kernels: "
                     + " | ".join(ptxas[:3]))
    print(f"phase 2 build: {len(SOURCES)} sources in {build_s:.2f}s; "
          + "; ".join(parts))

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    kern = phase_kernel(torch, kops, kref)
    cfg, _, params, engine, launches = phase_serve(torch, np)
    phase_profile(torch, np, cfg, params, engine)
    phase_logits(torch, np, cfg, params, engine)
    del cfg, params, engine, _
    torch.cuda.empty_cache()

    topk = phase_topk(torch)
    topk_launches = phase_train(torch)

    record = {"kernels": [{
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:45",
        "launches": launches, **kern}, {
        "name": "topk_compress", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/topk_compress.cu",
        "replaces": "src/repro/kernels/topk_compress.py:175",
        "launches": topk_launches, **topk}]}
    print(smi_line())
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
