#!/usr/bin/env python3
"""On-card smoke of the PyTorch port on one NVIDIA GPU: paged serving of
StarCoder2-15B at full width through the hand-written flash-decode kernel,
Hier-AVG training of ResNet-18 at full width with a sparse top-k global
reduction through the hand-written top-k kernel, then with the compressed
reductions (qint8, PowerSGD) on the bucket engine through the hand-written
qint8 pack/unpack and batched-QR kernels, and Hier-AVG training of the
RWKV-6 and dense GQA language models at full width through the
hand-written WKV6 and flash-attention kernels, forward and backward, and
of the MoE/MLA and M-RoPE decoders in bf16 (with remat) through the
attention and top-k kernels; then serving of every trained family: the
dense wave engine on StarCoder2-15B (its prefill through the attention
kernel), RWKV-6 1.6B (its prefill through the WKV kernel, whose final
state the decode carries on) and DeepSeek-V2-Lite's MLA and MoE on the
paged engine; the Hymba hybrid (Mamba scan + sliding-window attention)
and the SeamlessM4T-style encoder-decoder, each trained under Hier-AVG
through the attention and top-k kernels and served; then Hier-AVG on
gloo ranks sharing the card, with the
telemetry statistics taken across them, the autotune loop (the probe
through the top-k, qint8 and QR kernels, the fit, the bill of the
measured fires, --autotune) and the launcher under torchrun.

  python3 chip_smoke.py            # from the root of a checkout, one card

Phases (each prints one line of numbers; any failure exits non-zero):
  1. device   card name and power limit (nvidia-smi), torch/CUDA versions
  2. build    nvcc builds the six csrc/*.cu sources (SOURCES) for sm_90a,
              one process each, all at once (seconds, ptxas)
  3. kernel   flash_decode (split-K: a split kernel and its combine)
              against its plain PyTorch version on the card, at small fp32
              shapes (three windows, several tiles and pages, one- and
              three-page splits), on every code path (tensor-core path at
              D 32-256 and 1-8 warp groups, CUDA-core path for the mixed
              dtype pairs), at split boundaries in fp32 and bf16 (lengths
              SK-1, SK, SK+1, 2SK+1, a window inside a split, all empty, one
              long slot and seven empty, all at 4096 keys; one-page splits
              and the plain split decomposition too) and at the serving
              shape in fp32 (with a control that drops the key at a split
              boundary and must fail the limit) and in bf16, with the
              kernel's, the plain version's and SDPA's times, the bound, the
              grid, a split-size sweep, and the all-4096 case's time
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
  4c. dense   the same weights through ServeEngine: 4 prompts of 2048
              tokens in one wave, 32 new tokens each; exactly 40 bf16
              flash_attention forwards (window 4096) in the prefill; its
              last-position logits kernel vs plain within DENSE_LOGIT_TOL,
              a control with the window four pages short outside it; the
              same requests through phase 4's paged engine (greedy
              agreement); the attention forward at [4, 2048, 48/4, 128]
              against plain, SDPA and the bound
  5b. logits mean  phase 5 averaged over 4 steps x 8 slots, all past the
              window: mean relative L2 within LOGIT_MEAN_TOL, the
              one-page-short window control outside it
  6. topk     topk_compress, alone and grouped (topk_compress_many),
              against topk_compress_plain and topk_compress_radix_plain
              (the kernel's decomposition in plain PyTorch), bit for bit
              in values and indices: 16 fp32 rows at every leaf size of
              ResNet-18 (k at ratio 0.05), k = 1, k = n, bf16 ties, all-zero
              rows, +-1 with a 1e8 outlier, signed zeros, subnormals, ties
              whose taken part ends in the first, a middle and the last
              chunk, n = 1..3 mod 4 (fp32) and 1..7 mod 8 (bf16) at
              SMALL_N and past it, 2 rows of 2^24 + 3, candidate caps 0
              and 1, and one grouped call per dtype mixing small and large
              segments at rows 1, 2, 4 and 16; a build without eq_before in
              the look-back must differ; then one ResNet-18 fire (55
              leaves) as one grouped call and per leaf, against the parent
              design's way (55 calls), the plain version, torch.topk and
              the bound, its launches read from a profiler trace; and one
              rwkv6-1.6b fire at phase 12's size (25 leaves x 4 rows,
              7.85 GB) in the reducer's 1 GiB groups, each leaf held to
              plain, against torch.topk and the bound
  7. train    Simulator: ResNet-18 at width 64 (11,172,160 params per
              learner, fp32), P = 16 learners as (1, 4, 4), plan
              local@2/global@8:topk:0.05 per leaf, sgd(0.1), 32 examples
              per learner per step of the seeded Gaussian-mixture task as
              32x32x3 images, 3 rounds: per-round losses, walls, peak
              memory, and 165 top-k launches (55 leaves x 3 fires, one
              grouped call a fire, at most TOPK_LAUNCHES_PER_FIRE kernels
              a fire in the profiled round's trace); then
              2 rounds from one converted state with the kernel and with
              the plain top-k, which must agree bit for bit; then one
              profiled round by kernel class, idle share against an
              unprofiled round's wall
  8. codecs   qint8_pack/unpack against their plain versions bit for bit
              (every leaf size of ResNet-18 at 16 rows, the bucket row
              [16, 2359296], blocks 255 and 128, bf16 input, ties, zeros,
              signed zeros, subnormals, 1e30), and the time of one local
              qint8 fire (10 + 10 launches) against the plain versions and
              the bound; batched_qr (phase_qr) against its plain version
              (raw Q within QR_TOL), against batched_qr_blocked_plain (its
              arithmetic emulated from the same plan, within QR_EMU_ULPS,
              with a control on another schedule that must fail it) and
              torch.linalg.qr (projector, orthonormality) at [16,3,2],
              [16,512,2], [16,1536,1..8], [4,65536,8] (in device memory),
              r 12 and 20 (shared memory) and the panels of one ResNet-18
              and one rwkv6-1.6b per-leaf fire ([4,65536,2] on a cluster);
              grouped calls against single calls bit for bit; a zero
              column, and a panel of condition 1e6 on which a one-pass
              control must fail; times, each launch after an L2 flush and
              a LONG_SLEEP_CYCLES sleep, of (i) the Pipelined PowerSGD
              fire's 10 calls of [16,1536,2], (ii) the same 10 buckets in
              one call, (iii) the ResNet-18 and (iv) the rwkv6 per-leaf
              fire in one call each, (v) [4,65536,2] alone, against
              torch.linalg.qr and the bounds
  9. codecs train  as phase 7 under the default bucketing (4 MiB,
              pipelined, 10 uniform buckets per level), plan A
              local@2:qint8/global@8:topk:0.05 (120 pack, 120 unpack and
              30 top-k launches; kernel vs plain bit for bit; bucketed and
              per-leaf mean/cast bit for bit on the full-width state) and
              plan B local@2/global@8:powersgd:2:bucketed (30 QR launches;
              kernel vs plain losses and params within PSGD_LOSS_TOL and
              PSGD_PARAM_TOL, a control QR without projection outside
              them; the panels' singular-value ratios, an fp64 QR on the
              same panels and an fp64-QR trajectory as witnesses of the
              drift) and plan C local@2/global@8:powersgd:2 per leaf (54
              QR segments in 3 grouped calls; kernel vs plain and the
              control as in plan B); round parts, peak memory and a
              profiled round each
  10. wkv     the WKV6 forward and backward kernels against their plain
              versions (y, the final state, the checkpoints and all six
              gradients within KERN_REL_TOL) at the training shape (B 8,
              S 512, H 32, D 64, fp32, w in [0.05, 0.999], nonzero s0
              and dS_T), at S 64, 192 and 130 (D 32) and in bf16, and the
              backward against rwkv6_wkv_backward_blocked_plain (its
              schedule in plain PyTorch) under the same limits; three
              controls (y and dk with the bonus u dropped, dr and dw read
              with S_{t+1} for S_t) must fail the limit; a rerun gives the
              same bits; times against the bound and the plain versions
              (the backward's 10 readings each), and the backward's
              device-memory bytes beyond inputs, outputs and checkpoints
  11. attention  the tensor-core attention forward and backward kernels
              against their plain versions (o, lse, dQ, dK, dV) at B 4,
              S 1024, Hq 48, Hkv 4, D 128 in fp32 and bf16, window 4096 at
              S 8192, groups of 3, 5, 7 and 12 (ragged S in fp32 and
              bf16), and against flash_attention_split_plain (their
              arithmetic emulated) at D 32, 64 and 128 in fp32 (3xTF32)
              and bf16; controls (window one key short, kv head h % Hkv)
              must fail; a rerun gives the same bits; times against the
              bound, the plain versions, SDPA and the backward of one SDPA
              call
  12. rwkv    rwkv6-1.6b at full width, RWKV_TRAIN_LAYERS (2) of 24
              layers, random init from
              seed 0, P = 4 as (1, 2, 2), plan local@2/global@8:topk:0.05
              per leaf, sgd(0.1), 2 x 512 tokens of a 512-token Markov
              chain per learner per step, 3 rounds: losses, eval loss
              (falling), round and part walls, peak memory, exact launch
              counts; the padded default-bucket bytes; 1 round kernel vs
              plain from one state copy within LM_LOSS_TOL /
              LM_PARAM_TOL; a profiled round by kernel class
  13. dense   starcoder2-15b the same way at 1 of 40 layers, default
              HierAvgParams(k1=2, k2=4), 1 x 1024 tokens per learner per
              step; then launch.train.main on the card (reduced rwkv6)
  14. elastic ResNet-18 as in phase 7 (P = 16 as (1, 4, 4), sgd(0.1), 32
              per learner per step) from one converted state: (a) 2
              elastic rounds with all-true masks equal the dense rounds
              bit for bit (params, EF, losses) for the per-leaf plan and
              plan A on the pipelined buckets, and a mask with one learner
              out must differ; (b) TRAIN_ROUNDS rounds of plan A under the
              seeded ELASTIC_FAULTS schedule (its mask sha256 must be the
              reference's), with the kernels and with the plain versions,
              bit for bit, and every absent learner's params and EF bit
              for bit unchanged across a missed fire; (c) the Simulator
              with faults and a MetricsLogger, telemetry off and on, equal
              bit for bit, rows valid; (d) save_elastic_checkpoint at 16
              learners, elastic_restore onto (1, 2, 4), survivors bit for
              bit, one round after it; (e) launch.train.main on the card
              (reduced rwkv6) with --faults --telemetry --metrics-out
              --trace-out --profile-dir --ckpt; walls and peak memory
  15. moe     deepseek-v2-lite-16b at published widths (d 2048, MLA
              kv_lora 512, 64 experts + 2 shared, top-6, vocab 102,400),
              depth 27 -> MOE_LAYERS (the dense first layer and one MoE
              layer), bf16 params (the router fp32), P = 4 as (1, 2, 2),
              HierAvgParams(k1=2, k2=4), 1 x 1024 Markov tokens per
              learner per step, 3 rounds: losses, aux loss, eval loss
              (falling), walls, peak, no kernel launch (MLA attends with
              its own products); 1 round remat off and on from one state
              copy, bit for bit, both peaks; one TopKReducer fire (ratio
              0.05) over the three stacked expert leaves of that round's
              update, kernel and plain bit for bit (3 launches in 3
              calls), and one leaf's delta [4, 184,549,376] against plain,
              torch.topk and the bound; a profiled round and the one-hot
              dispatch/combine products' share of it; launch.train.main
              on the card (reduced deepseek-v2-lite)
  16. vlm     qwen2-vl-2b at published widths (d 1536, 12/2 heads of 128,
              d_ff 8960, tied vocab 151,936, M-RoPE (16, 24, 24)), depth
              28 -> VLM_LAYERS (2), bf16 params, remat, P = 4, plan
              local@2/global@8:topk:0.05 per leaf, 1 x 1024 tokens per
              learner per step (256 stub patch embeddings + 768 Markov
              tokens), 3 rounds: exact launches (attention forward twice
              per layer and step under remat, plus evals; backward once;
              top-k per leaf per global fire); 1 round kernel vs plain
              (attention and top-k) within BF16_LOSS_REL and
              BF16_UPDATE_L2, a control with the labels shifted by one
              outside both; 1 round remat off and on bit for bit, both
              peaks; a profiled round; the bf16 attention kernels at the
              trainer's shape [4, 1024, 12/2, 128] against plain, SDPA
              and the bound
  17. rwkv serve  rwkv6-1.6b at full width, depth 24 ->
              RWKV_SERVE_LAYERS (12), bf16, ServeEngine:
              8 requests of 1024 tokens in two waves of 4, 64 new tokens
              each; exactly 24 WKV forwards (12 layers x 2 prefills, s0 the
              cache's zeros, sT kept for the decode); the prefill's states
              and logits kernel vs plain at fp32 compute within
              RWKV_PLAIN_TOL (control: the bonus u dropped; at bf16,
              printed), continuity prefill + 16 decode steps
              against the longer prefill at fp32 compute within
              RWKV_CONT_TOL (control: the state of a prompt shifted by one
              token); tokens/s, decode step, prefill, peak; the WKV forward
              at [4, 1024, 32, 64] against plain and the bound, with and
              without its checkpoints
  18. mla/moe serve  deepseek-v2-lite-16b at full width, depth 27 ->
              MLA_SERVE_LAYERS (9: one dense layer, 8 MoE), bf16,
              PagedServeEngine (8 slots, pages
              of 16, chunks of 256): 12 requests of 256-2048 tokens,
              budgets 32-64, a slot refilled; tokens/s, decode step,
              peak, one profiled step by class (latent gather, absorbed
              attend, MoE dispatch, expert products, idle share); dense
              against paged at a dropless capacity factor (fp32 compute
              and caches): the first decode step's logits within
              MOE_DENSE_TOL (control: one page short), greedy agreement
  19. ranks   the multi-GPU hierarchy on 4 processes sharing the card, a
              gloo world on CUDA tensors (the phase probes first which
              collectives gloo takes on the card, and fails if it refuses
              one):
              mesh DIST_MESH (pod, group, local, fsdp, model) over the
              (1, 2, 2) grid, so two clusters on two rank pairs, the local
              level inside each rank and fsdp 2; ResNet-18 at width 64, 32
              examples per learner per step; plans DIST_PLANS (bucketed
              top-k, then fused qint8) on the shard-aware buckets (each
              rank's kernels on its own shard's runs, means by
              reduce-scatter + all-gather, the fsdp regather).  Per rank:
              the round's kernel launches, collective counts, kernel ==
              plain and an all-true mask == dense bit for bit; the
              gathered state against the one-process round on the card
              (the same shard-aware layout) within the CPU tests' limits,
              supports equal; one round's wall and, in another, its
              collective seconds by kind; each process's peak memory.
              Telemetry on the ranks (the top-k plan): the statistics
              across ranks equal on every rank, the trajectory bit for bit
              the telemetry-off one, every telemetry/* value within
              TEL_CARD_RTOL of a one-process round in the ranks' grouping
              (each rank's learners' gradients as a group of their own),
              a block-only EF mass (the control) outside it; the round
              wall with telemetry on against off
  21. autotune  the probe on the card in one process: the reference's
              default grid and AUTOTUNE_LADDER (a payload ladder up to
              phase 7's ResNet-18 fire, and top-k, qint8 and PowerSGD at
              that size), launching topk_compress, qint8_pack/unpack and
              batched_qr; the fit of its ICI samples (one card crosses no
              slower link, so slow_bw stays unfitted), the fitted fields
              and the median relative error; the fit's relative error on
              AUTOTUNE_FIRE_POINTS (the device-bound codec points of the
              ladder) within AUTOTUNE_FIRE_RTOL, where the uncalibrated
              model and the fit with its codec rates halved (the
              controls) fall outside it;
              the calibrated bill of phases 7, 9A and 9B's global fires
              against their walls measured above; launch.train.main
              --autotune (reduced rwkv6, 2 rounds): the ranked plans and
              wall_bias, its losses bit for bit those of --plan ranked[0]
  20. torchrun launch.train under torchrun --nproc_per_node 1 with the
              NCCL backend (reduced rwkv6-1.6b), twice: the top-k plan
              local@2/global@4:topk:0.05 with --telemetry (its rows carry
              a positive EF mass of the global level), then --telemetry
              --autotune on phase 21's artifact: the process group, the
              mesh, the ranks' plan check and the per-round all-reduce of
              the metrics run on NCCL; NCCL's multi-rank collectives need
              a machine with several cards
  22. hymba   hymba-1.5b at published widths (d 1600, 25/5 heads of 64,
              d_ff 5504, SSM d_inner 3200 state 16, window 1024, vocab
              32001), depth 32 -> HYMBA_LAYERS (2), fp32, P = 4 as
              (1, 2, 2), plan local@2/global@8:topk:0.05 per leaf, 1 x
              2048 Markov tokens per learner per step (the window masks,
              the scan runs 8 chunks of 256 under remat), 1 round, the
              eval loss falling from the init's: exact launches
              (attention forward per layer and step plus evals, backward
              per layer and step, top-k per leaf per global fire); 1
              round kernel vs plain (attention and top-k) at phases
              12-13's fp32 limits, a control with the labels shifted by
              one position outside both, the control's round profiled
              by class (attention, the scan's addcmul steps,
              GEMMs, elementwise, idle); the SSM heads' share of the round
              (mamba_apply timed alone under vmap(grad)); the attention
              kernels at the training
              shape [4, 2048, 25/5, 64] window 1024 against plain (a
              control one key short of the window), SDPA with a band mask
              and the bound; ServeEngine (fp32): 4 x 2048 prompts, 32
              greedy tokens through the rolling window and the SSM state,
              2 prefill forwards, tokens equal with impl="plain"
  23. seamless  seamless-m4t-large-v2 at published widths (d 1024, 16/16
              heads of 64, d_ff 8192 relu, vocab 256206, 1024 stub
              frames), depth 24 + 24 -> 2 + 2, bf16 params, remat, as 22
              with 1 x 512 tokens per learner per step, 3 rounds and
              the bf16 limits SEAMLESS_LOSS_REL / SEAMLESS_UPDATE_L2
              (tighter than phase 16's, which the shifted-label control
              passes here); the decoder's causal self-attention
              takes the kernel (the encoder's and the cross-attention are
              non-causal: plain, as in the reference), at [4, 512, 16/16,
              64] bf16; ServeEngine (fp32) with the stub frames: 4 x 512
              prompts, 32 greedy tokens, tokens equal with impl="plain"
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import gzip
import json
import math
import os
import pathlib
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
TF32_FLOPS = 495e12                 # dense tensor-core peak, TF32
# fp32 attention on the tensor cores as 3xTF32: three TF32 products per
# fp32 product (csrc/flash_attention.cu)
TF32_TERMS = 3
FP32_TOL = 1e-5
# bf16, per element: BF16_ULPS ulps of max(|kernel|, |plain|) for the two
# final roundings, plus FP32_TOL for the fp32 sums before them (an output
# that cancels to near zero keeps their absolute error, not a relative one)
BF16_ULPS = 2.0
# decode logits at 40 layers, max|kernel - plain| / max|logit|: reads
# 1.399e-2 on an H100; plain with the window one page short reads 1.866e-2
# against plain, so the limit sits between them (PERF.md, Findings)
LOGIT_REL_TOL = 1.6e-2
SOURCES = ("flash_decode", "topk_compress", "qint8_pack", "batched_qr",
           "rwkv6_wkv", "flash_attention")
TOPK_RATIO = 0.05
TOPK_ROWS = 16                      # P = 16 learners: one row each
# phase 6 times a whole fire after a device sleep of this many cycles
# (~5 ms), so that the host has queued all its launches first
TOPK_SLEEP_CYCLES = 10_000_000
# top-k kernel launches a global fire may take in phase 7's trace (one
# grouped call: topk_small, topk_digit x 3, topk_compact)
TOPK_LAUNCHES_PER_FIRE = 8
TRAIN_PLAN = "local@2/global@8:topk:0.05"
# phase 19: the world's telemetry against the one-process round in the
# ranks' grouping, |world - one| <= TEL_CARD_RTOL * |one| per statistic.
# The steps and the local fires are the same arithmetic on the same block
# shapes; the global fire's mean sums the ranks in another order (within
# 4 * 2^-23 * max|x| an element, ROADMAP Queue 3), and each statistic is
# an fp32 sum of up to 4.5e7 non-negative terms (4 learners x 11,172,160)
# in the card's reduction orders, a tree of partial sums whose chains
# hold a few hundred terms: each order within ~(chain + log2 K) * 2^-24,
# about 1e-5, of the exact sum.  The limit leaves a decade above that;
# the control, the EF mass of a rank's block alone (the fault this
# replaced), is about 0.75 of the grid's off
TEL_CARD_RTOL = 1e-4
# phase 21: what the card's fit must show.  The fit is the reference's
# (four columns: ring bytes, per-message ring steps, dense bytes per
# codec).  In one process a level's "collective" is the fixed-order tree
# mean on the card, whose host cost (about nine eager calls a leaf,
# 0.32-0.65 ms at the reference grid's 131-819 KB points) no column
# bills: the least squares fit the ladder's device-bound points, and a
# host-bound point's relative error is about 1 - w/t (w the device work,
# t its time), below 1 but near it.  A limit on the median over a grid of
# mostly host-bound points is therefore no test of the fit (a first limit
# of 0.75, the reference's CPU tolerance, read 0.7666 on an H100 and was
# withdrawn, PERF.md).  The gate is what the fit promises: the least
# squares over non-negative rates, solved exactly, so its squared error in
# seconds over the samples is below that of any other non-negative rates,
# the reference's uncalibrated placeholders among them (the control,
# printed beside it); and no slow tier.  The median relative error is
# printed against the reference's 0.75, with each sample's
TRAIN_ROUNDS = 3
QINT8_BLOCK = 256
# batched_qr against its plain version (the same CGS2 recurrence; rsqrtf
# against torch.rsqrt and another sum order), raw Q within QR_TOL of max|Q|
# on well-conditioned panels; orthonormality |Q^T Q - I| and the projector
# against torch.linalg.qr within QR_ORTH_TOL, which a one-pass (CGS)
# control must fail on a panel of condition 1e6
QR_TOL = 1e-5
QR_ORTH_TOL = 1e-4
# batched_qr against kernels/ref.py's emulation of its arithmetic
# (batched_qr_blocked_plain, from the same plan): ulps per element.  Every
# operation of the kernel is one fp32 operation rounded once (fmaf, an
# addition, __fsub_rn, __fmul_rn, __frsqrt_rn) in an order the plan fixes,
# and the emulation performs the same ones in the same order, so the limit
# is 0; the same emulation on another schedule (a row a thread at a time)
# must fail it
QR_EMU_ULPS = 0
# phase 8's per-leaf PowerSGD fires at rank 2, (batch, a, r) a compressible
# leaf: ResNet-18 (16 learners; the HWIO convs give a = 3) and rwkv6-1.6b
# at RWKV_LAYERS (4 learners, 4 layers)
RESNET_QR_FIRE = ((16, 3, 2),) * 17 + ((16, 512, 2),)
RWKV_QR_FIRE = ((4, 65536, 2), (4, 2048, 2)) + ((4, 4, 2),) * 22
# phase 9, plan B (PowerSGD), kernel against plain QR after 2 rounds:
# max|kernel - plain| / max|plain| of the losses and of all params at once
# read 3.03e-3 and 2.23e-3 on an H100 (PERF.md, Findings), so the limits
# sit at about 3x and 4.5x those readings.  The warm-started power
# iteration amplifies rounding in the QR: the same run read 0.49 on the EF
# residual, 0.18 on Q and 6.4e-2 on the worst params leaf, so those are
# reported and not held.  Witnesses beside it, read on an H100 (PERF.md,
# Findings): on the trainer's own panels the kernel's and the plain Q are
# within 2.0e-7 of an fp64 QR, yet a trajectory with QR in fp64 drifts
# from the plain one by 4.79e-3 (losses) and 7.66e-3 (params), further
# than the kernel does, so the params limit passes an exact QR with a
# margin of only 1.3x; a control QR that normalizes each column without
# projecting out the earlier ones reads 3.39e-3 on the losses, within, and
# 1.009e-1 on the params, 10x the limit, which it must fail
PSGD_LOSS_TOL = 1e-2
PSGD_PARAM_TOL = 1e-2
# phase 9B, beside the trajectory limit: the kernel's Q on every panel the
# trainer hands it, held to a QR of known accuracy on the same panel (fp64
# Householder, column signs as Gram-Schmidt's).  The plain CGS2
# (kernels/ref.py, held to the reference on the CPU) runs the kernel's
# algorithm in fp32 in another summation order, so the two share the
# first-order error u * cond(panel) * O(1) and differ by rounding of the
# same size: max|Q_kernel - Q_fp64| <= QR_FP64_FACTOR * max|Q_plain -
# Q_fp64| + QR_FP64_FLOOR, per panel stack, the floor (4 u) keeping a panel
# where the plain Q happens to land on the fp64 one from failing a sound
# kernel.  Unlike the trajectory limit it does not depend on the state the
# earlier rounds trained.  The control: a QR that normalizes each column
# without projecting out the earlier ones, whose columns are not
# orthogonal (an O(|cos| of the panel's columns) error), must fail it.
QR_FP64_FACTOR = 2.0
QR_FP64_FLOOR = 2.0 ** -22
CODEC_PLANS = ("local@2:qint8/global@8:topk:0.05",
               "local@2/global@8:powersgd:2:bucketed",
               "local@2/global@8:powersgd:2")
# compressible leaves of ResNet-18 at PowerSGD rank 2: plan C's QR
# segments a fire (one grouped call)
RESNET_PSGD_LEAVES = 18
# phases 10 and 11, each WKV and attention kernel against its plain
# version, fp32: max|kernel - plain| <= KERN_REL_TOL * max|plain| per
# output.  Both sum in fp32 in other orders: a dot product of 64 (WKV) or
# 128 (attention) terms rounds at about sqrt(n) * 6e-8 of its largest term
# (~1e-6), and 512 recurrent steps add rounding as a random walk
# (sqrt(512) * 6e-8 = 1.4e-6), so 1e-5 leaves about 5x.  bf16 outputs, per
# element: BF16_ULPS ulps of max(|kernel|, |plain|) plus KERN_REL_TOL *
# max|plain|.  Controls that must fail it: y and dk with the bonus u's
# term dropped, attention one key short of its window (forward and dK),
# query head h on kv head h % Hkv instead of h // group, dr and dw read
# with S_{t+1} for S_t (an off-by-one in the WKV backward's ring of on-chip
# states), and y with r_{t+1} for r_t at the first step of every stage (a
# fault in the WKV forward's staging).
KERN_REL_TOL = 1e-5
# phase 10, the WKV forward against kernels/ref.py's emulation of its
# arithmetic (every fmaf rounded once): the states and checkpoints bit for
# bit, y per element within this many ulps of its type (the emulation
# should give y's bits too; an ulp leaves room for the one place where
# the card and the emulation might part)
WKV_FWD_EMU_ULPS = 1
# phase 10 times the WKV forward after a device sleep of this many cycles
# (~0.5 ms), not time_ms's ~50 us: on the first reading after a fresh
# flush buffer the host takes 0.15-0.23 ms from the flush's launch to the
# forward's return (0.06-0.15 on the others), as long as the flush and
# the short sleep, while the kernel alone never runs long
# (scripts/wkv_variants.py's timing study); at the short sleep the first
# of phase 10's readings read 0.16-0.27 ms against ~0.11 in 7 of 9 runs
# on an H100
WKV_FWD_SLEEP_CYCLES = 1_000_000
# every kernel's time prints its median beside its mean (fmt_ms) and the
# readings whose host enqueue outlasted the device sleep; one whose mean
# and median differ by more than TIMING_SPREAD of the median (calls read
# within 5% of each other, PERF.md section 6) is read again after a sleep
# ten times as long (10^5 -> 10^6 cycles, ~0.5 ms), and that second set
# is its time.  QR's readings are a few microseconds each and are read at
# LONG_SLEEP_CYCLES from the start
TIMING_SPREAD = 0.05
LONG_SLEEP_CYCLES = 1_000_000
# phases 12 and 13: full-width LM training through the Hier-AVG trainer
LM_MARKOV_VOCAB = 512       # the Markov chain's token ids (a 65,536^2
                            # chain would take 17 GB)
LM_ROUNDS = 3
LM_FULL_DEPTH = {"rwkv6-1.6b": 24, "starcoder2-15b": 40,
                 "deepseek-v2-lite-16b": 27, "qwen2-vl-2b": 28}
# depth, cut to what fits one card at 4 learners with room to spare:
# params, grads, new params, top-k EF ref/err and a step's activations under
# vmap(grad); rwkv6 at 6 layers ran out of the card's 80 GB in its first
# SGD step (PERF.md, PR 14), and starcoder2 at 2 layers would hold 66 GB in
# params, grads and new params alone.  Both phases print their peak.
RWKV_LAYERS = 4
# phase 12 trains RWKV_TRAIN_LAYERS of them (it trained RWKV_LAYERS
# before phases 22 and 23 took the time); phases 6 and 8 keep their fires
# at RWKV_LAYERS, the sizes of the kernel table's rows
RWKV_TRAIN_LAYERS = 2
DENSE_LAYERS = 1
LM_RWKV_PLAN = "local@2/global@8:topk:0.05"
# kernel against plain, 1 round from one state copy: the round's mean
# loss within LM_LOSS_TOL relative (per-call differences of ~1e-6 carried
# through 8 SGD steps; 100x margin), and params within LM_PARAM_TOL of
# their leaf's largest value except for at most LM_SWAP_FRAC of the
# coordinates: the global top-k fire may swap coordinates whose
# magnitudes tie within the kernels' rounding (seen on the CPU against
# the reference: 1-3 swaps in 3 of 25 leaves of the reduced LM), each
# moving a param by up to a sent delta
LM_LOSS_TOL = 1e-4
LM_PARAM_TOL = 1e-4
LM_SWAP_FRAC = 1e-4
# phase 14: the per-leaf plan and plan A under participation masks, and
# the seeded fault schedule of the faulted run; its mask stream over
# TRAIN_ROUNDS rounds at (1, 4, 4), with the straggler deadlines priced
# from the ResNet-18 template, hashes to the reference's (computed on the
# CPU by repro.elastic with the same spec, seed and deadlines)
ELASTIC_PLANS = (TRAIN_PLAN, CODEC_PLANS[0])
ELASTIC_FAULTS = "crash:0.02/flaky:group:0.2:2/straggler:0.1:1.5"
ELASTIC_MASK_SHA = ("c6a817faf5c66c8cf4fec59a44b9a2d653e43f30981c9a5275aa4f0"
                    "d29e6a507")
# phases 15 and 16: deepseek-v2-lite (MoE + MLA) cut to its dense first
# layer and one MoE layer, and qwen2-vl (M-RoPE, tied vocab) in bf16 with
# remat and the per-leaf top-k plan, both at published widths
MOE_ARCH, MOE_LAYERS, MOE_SEQ = "deepseek-v2-lite-16b", 2, 1024
VLM_ARCH, VLM_SEQ = "qwen2-vl-2b", 1024
VLM_PLAN = "local@2/global@8:topk:0.05"
# depth 28 -> VLM_LAYERS: the per-leaf top-k fire holds about 24 bytes per
# bf16 param per learner (params, EF ref, fp32 EF err old and new, the fp32
# decompressed and averaged trees, the cast result and its ref clone); at
# 4 layers (420,558,336 params) the card read a 41.48 GiB peak, 26.5 B a
# param a learner, and 10 layers read 69.10 GiB; full depth would hold
# ~164 GB.  The serving phases (4c, 5b, 17, 18) take the ~100 s that 10
# layers took beyond 4 (phase 16: 151-180 s at 10), and phases 22 and 23
# ~150 s more, so the script stays within its time: 2 layers (4 before
# them), launch counts exact for that depth
VLM_LAYERS = 2
# phase 16, kernel against plain in bf16, 1 round from one state copy:
# the round's mean loss within BF16_LOSS_REL relative (a bf16 logit is
# rounded to 2^-9 of itself and the attention's P and output again), and
# the round's update (new - old params, all leaves as one vector) within
# a relative L2 distance of BF16_UPDATE_L2: each update is rounded to its
# param's bf16 ulp, so a step below half an ulp vanishes in one run and not
# in the other, and top-k's selection follows the deltas.  Kernel and
# plain differ only in the attention's roundings; the two packages on the
# CPU, whose bf16 roundings differ at every operation, put a reduced
# deepseek-v2-lite round's update 0.14 apart.  Control: the kernel's round
# with the labels shifted by one position (an off-by-one in the targets)
# must fail both.  (A first control, another batch of the same chain,
# read 0.47 against a first limit of 0.5 on the card: batches of one
# Markov chain push the update the same way, so neither could tell them
# apart.)
BF16_LOSS_REL = 2.0 ** -8
BF16_UPDATE_L2 = 2.0 ** -2
# phase 5b: phase 5's check averaged over LOGIT_MEAN_STEPS decode steps x 8
# slots, all past the window: the mean over (step, slot) of ||kernel -
# plain|| / ||plain|| over the slot's logits.  Averaging 32 readings takes
# out the luck of which bf16 outputs flip; a relative L2 over 49,152
# logits reads the spread of the difference against the spread of the
# logits, as a ratio of maxima does for near-Gaussian vectors, so a sound
# kernel should read below phase 5's per-call readings (1.35-1.63e-2, the
# worst of 7 slots) and under the same limit, while the window control,
# one page short in every slot (phase 5's bit in 2 of 7, 1.87-2.10e-2 as
# the worst of them), should read above it in the mean too
LOGIT_MEAN_STEPS = 4
LOGIT_MEAN_TOL = 1.6e-2
# phase 4c: starcoder2-15b through ServeEngine on phase 4's weights, one
# wave of DENSE_B prompts of DENSE_PLEN tokens (a power of two, so the
# dense and paged engines see the same tokens).  The prefill's
# last-position logits, kernel against plain, max|diff| / max|logit|,
# within DENSE_LOGIT_TOL: twice phase 5's decode limit, since every one of
# the 2048 prompt positions carries the kernel's bf16 roundings into the
# keys and values the last one reads (in phase 5 only the new token's
# did), while independent roundings of many keys average out in the
# softmax.  Control: plain with the window four pages short of the
# prompt (the last 64 positions lose up to 64 of their keys; phase 5's one
# page of 4100 keys read ~2e-2, here 3% of the last position's keys at
# every layer)
DENSE_B, DENSE_PLEN, DENSE_NEW = 4, 2048, 32
DENSE_LOGIT_TOL = 3.2e-2
# phase 17: rwkv6-1.6b through ServeEngine.  Kernel against plain (one
# wave's prefill: every layer's three states and the last logits,
# max|diff| / max|ref| each, the largest of them) and continuity (prefill
# of RWKV_PLEN - RWKV_CONT tokens then RWKV_CONT decode steps, against a
# prefill of all RWKV_PLEN), both at fp32 compute over the bf16 params,
# within RWKV_CONT_TOL: the WKV runs in fp32 either way (w is fp32, so
# r, k and v are promoted), and the two sides differ only by fp32 sums
# in other orders (the kernel's tiles against the plain loop or the
# decode's einsum, GEMMs of 4 rows against 4096) at ~1e-6 each, 10x for
# 24 layers and 16 steps, then 10x margin.  Controls: plain with the
# bonus u dropped (y loses r (u k) v); the state of the prompt shifted
# by one token, continued with the same 16 tokens (a decay step and a
# token of history apart, (1 - w) of the state, w down to 0.69).  The
# kernel against plain at the served bf16 is printed, not held: a first
# limit of 1e-2, set before any reading from the rarity of bf16 flips in
# an fp32 WKV's y, failed the kernel on an H100 at 4.06e-2 against
# 1.13e-1 for the u-dropped control, as 24 bf16 layers amplify those
# flips (PERF.md section 6)
RWKV_REQS, RWKV_SLOTS, RWKV_PLEN, RWKV_NEW, RWKV_CONT = 8, 4, 1024, 64, 16
RWKV_PLAIN_TOL = RWKV_CONT_TOL = 1e-4
# phase 18: deepseek-v2-lite-16b paged (MOE_REQS requests), then dense
# against paged at a dropless capacity factor with fp32 compute and fp32
# caches over the bf16 params, 4 prompts of MOE_CMP_PLEN tokens: the first
# decode step's logits, max|diff| / max|logit|, within MOE_DENSE_TOL.  The
# two paths attend in other forms (decompressed against absorbed latents)
# and route in other groups (1024 tokens against chunks of 256), ~1e-6
# apart in fp32; a top-6 routing of 64 probabilities that are that close
# flips, a few of ~100,000 (token, layer) routings, each moving one
# token's layer output, a key or two of the last position's 1024, so
# ~1e-3-1e-2.  Control: the paged step one page short (attending 1008 of
# the 1025 keys at a rope position 16 early, its latent over a prompt
# position's), 1.6% of the keys, four times phase 5's one page of ~4100
MOE_REQS, MOE_CMP_PLEN, MOE_CMP_NEW = 12, 1024, 32
# phases 17 and 18 serve at full width, cut in depth (from 24 and 27
# layers) so that phases 22 and 23 fit the script's time: their
# decode steps are host-bound, about linear in the layers; every limit
# there is one that fewer layers only loosen (fp32 differences summed over
# fewer layers), each control a planted fault of every layer
RWKV_SERVE_LAYERS, MLA_SERVE_LAYERS = 12, 9
MOE_DENSE_TOL = 2e-2


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


class Ms(float):
    """A kernel's time in ms: the mean of ``readings`` (each taken after a
    device sleep of ``sleep`` cycles), with their ``median``; ``late``
    counts the timed calls (``timed`` of them) whose host enqueue outlasted
    the sleep (they count host time), and ``short`` holds the first set
    where the readings were taken again after a sleep ten times as
    long."""

    def __new__(cls, readings, sleep, late=0, short=None, timed=None):
        self = super().__new__(cls, statistics.fmean(readings))
        self.readings = list(readings)
        self.median = statistics.median(readings)
        self.sleep = sleep
        self.late = late
        self.timed = len(self.readings) if timed is None else timed
        self.short = short
        return self

    def spread(self) -> bool:
        """Mean and median further apart than TIMING_SPREAD of the
        median."""
        return abs(self - self.median) > TIMING_SPREAD * self.median


def fmt_ms(ms: Ms) -> str:
    """A time with its median beside its mean, the readings the host was
    late for, and the first set where they were taken again."""
    text = f"{ms:.4f} (mean; median {ms.median:.4f}"
    if ms.late:
        text += f"; host late for {ms.late} of {ms.timed} calls"
    if ms.short is not None:
        text += (f"; read again at sleep {ms.sleep}: at {ms.short.sleep} "
                 f"mean {ms.short:.4f} median {ms.short.median:.4f}, host "
                 f"late for {ms.short.late} of {ms.short.timed} calls")
    return text + ")"


def time_ms(torch, fn, flush, reps: int, sleep: int = 100_000) -> Ms:
    """Device time of fn over reps launches, L2 flushed before each (the
    serving path finds each layer's pool cold).  The card sleeps
    ``sleep`` cycles (~50 us by default) after the flush, so that the host
    has queued fn's launches before the start event is reached and the
    time counts no host gap; a reading whose enqueue outlasted the sleep
    is counted as late.  Where the readings' mean and median differ by
    more than TIMING_SPREAD of the median, they are taken again after a
    sleep ten times as long (both sets are printed by fmt_ms)."""
    fn()
    torch.cuda.synchronize()
    out, late = [], 0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(sleep)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        late += (time.perf_counter() - t0) * 1e3 > sleep / 2e6
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    ms = Ms(out, sleep, late)
    if reps > 1 and ms.spread() and sleep < 10 * LONG_SLEEP_CYCLES:
        again = time_ms(torch, fn, flush, reps, 10 * sleep)
        return Ms(again.readings, again.sleep, again.late, short=ms)
    return ms


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


def plain_dropping_key(torch, kref, q, kp, vp, tables, lens, window, slot,
                       key):
    """flash_decode_plain with key ``key`` of slot ``slot`` masked out as
    well: the control of an off-by-one at a split boundary."""
    b, hq, d = q.shape
    hkv = kp.shape[0]
    k = kref.gather_pages(kp, tables).float()
    v = kref.gather_pages(vp, tables).float()
    t = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k) * (1.0 / float(d) ** 0.5)
    ln = lens.long()[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    valid = kpos < ln
    if window:
        valid &= (ln - 1 - kpos) < window
    valid[slot, key] = False
    scores = scores.masked_fill(~valid[:, None, None], kref.NEG_INF)
    out = torch.einsum("bkgt,btkd->bkgd", torch.softmax(scores, -1), v)
    out = torch.where(valid.any(1)[:, None, None, None], out,
                      torch.zeros_like(out))
    return out.reshape(b, hq, d).to(q.dtype)


def phase_kernel(torch, kops, kref):
    from repro_torch.kernels import flash_decode as fdk
    # small fp32 cases: lengths 0, 1, a page boundary, several tiles and
    # pages, a full table (128) and one past it; windows that start inside
    # a page and span one or several 32-key tiles; the default plan (one
    # split) and forced splits of one and of three pages
    lengths = [0, 1, 8, 33, 64, 100, 128, 130]
    small = decode_case(torch, b=8, hkv=2, g=3, d=32, page=8, maxp=16,
                        lengths=lengths, dtype=torch.float32, seed=1,
                        poison_null=True)
    for window in (5, 40, 0):
        out_p = kops.flash_decode(*small, window=window, impl="plain")
        errs = []
        for sk in (None, 8, 24):
            out_k = fdk.flash_decode(*small, window=window, split_keys=sk)
            torch.cuda.synchronize()
            err, _ = check(torch, f"fp32 small window {window} split_keys "
                           f"{sk}", out_k, out_p, torch.float32)
            if out_k[0].abs().max().item() != 0.0:
                fail("lengths == 0 did not give zeros")
            errs.append(f"split_keys {sk or 'default'}: {err:.3e}")
        print(f"phase 3 kernel small fp32 (B8 G3 D32 page8 maxp16 window"
              f"{window} lengths {lengths}): max_abs_err " + ", ".join(errs)
              + f" tol={FP32_TOL}")

    # every code path of the kernel: the tensor-core path at each head dim
    # and at 16, 32, 64 and 128 padded heads (one to eight warp groups),
    # and the CUDA-core path for the mixed pairs (an fp32 q on a bf16
    # pool, the serving default with fp32 params; a bf16 q on an fp32
    # pool), at several splits and a window
    bf, f32 = torch.bfloat16, torch.float32
    lengths = [0, 1, 16, 100, 300, 513, 700, 1000]
    parts = []
    for g, d, qdt, kvdt in [(12, 128, bf, bf), (20, 128, bf, bf),
                            (40, 64, bf, bf), (100, 32, bf, bf),
                            (7, 256, bf, bf), (12, 128, f32, bf),
                            (12, 128, bf, f32), (5, 256, f32, f32)]:
        q, kp, vp, tables, lens = decode_case(
            torch, b=8, hkv=2, g=g, d=d, page=16, maxp=64, lengths=lengths,
            dtype=kvdt, seed=5, poison_null=True)
        q = q.to(qdt)
        worst = 0.0
        for window in (0, 500):
            out_p = kops.flash_decode(q, kp, vp, tables, lens, window=window,
                                      impl="plain")
            for sk in (None, 48):
                out_k = fdk.flash_decode(q, kp, vp, tables, lens,
                                         window=window, split_keys=sk)
                torch.cuda.synchronize()
                err, _ = check(torch, f"G{g} D{d} q {qdt} pool {kvdt} "
                               f"window {window} split_keys {sk}", out_k,
                               out_p, qdt)
                worst = max(worst, err)
        parts.append(f"G{g} D{d} {str(qdt)[6:]}/{str(kvdt)[6:]} {worst:.2e}")
    print(f"phase 3 kernel paths (B8 Hkv2 page16 maxp64 windows 0 and 500, "
          f"split_keys 256 and 48, lengths {lengths}): max_abs_err "
          + "; ".join(parts))

    # the serving shape: starcoder2-15b decode, 8 slots; fp32, then the
    # bf16 pool and query of the main path
    window, page, maxp = 4096, 16, 272
    sk, n_splits = fdk.split_plan(maxp, page, window)
    lengths = [0, 1, 16, 1000, 2047, 4096, 4150, 4200]
    shape = dict(b=8, hkv=4, g=12, d=128, page=page, maxp=maxp)
    case32 = decode_case(torch, **shape, lengths=lengths,
                         dtype=torch.float32, seed=2)
    out_k = kops.flash_decode(*case32, window=window, impl="kernel")
    out_p = kops.flash_decode(*case32, window=window, impl="plain")
    torch.cuda.synchronize()
    err32, _ = check(torch, "fp32 serving shape", out_k, out_p,
                     torch.float32)
    # control: the key at the first split boundary of the longest slot
    # masked out must move the output past the limit
    lo, _ = fdk.visible_span(max(lengths), maxp, page, window)
    slot = lengths.index(max(lengths))
    ctrl = (plain_dropping_key(torch, kref, *case32, window, slot, lo + sk)
            - out_p).abs().max().item()
    if not ctrl > FP32_TOL:
        fail(f"control: dropping key {lo + sk} of slot {slot} moves the "
             f"output by {ctrl:.3e} <= {FP32_TOL}: the limit would not see "
             f"an off-by-one at a split boundary")
    print(f"phase 3 kernel serving fp32 (B8 Hq48 Hkv4 D128 page16 maxp272 "
          f"window4096 lengths {lengths}): max_abs_err={err32:.3e} "
          f"tol={FP32_TOL} control (plain vs plain dropping key {lo + sk} "
          f"of slot {slot}) {ctrl:.3e}")
    del case32, out_k, out_p

    # split boundaries at the serving widths, fp32 and bf16: lengths about
    # one and two splits; a window (601 keys) that starts inside
    # a page and a split; every length 0; one long slot and
    # seven empty (load imbalance); all eight slots at 4096 visible keys
    edge = [sk - 1, sk, sk + 1, 2 * sk + 1, 2 * sk - 1, 17, 1, 4200]
    cases = [("edges", edge, window), ("edges window601", edge, 601),
             ("all empty", [0] * 8, window),
             ("one long", [4200] + [0] * 7, window),
             ("all 4096", [4096] * 8, window)]
    for dtype in (torch.float32, torch.bfloat16):
        parts = []
        for label, lens_, w in cases:
            c = decode_case(torch, **shape, lengths=lens_, dtype=dtype,
                            seed=3)
            out_p = kops.flash_decode(*c, window=w, impl="plain")
            errs = []
            for force in (None, page):
                out_k = fdk.flash_decode(*c, window=w, split_keys=force)
                torch.cuda.synchronize()
                err, _ = check(torch, f"{label} {dtype} split_keys "
                               f"{force}", out_k, out_p, dtype)
                errs.append(err)
            if label == "all empty" and out_k.abs().max().item() != 0.0:
                fail("every length 0 did not give zeros")
            if label == "edges" and dtype == torch.float32:
                # the plain split decomposition at one-page splits too
                out_s = kref.flash_decode_split_plain(
                    *c, window=w, split_keys=page)
                err, _ = check(torch, "split plain one-page splits", out_k,
                               out_s, dtype)
                errs.append(err)
            parts.append(f"{label} {'/'.join(f'{e:.2e}' for e in errs)}")
            del c, out_p, out_k
        print(f"phase 3 split boundaries {str(dtype)[6:]} (split_keys {sk} "
              f"and {page}; edge lengths {edge}): max_abs_err "
              + "; ".join(parts))

    case = decode_case(torch, **shape, lengths=lengths, dtype=torch.bfloat16,
                       seed=2)
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
    hkv, b = shape["hkv"], shape["b"]
    busy = sum(fdk.busy_splits(lengths, maxp, page, window, sk)) * hkv
    print(f"phase 3 kernel serving bf16 (B8 Hq48 Hkv4 D128 page16 maxp272 "
          f"window4096 lengths {lengths}): max_abs_err={err:.3e} "
          f"limit_share={share:.3f} (limit {BF16_ULPS} ulps + {FP32_TOL}) "
          f"ms={fmt_ms(ms)} plain_ms={fmt_ms(plain_ms)} "
          f"library_ms={fmt_ms(library_ms)} bound_ms={bound_ms:.4f} "
          f"({bound_by}, {nbytes} B) splits={n_splits} split_keys={sk} "
          f"busy_ctas={busy} launched_ctas={n_splits * hkv * b}")
    # the split size, by measurement (SPLIT_KEYS in kernels/flash_decode.py)
    sweep = {k: time_ms(torch, lambda: fdk.flash_decode(
        *case, window=window, split_keys=k), flush, 50)
        for k in (64, 128, 256, 512, 1024)}
    print("phase 3 split_keys sweep (bf16 serving case, ms): " + " ".join(
        f"{k}={fmt_ms(v)}" for k, v in sweep.items()))
    del kd, vd, mask, case, out_k, out_p

    full = decode_case(torch, **shape, lengths=[4096] * 8,
                       dtype=torch.bfloat16, seed=4)
    full_ms = time_ms(torch, lambda: fdk.flash_decode(
        *full, window=window), flush, 50)
    full_bound, full_by, full_bytes = decode_bound(full[0], full[1],
                                                   full[3], full[4], window)
    print(f"phase 3 kernel all 8 slots at 4096 visible keys bf16: "
          f"ms={fmt_ms(full_ms)} bound_ms={full_bound:.4f} ({full_by}, "
          f"{full_bytes} B) busy_ctas="
          f"{sum(fdk.busy_splits([4096] * b, maxp, page, window, sk)) * hkv}")
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
    print("phase 4b flash_decode kernels (ms per step): " + " | ".join(
        f"{k[:70]} {v / n / 1e3:.3f}" for v, k in sorted(kernels, reverse=True)
        if "flash_decode" in k.lower()))
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


def phase_logits_mean(torch, np, cfg, params, engine):
    """Phase 5b: phase 5's check averaged over steps and slots.  Four
    teacher-forced decode steps (seeded tokens) over all 8 slots, every
    one past the window (lengths 4100..4163), through the kernel and
    through the plain version, each run writing its own K/V at the
    positions it then reads.  The measure is the mean over the 32 (step,
    slot) pairs of ||kernel - plain|| / ||plain|| over the slot's logits;
    the control (plain with the window one page short, against plain)
    bites in every slot and must exceed the limit."""
    import dataclasses

    from repro_torch.models import build
    slots, maxp = engine.slots, engine.max_pages_per_seq
    tables = (torch.arange(slots * maxp, dtype=torch.int32, device="cuda")
              .reshape(slots, maxp) + 1)
    start = torch.arange(4100, 4100 + 9 * slots, 9, dtype=torch.int32,
                         device="cuda")
    toks = torch.tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(LOGIT_MEAN_STEPS, slots)),
        dtype=torch.int32, device="cuda")
    active = torch.ones(slots, dtype=torch.bool, device="cuda")

    def run(b):
        out = []
        with torch.no_grad():
            for t in range(LOGIT_MEAN_STEPS):
                lg, _ = b.decode_step_paged(params, toks[t], engine.pages,
                                            tables, start + t, active)
                out.append(lg.float())
        return torch.stack(out)                       # [steps, slots, V]

    def bundle(window):
        return build(dataclasses.replace(cfg, sliding_window=window),
                     param_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
                     decode_impl="plain", device="cuda")

    def measures(a, b):
        l2 = ((a - b).norm(dim=-1) / b.norm(dim=-1)).mean().item()
        mx = ((a - b).abs().amax(-1) / b.abs().amax(-1)).mean().item()
        return l2, mx

    kern = run(engine.bundle)
    plain = run(bundle(cfg.sliding_window))
    ctrl = run(bundle(cfg.sliding_window - engine.page_size))
    torch.cuda.synchronize()
    (sound, sound_mx), (control, control_mx) = (measures(kern, plain),
                                                measures(ctrl, plain))
    print(f"phase 5b logits averaged over {LOGIT_MEAN_STEPS} steps x "
          f"{slots} slots (lengths {start[0].item()}..{start[-1].item()}, "
          f"all past the window): mean rel L2 kernel vs plain "
          f"{sound:.4e} (limit {LOGIT_MEAN_TOL}), control window one page "
          f"short {control:.4e} (must exceed), separation "
          f"{control / max(sound, 1e-30):.2f}x; mean per-slot max|diff|/max|logit| "
          f"kernel {sound_mx:.4e} control {control_mx:.4e}")
    if not math.isfinite(sound) or sound > LOGIT_MEAN_TOL:
        fail(f"averaged decode logits kernel vs plain {sound:.4e} > "
             f"{LOGIT_MEAN_TOL}")
    if not control > LOGIT_MEAN_TOL:
        fail(f"averaged control reads {control:.4e} <= {LOGIT_MEAN_TOL}: "
             f"the averaged limit would not fail a window fault")
    return {"sound": sound, "control": control}


def sync_timed(torch, fn, sink):
    """fn, with its wall time (host clock across a synchronize on both
    sides) appended to ``sink`` in ms."""
    def run(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t0) * 1e3)
        return out
    return run


def rel_max(a, b) -> float:
    """max|a - b| / max|b| over two tensors, in fp32."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max()).item()


def agreement(np, a, b):
    """(share of equal tokens, first differing position per row or -1)."""
    a, b = np.asarray(a), np.asarray(b)
    eq = a == b
    first = [int(np.argmin(r)) if not r.all() else -1 for r in eq]
    return float(eq.mean()), first


def dense_attn_times(torch, cfg, flush, b, s):
    """The bf16 attention forward at the dense prefill's shape, window
    cfg.sliding_window (longer than the prompt, so SDPA's causal mask is
    the same function): kernel against plain, SDPA and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    hq, hkv, d, w = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                     cfg.sliding_window)
    q, k, v, _ = attn_inputs(torch, b, s, hq, hkv, d, torch.bfloat16, 91)
    (fb, fby, _, fbasis), _ = attn_bound(b, s, hq, hkv, d, w, 2)
    t = dict(
        ms=time_ms(torch, lambda: flash_attention_fwd(q, k, v, window=w),
                   flush, 10),
        plain_ms=time_ms(torch, lambda: kref.flash_attention_plain(
            q, k, v, window=w), flush, 3),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True), flush, 10),
        bound_ms=fb, bound_by=fby)
    print(f"phase 4c attention forward at the dense prefill's shape (B{b} "
          f"S{s} Hq{hq} Hkv{hkv} D{d} window {w} bf16, L2 flushed): ms="
          f"{fmt_ms(t['ms'])} plain_ms={fmt_ms(t['plain_ms'])} sdpa_ms="
          f"{fmt_ms(t['library_ms'])} bound_ms={fb:.4f} ({fby}, {fbasis})")
    return t


def phase_dense_serve(torch, np, cfg, params, engine):
    """Phase 4c: starcoder2-15b (phase 4's weights, full width and depth,
    bf16) through ServeEngine: 4 prompts of DENSE_PLEN tokens in one
    wave, DENSE_NEW new tokens each.  The prefill launches one bf16
    flash_attention forward a layer (window 4096); its last-position
    logits are held against impl="plain", and a control (plain with the
    window four pages short of the prompt) must fail the limit.  The
    same requests through phase 4's paged engine: greedy agreement."""
    import dataclasses

    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models import build
    from repro_torch.serve import GenerationConfig, ServeEngine

    rng = np.random.default_rng(40)
    reqs = [rng.integers(0, cfg.vocab_size, size=DENSE_PLEN).astype(np.int32)
            for _ in range(DENSE_B)]
    max_len = DENSE_PLEN + DENSE_NEW

    def bundle(impl, window=cfg.sliding_window):
        return build(dataclasses.replace(cfg, sliding_window=window),
                     param_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
                     impl=impl, device="cuda")

    kern = bundle("auto")
    prefill_ms, decode_ms = [], []
    timed = dataclasses.replace(
        kern, prefill=sync_timed(torch, kern.prefill, prefill_ms),
        decode_step=sync_timed(torch, kern.decode_step, decode_ms))
    dense = ServeEngine(timed, params, max_len=max_len,
                        gen=GenerationConfig(max_new_tokens=DENSE_NEW))
    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    res = dense.serve_queue(reqs, slots=DENSE_B)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention_fwd.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches != cfg.n_layers:
        fail(f"phase 4c: flash_attention forward launches {launches} != "
             f"{cfg.n_layers} layers x 1 prefill")
    tokens = sum(r.steps for r in res)
    if tokens != DENSE_B * DENSE_NEW or not all(
            ((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()
            for r in res):
        fail(f"phase 4c: {tokens} tokens or a token outside the vocab")

    # kernel prefill against plain, and the control
    batch = {"tokens": torch.tensor(np.stack(reqs), device="cuda"),
             "max_len": max_len}
    last = {}
    for tag, b in (("kernel", kern), ("plain", bundle("plain")),
                   ("control", bundle("plain", DENSE_PLEN - 4 * 16))):
        lg, cache = b.prefill(params, batch)
        last[tag] = lg.float()
        del cache
    torch.cuda.synchronize()
    sound = rel_max(last["kernel"], last["plain"])
    control = rel_max(last["control"], last["plain"])

    paged = engine.serve_queue(reqs, max_new=[DENSE_NEW] * DENSE_B)
    share, first = agreement(np, [r.tokens for r in res],
                             [r.tokens for r in paged])
    print(f"phase 4c dense serve starcoder2-15b (ServeEngine, {DENSE_B} x "
          f"{DENSE_PLEN} tokens, {DENSE_NEW} new, one wave): wall_s="
          f"{wall:.3f} tokens_per_s={tokens / wall:.2f} prefill_ms="
          f"{prefill_ms[0]:.3f} decode_ms_median="
          f"{statistics.median(decode_ms):.3f} decode_steps={len(decode_ms)} "
          f"peak_mem_gib={peak:.2f} flash_attention_forward_launches="
          f"{launches}; prefill last-position logits kernel vs plain "
          f"max|diff|/max|logit| {sound:.4e} (limit {DENSE_LOGIT_TOL}), "
          f"control window {DENSE_PLEN - 64} {control:.4e} (must exceed); "
          f"dense vs paged greedy tokens equal {share:.4f}, first "
          f"difference per request {first}")
    if not math.isfinite(sound) or sound > DENSE_LOGIT_TOL:
        fail(f"phase 4c prefill logits kernel vs plain {sound:.4e} > "
             f"{DENSE_LOGIT_TOL}")
    if not control > DENSE_LOGIT_TOL:
        fail(f"phase 4c control reads {control:.4e} <= {DENSE_LOGIT_TOL}")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    attn = dense_attn_times(torch, cfg, flush, DENSE_B, DENSE_PLEN)
    return {"flash_attention_forward": launches}, attn


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


def lm_leaf_sizes(cfg):
    """Per-learner sizes of an LM's leaves (meta tensors)."""
    from repro_torch.models import build
    from repro_torch.tree import leaves
    return [p.numel() for p in leaves(build(cfg, device="meta").init_train())]


def rwkv_leaf_sizes():
    """Per-learner sizes of rwkv6-1.6b's 25 leaves at RWKV_LAYERS layers,
    the phase 12 model."""
    import dataclasses
    from repro_torch.configs import get_config
    return lm_leaf_sizes(dataclasses.replace(get_config("rwkv6-1.6b"),
                                             n_layers=RWKV_LAYERS))


def topk_groups(sizes, rows):
    """The top-k reducer's grouping of consecutive leaves of these sizes
    (``rows`` fp32 rows each) into one kernel call per group."""
    from repro_torch.comm.sparse import TopKReducer, delta_groups
    return delta_groups([4 * rows * n for n in sizes],
                        TopKReducer.group_bytes)


def ulps_apart(torch, a, b) -> int:
    """The largest distance between two fp32 or bf16 tensors of one type,
    element by element, in units in the last place of the type (0: the
    same values; +0 and -0 are 0 apart)."""
    view, mask = ((torch.int16, 0x7FFF) if a.element_size() == 2
                  else (torch.int32, 0x7FFFFFFF))

    def ordered(x):
        i = x.contiguous().view(view).long()
        return torch.where(i < 0, -(i & mask), i)

    return int((ordered(a) - ordered(b)).abs().max().item())


def same_bits(torch, a, b) -> bool:
    """Equal bit for bit (so -0.0 differs from +0.0)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.view(view), b.view(view))


def fire_ms(torch, fn, flush, reps, sleep=TOPK_SLEEP_CYCLES, strict=True):
    """Device time of fn (a whole fire, one or many calls) over reps runs,
    the L2 flushed once before each; the card sleeps ``sleep`` cycles
    first (~sleep / 2e6 ms), so that the host has queued every launch of
    fn before the start event is reached.  Returns (readings in ms, the
    longest host enqueue in ms).  If the host took longer than the sleep,
    the reading counts its gap: ``strict`` fails then (for the kernel's
    own times), else the caller prints the host time beside it."""
    fn()
    torch.cuda.synchronize()
    out, host = [], 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(sleep)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host = max(host, (time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    if strict and host > sleep / 2e6:
        fail(f"fire_ms: the host queued for {host:.3f} ms, longer than the "
             f"card slept ({sleep} cycles)")
    return out, host


def topk_hold(torch, label, x, k, cap=None):
    """The kernel on one segment, alone and as the only segment of a
    grouped call, against topk_compress_plain and
    topk_compress_radix_plain, bit for bit in values and indices.  Returns
    the kernel's output and its largest |value - plain value|."""
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.topk_compress import (topk_compress,
                                                   topk_compress_many)
    outs = [topk_compress_many([x], [k], candidate_cap=cap)[0]]
    if cap is None:
        outs.append(topk_compress(x, k))
    torch.cuda.synchronize()
    worst = 0.0
    for name, (vp, ip) in (("plain", kref.topk_compress_plain(x, k)),
                           ("radix plain", kref.topk_compress_radix_plain(
                               x, k, cap=cap))):
        for v, i in outs:
            if not torch.equal(i, ip):
                bad = (i != ip).nonzero()[:4].tolist()
                fail(f"topk {label} (rows {x.shape[0]} n {x.shape[1]} k "
                     f"{k}): indices differ from the {name} version at "
                     f"{bad}")
            if not same_bits(torch, v, vp):
                fail(f"topk {label}: values differ from the {name} version "
                     f"in their bits")
            worst = max(worst, (v.float() - vp.float()).abs().max().item())
    return outs[0], worst


def tie_rows(torch, gen, rows, n, stride, end_chunk):
    """Rows whose k-th magnitude is a tie (1.0 at every ``stride``-th
    index, N(0, 0.1) elsewhere, 64 values of 2.0) and whose taken ties end
    in chunk ``end_chunk`` of TOPK_CHUNK elements: (x, k)."""
    from repro_torch.kernels import ref as kref
    x = torch.randn((rows, n), generator=gen, device="cuda") * 0.1
    x[:, ::stride] = 1.0
    big = torch.randperm(n, generator=gen, device="cuda")[:64]
    x[:, big] = -2.0
    ties = (x[0].abs() == 1.0).cumsum(0)
    cut = min(n, end_chunk * kref.TOPK_CHUNK + kref.TOPK_CHUNK // 2)
    return x, int((x[0].abs() == 2.0).sum()) + int(ties[cut - 1])


def phase_topk(torch):
    from repro_torch.comm.sparse import TopKReducer
    from repro_torch.kernels import _build
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import topk_compress as tkm
    k_for = TopKReducer(TOPK_RATIO).k_for
    gen = torch.Generator(device="cuda").manual_seed(6)

    def randn(rows, n):
        return torch.randn((rows, n), generator=gen, device="cuda")

    t0 = time.perf_counter()
    sizes = resnet18_leaf_sizes(torch)
    small_n, chunk = kref.TOPK_SMALL_N, kref.TOPK_CHUNK
    cases = [(f"fp32 n{n}", randn(TOPK_ROWS, n), k_for(n))
             for n in sorted(set(sizes))]
    cases += [("k=1", randn(TOPK_ROWS, 5120), 1),
              ("k=n", randn(TOPK_ROWS, 5120), 5120),
              ("large k=1", randn(4, 3 * chunk + 1), 1),
              ("large k=n", randn(4, 3 * chunk + 1), 3 * chunk + 1),
              ("bf16 ties", (randn(TOPK_ROWS, 36864) * 2).round()
               .to(torch.bfloat16), k_for(36864)),
              ("all zero", torch.zeros((TOPK_ROWS, 8192), device="cuda"),
               k_for(8192)),
              ("large all zero", torch.zeros((4, 3 * chunk + 5),
                                             device="cuda"), 1000)]
    ones = torch.sign(randn(TOPK_ROWS, 73728))
    ones[:, 40000] = 1e8
    cases.append(("+-1 and 1e8", ones, k_for(73728)))
    signed = torch.where(torch.rand((TOPK_ROWS, 5120), generator=gen,
                                    device="cuda") < 0.5, -0.0, 0.0)
    signed[:, ::9] = -torch.rand((TOPK_ROWS, len(range(0, 5120, 9))),
                                 generator=gen, device="cuda") - 0.5
    cases.append(("negatives and -0.0", signed, 700))
    big_signed = torch.where(torch.rand((4, 2 * chunk + 3), generator=gen,
                                        device="cuda") < 0.5, -0.0, 0.0)
    big_signed[:, ::5] = -1.5
    cases.append(("large negatives and -0.0", big_signed, chunk))
    cases.append(("subnormals", randn(TOPK_ROWS, 5120) * 1e-40, 256))
    cases.append(("large subnormals", randn(4, 100_003) * 1e-40, 5000))
    for end in (0, 2, 5):                 # where the taken ties end
        x, k = tie_rows(torch, gen, 4, 6 * chunk - 7, 3, end)
        cases.append((f"ties ending in chunk {end} of 6", x, k))
    for n in (small_n - 3, small_n - 2, small_n - 1, small_n, small_n + 1,
              small_n + 2, small_n + 3, 5 * chunk + 1, 5 * chunk + 2,
              5 * chunk + 3):
        cases.append((f"fp32 n{n}", randn(4, n), k_for(n)))
    for r in range(1, 8):                 # n = r (mod 8) in bf16
        for n in (small_n - 8 + r, 4 * chunk + r):
            cases.append((f"bf16 n{n}", (randn(4, n) * 4).round()
                          .to(torch.bfloat16), k_for(n)))
    cases.append(("bf16 grid, large", (randn(16, 150_001) * 8).round()
                  .to(torch.bfloat16), k_for(150_001)))
    big_n = 2 ** 24 + 3
    big = randn(2, big_n)
    big[:, 2 ** 24 + 1] = 1e3              # past 2^24: an fp32 index rounds
    n_big = len(cases)
    cases.append(("rows 2 n 2^24+3", big, k_for(big_n)))
    cases += [(f"rows {r} n {n}", randn(r, n), k_for(n)) for r, n in (
        (1, 64), (4, 100_000), (1, 300_001), (4, 17), (16, 65_536), (1, 9))]
    held, worst = [], 0.0
    for label, x, k in cases:
        out, err = topk_hold(torch, label, x, k)
        held.append(out)
        worst = max(worst, err)
    if 2 ** 24 + 1 not in held[n_big][1][0].tolist():
        fail("topk: the row past 2^24 did not select its outlier there")
    # the path without candidates (cap 0) and with at most one (cap 1),
    # on the large segments of up to 4 rows
    capped = [j for j, (_, x, _) in enumerate(cases)
              if x.shape[1] > small_n and x.shape[0] <= 4 and j != n_big]
    for cap in (0, 1):
        for j in capped:
            topk_hold(torch, f"{cases[j][0]} cap {cap}", *cases[j][1:],
                      cap=cap)
    # one grouped call per dtype over every case but the 2^24 one: small
    # and large segments at rows 1, 2, 4 and 16 together, each equal to
    # its own call bit for bit
    by_dtype = {}
    for j, (label, x, k) in enumerate(cases):
        if j != n_big:
            by_dtype.setdefault(x.dtype, []).append(j)
    for dtype, js in by_dtype.items():
        outs = tkm.topk_compress_many([cases[j][1] for j in js],
                                      [cases[j][2] for j in js])
        for j, (v, i) in zip(js, outs):
            if not (torch.equal(i, held[j][1]) and
                    same_bits(torch, v, held[j][0])):
                fail(f"topk {cases[j][0]}: the grouped call ({len(js)} "
                     f"{dtype} segments) differs from its own call")
    n_cases = len(cases)
    # a control that must fail: the look-back without eq_before, so every
    # chunk takes its ties as if none came before it
    src = (_build.CSRC / "topk_compress.cu").read_text()
    marker = "const int eq_before = s_before[1];"
    if src.count(marker) != 1:
        fail("topk control: marker not found once in csrc/topk_compress.cu")
    with tempfile.TemporaryDirectory() as tmp:
        lib = _build.build_variants(
            {"no_eq_before": src.replace(marker, "const int eq_before = 0;")},
            pathlib.Path(tmp), "topk")["no_eq_before"]
        kernel = tkm._lib
        tkm._lib = lambda: tkm.declare(lib)
        try:
            x, k = tie_rows(torch, gen, 4, 6 * chunk - 7, 3, 2)
            (v, i), = tkm.topk_compress_many([x], [k])
            vp, ip = kref.topk_compress_plain(x, k)
            torch.cuda.synchronize()
            if torch.equal(i, ip):
                fail("topk control without eq_before agrees with plain")
            control = int((i != ip).sum())
        finally:
            tkm._lib = kernel
    check_s = time.perf_counter() - t0
    del cases, held, big, ones, signed, big_signed, outs, x, v, i, vp, ip

    # one global fire of ResNet-18 (55 leaves, 16 learner rows each): per
    # leaf as before (55 calls, the L2 flushed before each) and as the
    # reducer runs it now, one grouped call
    fire = [randn(TOPK_ROWS, n) for n in sizes]
    ks = [k_for(n) for n in sizes]
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def per_leaf_ms(fn, reps):
        return fire_each_ms(torch, lambda xk: fn(*xk), list(zip(fire, ks)),
                            flush, reps)

    leaf_ms = per_leaf_ms(tkm.topk_compress, 5)
    readings, host_ms = fire_ms(
        torch, lambda: tkm.topk_compress_many(fire, ks), flush, 10)
    ms = statistics.median(readings)
    plain_ms = per_leaf_ms(kref.topk_compress_plain, 2)
    library, lib_host = fire_ms(
        torch, lambda: [torch.topk(x.abs(), k, sorted=False)
                        for x, k in zip(fire, ks)], flush, 5, strict=False)
    library_ms = statistics.median(library)
    nbytes = sum(x.numel() * x.element_size() + k * x.shape[0] * (
        x.element_size() + 4) for x, k in zip(fire, ks))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    launches = topk_trace_launches(torch, lambda: tkm.topk_compress_many(
        fire, ks))
    print(f"phase 6 topk: {n_cases} cases (the {len(set(sizes))} leaf sizes "
          f"of ResNet-18 at rows {TOPK_ROWS}, k=1, k=n, bf16 ties, all zero, "
          f"+-1 and 1e8, negatives and -0.0, subnormals, ties ending in "
          f"chunk 0, 2 and 5 of 6, n = 1..3 mod 4 (fp32) and 1..7 mod 8 "
          f"(bf16) at SMALL_N {small_n} and past it, rows 2 n 2^24+3), each "
          f"single and in one grouped call per dtype with small and large "
          f"segments at rows 1, 2, 4 and 16, candidate caps 0 and 1 on "
          f"{len(capped)} of them: bit-identical to topk_compress_plain and "
          f"topk_compress_radix_plain in {check_s:.2f}s; control without "
          f"eq_before differs in {control} indices")
    print(f"phase 6 topk ResNet-18 fire ({len(fire)} leaves x {TOPK_ROWS} "
          f"rows, fp32, L2 flushed): grouped ms={ms:.4f} (median; mean "
          f"{statistics.fmean(readings):.4f}; readings {fmt(readings)}, "
          f"host enqueue up to {host_ms:.3f} ms) "
          f"per_leaf_ms={fmt_ms(leaf_ms)} (55 calls, flushed before each) "
          f"plain_ms={fmt_ms(plain_ms)} (55 calls, flushed before each) "
          f"torch_topk_ms={library_ms:.4f} (median; mean "
          f"{statistics.fmean(library):.4f}; torch.topk(|x|, k, "
          f"sorted=False) per leaf after one flush, tie order unspecified; "
          f"host enqueue up to {lib_host:.3f} ms) bound_ms={bound_ms:.4f} (bytes, {nbytes} B) "
          f"launches_per_fire={launches} (profiler)")
    del fire
    rwkv = phase_topk_rwkv(torch, randn, k_for, flush)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "per_leaf_ms": leaf_ms,
            "rwkv_fire_ms": rwkv["ms"], "rwkv_fire_bound_ms": rwkv["bound_ms"],
            "rwkv_fire_library_ms": rwkv["library_ms"],
            "launches_per_fire": launches}


def topk_trace_launches(torch, fn) -> int:
    """Kernels whose name starts with topk_ in a profiler trace of fn."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda").add_(1)   # the trace's first kernel
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        kernels, _ = trace_kernels(prof, os.path.join(tmp, "topk.json.gz"))
    if not kernels:
        fail("topk: the profiler saw no kernel of the fire")
    return sum("topk_" in name for name, _, _, _ in kernels)


def phase_topk_rwkv(torch, randn, k_for, flush):
    """One global fire of rwkv6-1.6b at phase 12's size (25 leaves x 4
    learner rows, fp32, 7.85 GB) in the reducer's groups: each group held
    against the plain version, then the kernel's time against torch.topk
    and the bound.  Freed before it returns."""
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.topk_compress import topk_compress_many
    sizes = rwkv_leaf_sizes()
    fire = [randn(4, n) for n in sizes]
    ks = [k_for(n) for n in sizes]
    groups = topk_groups(sizes, 4)
    for g in groups:
        outs = topk_compress_many([fire[i] for i in g], [ks[i] for i in g])
        for i, (v, idx) in zip(g, outs):
            vp, ip = kref.topk_compress_plain(fire[i], ks[i])
            if not (torch.equal(idx, ip) and same_bits(torch, v, vp)):
                fail(f"topk rwkv fire leaf {i} (n {sizes[i]}) differs from "
                     f"the plain version")
            del vp, ip
        del outs

    def kernel_fire():
        for g in groups:
            topk_compress_many([fire[i] for i in g], [ks[i] for i in g])

    readings, host_ms = fire_ms(torch, kernel_fire, flush, 5)
    library, lib_host = fire_ms(
        torch, lambda: [torch.topk(x.abs(), k, sorted=False)
                        for x, k in zip(fire, ks)], flush, 3, strict=False)
    nbytes = sum(x.numel() * 4 + k * 4 * 8 for x, k in zip(fire, ks))
    out = {"ms": statistics.median(readings),
           "library_ms": statistics.median(library),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    print(f"phase 6 topk rwkv6-1.6b fire ({len(sizes)} leaves of "
          f"{RWKV_LAYERS} layers x 4 rows, fp32, {sum(sizes) * 16} B) in "
          f"{len(groups)} grouped calls (the reducer's 1 GiB groups), each "
          f"leaf bit-identical to plain: ms={out['ms']:.4f} (median; mean "
          f"{statistics.fmean(readings):.4f}; readings {fmt(readings)}, "
          f"host enqueue up to {host_ms:.3f} ms) "
          f"torch_topk_ms={out['library_ms']:.4f} (median; mean "
          f"{statistics.fmean(library):.4f}; host enqueue up to "
          f"{lib_host:.3f} ms) bound_ms="
          f"{out['bound_ms']:.4f} (bytes, {nbytes} B)")
    del fire
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- #
# phase 7: full-width Hier-AVG training


def trace_kernels(prof, path):
    """The device kernels of a torch.profiler run, from its Chrome trace:
    (name, start us, duration us, stream) each; and the host's CUDA
    runtime and driver calls, {name: summed duration us}."""
    prof.export_chrome_trace(path)
    with (gzip.open if path.endswith(".gz") else open)(path, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    api = {}
    for e in events:
        if e.get("ph") == "X" and str(e.get("cat", "")).lower() in (
                "cuda_runtime", "cuda_driver"):
            api[e["name"]] = api.get(e["name"], 0.0) + float(e["dur"])
    return [(e["name"], float(e["ts"]), float(e["dur"]),
             e.get("args", {}).get("stream"))
            for e in events
            if e.get("ph") == "X" and str(e.get("cat", "")).lower() == "kernel"
            ], api


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
    ("qint8", ("qint8_",)),
    ("batched_qr", ("batched_qr",)),
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


def resnet_task(torch):
    """ResNet-18 at width 64 on the seeded Gaussian-mixture task shaped as
    32x32x3 images: (loss_fn, init_fn, sample, eval batch of 512)."""
    from repro_torch.configs.resnet18_cifar import CNNConfig
    from repro_torch.data.synthetic import make_classification_task
    from repro_torch.models.resnet import resnet_init, resnet_loss

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = CNNConfig(width=64)
    task = make_classification_task(32 * 32 * 3, cfg.n_classes,
                                    device="cuda")

    def sample(gen, n):
        b = task(gen, n)
        return {"x": b["x"].reshape(n, 32, 32, 3), "y": b["y"]}

    def loss_fn(p, b):
        return resnet_loss(p, b, cfg)

    eval_batch = sample(torch.Generator(device="cuda").manual_seed(1), 512)
    return (loss_fn, lambda g: resnet_init(g, cfg, device="cuda"), sample,
            eval_batch)


def zero_counts(counters):
    """Set every kernel's launch count (and a grouped kernel's count of
    calls) to 0."""
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "calls"):
            fn.calls = 0


def read_counts(counters):
    """Each kernel's launch count, and NAME_calls for a grouped kernel's
    calls (top-k: one call serves the segments of a group)."""
    out = {name: fn.launches for name, fn in counters.items()}
    out.update({f"{name}_calls": fn.calls for name, fn in counters.items()
                if hasattr(fn, "calls")})
    return out


def train_rounds(torch, hier, counters, require_fall=True, seed=0):
    """Simulator.run(TRAIN_ROUNDS) at P = 16 as (1, 4, 4), sgd(0.1), 32
    examples per learner per step (init and data from ``seed``), with
    every launch count in
    ``counters`` set to 0 just before and read just after.  Fails unless
    the losses are finite and (with ``require_fall``) the eval loss
    falls."""
    from repro_torch.core.simulator import Simulator
    from repro_torch.core.topology import HierTopology
    from repro_torch.optim import sgd

    loss_fn, init_fn, sample, eval_batch = resnet_task(torch)
    sim = Simulator(loss_fn, init_fn, sample, topo=HierTopology(1, 4, 4),
                    hier=hier, optimizer=sgd(0.1), per_learner_batch=32,
                    eval_batch=eval_batch, seed=seed, device="cuda")
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
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    t0 = time.perf_counter()
    res = sim.run(TRAIN_ROUNDS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sim.round_fn = round_fn
    for name in ("losses", "eval_losses", "eval_accs", "grad_sq_norms"):
        if not np_isfinite(getattr(res, name)):
            fail(f"training {name} not finite: {getattr(res, name)}")
    if require_fall and not res.eval_losses[-1] < res.eval_losses[0]:
        fail(f"eval loss did not fall: {res.eval_losses}")
    return sim, res, loss_fn, walls, run_s, launches, peak


def wall_ms(torch, fn, reps=3):
    """Mean host wall of fn across a synchronize, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def round_parts(torch, sim, res, loss_fn):
    """The parts of a round, each across a synchronize: one SGD step on all
    learners, and one fire of each plan level (its resolved reducer on the
    trained state)."""
    from repro_torch.comm import reduce_with
    from repro_torch.core.hier_avg import make_sgd_step
    from repro_torch.core.topology import average_over
    from repro_torch.optim import sgd

    batch = sim._round_batch(torch.Generator(device="cuda").manual_seed(7))
    step_batch = {k: v[(0,) * len(sim.plan.batch_dims)]
                  for k, v in batch.items()}
    step = make_sgd_step(loss_fn, sgd(0.1))
    state = res.state
    parts = {"step": wall_ms(torch, lambda: step(state, step_batch))}
    for lvl in sim.plan.levels:
        cs = state.comm_state[lvl.name] if lvl.reducer.stateful else ()
        parts[lvl.name] = wall_ms(torch, lambda lvl=lvl, cs=cs: reduce_with(
            lvl.reducer, lambda t, cf=None, lvl=lvl: average_over(
                t, lvl.axes), state.params, cs))
    return parts


def rounds_from(torch, loss_fn, hier, plan, np_state, batches, masks=None,
                walls=None):
    """Rounds of ``plan`` from a converted state: (state, losses).  With
    ``masks`` (one ``[n_levels, pods, G, S]`` mask a round) the rounds are
    elastic; ``walls``, a list, receives each round's wall in ms across a
    synchronize."""
    from repro_torch.convert import train_state_from_jax
    from repro_torch.core.hier_avg import make_hier_round
    from repro_torch.optim import sgd

    rnd = make_hier_round(loss_fn, sgd(0.1), hier, plan=plan,
                          elastic=masks is not None)
    state = train_state_from_jax(np_state, device="cuda")
    losses = []
    for i, b in enumerate(batches):
        if walls is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = rnd(state, b) if masks is None else rnd(state, b, masks[i])
        if walls is not None:
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"])
    return state, torch.stack(losses)


def plain_plan(plan):
    """``plan`` with every codec on its plain PyTorch version."""
    import dataclasses

    from repro_torch.comm import get_reducer
    from repro_torch.core.plan import ReductionPlan
    return ReductionPlan(tuple(
        dataclasses.replace(lvl, reducer=get_reducer(
            lvl.reducer.describe(), **({} if lvl.reducer.name == "mean"
                                       else {"impl": "plain"})))
        for lvl in plan.levels))


def differing(torch, ka, kb, la, lb):
    """(state leaves (params, EF) and loss vectors that differ in a bit,
    pairs compared)."""
    pairs = state_pairs(ka, kb) + [(la, lb)]
    return sum(not same_bits(torch, a, b) for a, b in pairs), len(pairs)


def state_pairs(ka, kb):
    """(kernel, plain) tensor pairs of two TrainStates: params, then every
    reducer state leaf (EF ref/err, PowerSGD q, RNG carries)."""
    from repro_torch.tree import leaves
    pairs = list(zip(leaves(ka.params), leaves(kb.params)))
    for name in sorted(ka.comm_state or {}):
        pairs += list(zip(leaves(ka.comm_state[name]),
                          leaves(kb.comm_state[name])))
    return pairs


def profile_round(torch, rnd, state, batch, label, classes, ops=False,
                  host_ops=True, wall_ms=None, keep=False):
    """Device time of one round by kernel class (torch.profiler's Chrome
    trace), and the idle share against an unprofiled round's wall; with
    ``ops``, the PyTorch operators whose kernels took the most time
    (``key_averages``, which takes seconds on a large trace).  No
    warm-up round: every caller's earlier rounds warmed the card.
    ``host_ops`` False: the trace records the device and the CUDA
    API only, not each operator on the host (a round of ~10^5 eager calls
    exports in a fraction of the time); ``wall_ms``: the unprofiled wall
    of the same round, measured by the caller (no timed round here);
    ``keep``: return (kernels, the profiled round's (state, metrics))."""
    from torch.profiler import ProfilerActivity, profile

    if wall_ms is None:
        t0 = time.perf_counter()
        rnd(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    wall_us = wall_ms * 1e3
    with profile(activities=[ProfilerActivity.CPU] * host_ops
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = rnd(state, batch)
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        kernels, api = trace_kernels(prof, os.path.join(tmp, "round.json"))
    if not kernels:
        print(f"{label} profile: the profiler saw no device time "
              f"(device breakdown not measured)")
        return (None, out) if keep else None
    busy = busy_us(kernels)
    by = by_class(kernels, classes)
    summed = sum(by.values())
    streams = sorted({str(k[3]) for k in kernels})
    print(f"{label} profile ({len(kernels)} kernels on streams {streams}): "
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
    print(f"{label} top device kernels (ms per round): " + " | ".join(
        f"{k[:70]} {v / 1e3:.3f}" for v, k in top))
    if ops:
        top_ops = sorted(((getattr(ev, "self_device_time_total", 0.0), ev.key)
                          for ev in prof.key_averages()
                          if ev.key.startswith("aten::")), reverse=True)[:8]
        print(f"{label} top operators by their kernels' time (ms per "
              f"round): " + " | ".join(f"{k} {v / 1e3:.3f}"
                                       for v, k in top_ops if v > 0))
    # host time in the allocator's runtime and driver calls (a free or a
    # map waits for the device) against the rest of the API
    mem = sum(v for k, v in api.items() if any(w in k for w in (
        "Malloc", "Free", "MemMap", "MemUnmap", "MemCreate", "MemRelease",
        "MemSetAccess", "MemAddress")))
    top_api = sorted(((v, k) for k, v in api.items()), reverse=True)[:4]
    print(f"{label} host CUDA API (ms per profiled round): memory calls "
          f"{mem / 1e3:.3f}; top: " + " | ".join(
              f"{k} {v / 1e3:.3f}" for v, k in top_api))
    return (kernels, out) if keep else kernels


def phase_train(torch):
    from repro_torch.configs.base import HierAvgParams
    from repro_torch.convert import train_state_to_numpy
    from repro_torch.core.hier_avg import make_hier_round
    from repro_torch.core.plan import ReductionPlan
    from repro_torch.kernels.topk_compress import topk_compress as tk
    from repro_torch.optim import sgd
    from repro_torch.tree import leaves, tree_map

    hier = HierAvgParams(plan=TRAIN_PLAN, bucket_bytes=0)
    sim, res, loss_fn, walls, run_s, launches, peak = train_rounds(
        torch, hier, {"topk_compress": tk})
    calls = launches["topk_compress_calls"]
    launches = launches["topk_compress"]
    n_leaves = len(leaves(res.state.params))
    n_params = sum(p[0, 0, 0].numel() for p in leaves(res.state.params))
    if launches != n_leaves * TRAIN_ROUNDS or calls != TRAIN_ROUNDS:
        fail(f"topk_compress launches {launches} != {n_leaves} leaves x "
             f"{TRAIN_ROUNDS} global fires, or its calls {calls} != one "
             f"grouped call a fire")
    parts = round_parts(torch, sim, res, loss_fn)
    # yardstick: the local mean by torch.mean (whose reduction order is
    # not fixed), timed the same way in the same run
    torch_mean_ms = wall_ms(torch, lambda: tree_map(
        lambda x: torch.mean(x, dim=(2,), keepdim=True).expand_as(x).clone(),
        res.state.params))
    print(f"phase 7 train resnet18 width 64 ({n_params} params per learner, "
          f"{n_leaves} leaves) P=16 (1, 4, 4) plan "
          f"{sim.plan.describe()} sgd(0.1) 32 per learner per step: "
          f"rounds={TRAIN_ROUNDS} in {run_s:.2f}s train_loss="
          f"{fmt(res.losses)} eval_loss={fmt(res.eval_losses)} eval_acc="
          f"{fmt(res.eval_accs)} round_wall_ms={fmt(walls)} "
          f"step_wall_ms={parts['step']:.3f} local_mean_ms="
          f"{parts['local']:.3f} (torch.mean yardstick {torch_mean_ms:.3f}) "
          f"global_topk_reduction_ms="
          f"{parts['global']:.3f} peak_mem_gib={peak:.2f} "
          f"topk_launches={launches} (leaves served) in {calls} grouped "
          f"calls")

    # kernel against plain, through the whole trainer: 2 rounds from one
    # converted state on the same batches
    np_state = train_state_to_numpy(res.state)
    gen = torch.Generator(device="cuda").manual_seed(8)
    batches = [sim._round_batch(gen) for _ in range(2)]
    plan = ReductionPlan.parse(TRAIN_PLAN)
    sk, lk = rounds_from(torch, loss_fn, hier, plan, np_state, batches)
    sp, lp = rounds_from(torch, loss_fn, hier, plain_plan(plan), np_state,
                         batches)
    differ, n = differing(torch, sk, sp, lk, lp)
    if differ:
        fail(f"kernel and plain top-k trajectories differ: {differ} of "
             f"{n} state leaves and losses, losses {lk.tolist()} vs "
             f"{lp.tolist()}")
    print(f"phase 7 kernel vs plain top-k: 2 rounds from one converted "
          f"state, {n - 1} params/EF leaves and the losses "
          f"{fmt(lk.tolist())} bit-identical")
    del sk, sp, np_state

    kernels = profile_round(torch, make_hier_round(loss_fn, sgd(0.1), hier),
                            res.state, batches[0],
                            "phase 7 (one round, 8 steps + 4 local means + 1 "
                            "global top-k)", TRAIN_CLASSES)
    per_fire = sum("topk_" in name for name, _, _, _ in kernels or [])
    if kernels and not 0 < per_fire <= TOPK_LAUNCHES_PER_FIRE:
        fail(f"phase 7: {per_fire} top-k kernels in the profiled round's "
             f"one global fire (limit {TOPK_LAUNCHES_PER_FIRE})")
    print(f"phase 7 trace: {per_fire} top-k kernel launches in the round's "
          f"one global fire (limit {TOPK_LAUNCHES_PER_FIRE})" if kernels else
          "phase 7 trace: top-k launches per fire not measured (no trace)")
    return launches, calls, walls, parts["global"]


def mean_cast_bit_identity(torch, params):
    """Bucketed and pipelined mean and cast:bfloat16 against the per-leaf
    path on a full-width state, bit for bit (the reference's contract).
    Also counts the leaves where a ``torch.mean`` over the learner axes of
    the packed buckets differs from one over the leaves: why the port sums
    in a fixed order (core/topology.py ordered_means)."""
    from repro_torch.comm import (Bucketed, BucketLayout, Pipelined,
                                  get_reducer, reduce_with)
    from repro_torch.core.topology import average_over
    from repro_torch.tree import leaves

    checked = torch_mean_differs = 0
    for axes in ((2,), (0, 1, 2)):
        def avg(t, cf=None, axes=axes):
            return average_over(t, axes)
        for spec in ("mean", "cast:bfloat16"):
            want, _ = reduce_with(get_reducer(spec), avg, params, ())
            for engine in (Bucketed, Pipelined):
                got, _ = reduce_with(engine(get_reducer(spec)), avg, params,
                                     ())
                for a, b in zip(leaves(got), leaves(want)):
                    if not same_bits(torch, a, b):
                        fail(f"{engine.__name__} {spec} over axes {axes} "
                             f"differs from the per-leaf path in its bits")
                    checked += 1
            del want, got
        lay = BucketLayout.build(params)
        per_leaf = [torch.mean(x, dim=axes, keepdim=True)
                    for x in leaves(params)]
        packed = lay.unpack([torch.mean(b, dim=axes, keepdim=True)
                             for b in lay.pack(params)])
        torch_mean_differs += sum(not same_bits(torch, a, b) for a, b in
                                  zip(leaves(packed), per_leaf))
        del per_leaf, packed
    return checked, torch_mean_differs


def psgd_readings(torch, sa, sb, la, lb):
    """max|a - b| / max|b| of two PowerSGD trajectories (state, losses) over
    the losses, over all params at once, over the worst params leaf, and
    over each part of the PowerSGD state (EF ref and err, warm-start Q)."""
    from repro_torch.tree import leaves

    def rel(pairs):
        num = max((a.float() - b.float()).abs().max().item()
                  for a, b in pairs)
        den = max(b.float().abs().max().item() for _, b in pairs)
        return num / max(den, 1e-30)

    params = list(zip(leaves(sa.params), leaves(sb.params)))
    ca, cb = sa.comm_state["global"], sb.comm_state["global"]
    return {"losses": rel([(la, lb)]), "params": rel(params),
            "params_worst_leaf": max(rel([pr]) for pr in params),
            **{part: rel(list(zip(leaves(getattr(ca, part)),
                                  leaves(getattr(cb, part)))))
               for part in ("ref", "err", "q")}}


def within_psgd_limits(read) -> bool:
    return (read["losses"] <= PSGD_LOSS_TOL
            and read["params"] <= PSGD_PARAM_TOL)


def fmt_read(read) -> str:
    return " ".join(f"{k}={v:.3e}" for k, v in read.items())


@contextlib.contextmanager
def qr_replaced(fn):
    """Every PowerSGD orthonormalization inside goes through ``fn(p)``, a
    panel stack at a time (comm/lowrank.py calls kernels/ops.py's
    batched_qr_many by attribute)."""
    from repro_torch.kernels import ops
    saved = ops.batched_qr_many
    ops.batched_qr_many = lambda ps, impl="auto": [fn(p) for p in ps]
    try:
        yield
    finally:
        ops.batched_qr_many = saved


def qr_fp64(torch, p):
    """Q of p by Householder QR in fp64, column signs as Gram-Schmidt's
    (diag R > 0)."""
    q, r = torch.linalg.qr(p.double())
    return q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1)).unsqueeze(-2)


def psgd_witnesses(torch, loss_fn, hier, plan, np_state, batches):
    """Plan B's kernel trajectory, recording on each of its panels the
    singular-value ratio and the kernel's and the plain version's distance
    from an fp64 QR; then the trajectories of QR in fp64 (rounded to fp32),
    of a one-pass CGS, and of a control that skips the projection, each
    read against the plain one by the caller."""
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.batched_qr import batched_qr as kernel_qr

    panels = {"sigma2_over_sigma1": [], "kernel_vs_fp64": [],
              "plain_vs_fp64": [], "control_vs_fp64": []}

    def recording(p):
        q = kernel_qr(p)
        sv = torch.linalg.svdvals(p.double())
        q64 = qr_fp64(torch, p)
        panels["sigma2_over_sigma1"].append(
            (sv[..., 1] / sv[..., 0]).tolist())
        for key, qq in (("kernel_vs_fp64", q),
                        ("plain_vs_fp64", kref.batched_qr_plain(p)),
                        ("control_vs_fp64", no_projection(torch, p))):
            panels[key].append((qq.double() - q64).abs().max().item())
        return q

    runs = {}
    for label, fn in (("kernel", recording),
                      ("fp64", lambda p: qr_fp64(torch, p).to(p.dtype)),
                      ("one_pass", lambda p: kref.batched_qr_plain(
                          p, passes=1)),
                      ("no_projection", lambda p: no_projection(torch, p))):
        with qr_replaced(fn):
            runs[label] = rounds_from(torch, loss_fn, hier, plan, np_state,
                                      batches)
    ratios = [v for fire in panels["sigma2_over_sigma1"] for v in fire]

    def beyond(key):
        """Panel stacks where ``key``'s Q is outside the fp64 limit."""
        return sum(d > QR_FP64_FACTOR * pl + QR_FP64_FLOOR for d, pl in
                   zip(panels[key], panels["plain_vs_fp64"]))

    return runs, {"panels": len(ratios), "stacks": len(panels[
                      "kernel_vs_fp64"]),
                  "sigma2_over_sigma1": (min(ratios), max(ratios)),
                  "kernel_vs_fp64": max(panels["kernel_vs_fp64"]),
                  "plain_vs_fp64": max(panels["plain_vs_fp64"]),
                  "control_vs_fp64": max(panels["control_vs_fp64"]),
                  "kernel_beyond": beyond("kernel_vs_fp64"),
                  "control_beyond": beyond("control_vs_fp64")}


def no_projection(torch, p):
    """A control QR: each column normalized, none projected out."""
    return p / torch.linalg.vector_norm(p, dim=-2, keepdim=True)


def phase_codec_train(torch):
    """Phase 9: plans A, B and C under the default bucketing (PowerSGD
    per leaf in plan C, the reducer's default layout); returns the launch
    counts of each kernel on its plan's main path, summed over plans, and
    each plan's global fire wall (ms) by tag."""
    from repro_torch.configs.base import HierAvgParams
    from repro_torch.convert import train_state_to_numpy
    from repro_torch.core.hier_avg import make_hier_round
    from repro_torch.core.plan import ReductionPlan
    from repro_torch.kernels.batched_qr import batched_qr as bq
    from repro_torch.kernels.qint8_pack import qint8_pack as qp
    from repro_torch.kernels.qint8_pack import qint8_unpack as qu
    from repro_torch.kernels.topk_compress import topk_compress as tk
    from repro_torch.optim import sgd
    from repro_torch.tree import leaves

    counters = {"qint8_pack": qp, "qint8_unpack": qu, "topk_compress": tk,
                "batched_qr": bq}
    # buckets per fire on the uniform layout x fires in the 3 rounds
    # (Pipelined hands the top-k and QR kernels one bucket a call); plan C
    # makes one grouped QR call a fire for every compressible leaf
    none = {"qint8_pack": 0, "qint8_unpack": 0, "topk_compress": 0,
            "topk_compress_calls": 0, "batched_qr": 0,
            "batched_qr_calls": 0}
    expect = {CODEC_PLANS[0]: {**none, "qint8_pack": 10 * 4 * TRAIN_ROUNDS,
                               "qint8_unpack": 10 * 4 * TRAIN_ROUNDS,
                               "topk_compress": 10 * TRAIN_ROUNDS,
                               "topk_compress_calls": 10 * TRAIN_ROUNDS},
              CODEC_PLANS[1]: {**none, "batched_qr": 10 * TRAIN_ROUNDS,
                               "batched_qr_calls": 10 * TRAIN_ROUNDS},
              CODEC_PLANS[2]: {**none,
                               "batched_qr": RESNET_PSGD_LEAVES * TRAIN_ROUNDS,
                               "batched_qr_calls": TRAIN_ROUNDS}}
    out, fires = {}, {}
    for tag, spec in zip("ABC", CODEC_PLANS):
        hier = HierAvgParams(plan=spec)        # default bucketing
        # plan C's eval loss need not fall in 3 rounds (per-leaf PowerSGD at
        # rank 2 read 2.748, 2.571, 2.754 on an H100 with the earlier QR
        # kernel too, PERF.md section 6): its kernel trajectory is held to
        # the plain one below instead
        sim, res, loss_fn, walls, run_s, launches, peak = train_rounds(
            torch, hier, counters, require_fall=tag != "C")
        if launches != expect[spec]:
            fail(f"plan {tag} {spec}: launches {launches} != "
                 f"{expect[spec]}")
        for k, v in launches.items():
            out[k] = out.get(k, 0) + v
        parts = round_parts(torch, sim, res, loss_fn)
        fires[tag] = parts["global"]
        layouts = "; ".join(
            f"{lvl.name}: {lvl.reducer.layout_for(res.state.params).describe()}"
            for lvl in sim.plan.levels if hasattr(lvl.reducer, "layout_for"))
        print(f"phase 9{tag} train resnet18 width 64 P=16 (1, 4, 4) plan "
              f"{sim.plan.describe()} (default bucketing: "
              f"{hier.bucket_bytes} B, overlap {hier.overlap}; {layouts}) "
              f"sgd(0.1) 32 per learner per step: rounds={TRAIN_ROUNDS} in "
              f"{run_s:.2f}s train_loss={fmt(res.losses)} eval_loss="
              f"{fmt(res.eval_losses)} eval_acc={fmt(res.eval_accs)} "
              f"round_wall_ms={fmt(walls)} step_wall_ms={parts['step']:.3f} "
              + " ".join(f"{lvl.name}_fire_ms={parts[lvl.name]:.3f}"
                         for lvl in sim.plan.levels)
              + f" peak_mem_gib={peak:.2f} launches={launches}")
        if tag == "A":
            checked, differs = mean_cast_bit_identity(torch, res.state.params)
            print(f"phase 9A mean/cast: Bucketed and Pipelined mean and "
                  f"cast:bfloat16, local and global, equal the per-leaf "
                  f"path bit for bit on the trained full-width state "
                  f"({checked} leaf comparisons); torch.mean over packed "
                  f"buckets differs from torch.mean over the leaves in "
                  f"{differs} of {2 * len(leaves(res.state.params))} leaves")

        # kernel against plain through the whole trainer: 2 rounds from one
        # converted state on the same batches
        np_state = train_state_to_numpy(res.state)
        gen = torch.Generator(device="cuda").manual_seed(8)
        batches = [sim._round_batch(gen) for _ in range(2)]
        plan = ReductionPlan.parse(spec)
        sp, lp = rounds_from(torch, loss_fn, hier, plain_plan(plan),
                             np_state, batches)
        if tag == "A":
            sk, lk = rounds_from(torch, loss_fn, hier, plan, np_state,
                                 batches)
            differ, n = differing(torch, sk, sp, lk, lp)
            if differ:
                fail(f"plan A kernel and plain trajectories differ in "
                     f"{differ} of {n} state leaves and losses")
            print(f"phase 9A kernel vs plain (qint8 and top-k): 2 rounds "
                  f"from one converted state, {n} params/EF "
                  f"leaves and the losses {fmt(lk.tolist())} bit-identical")
            del sk
        elif tag == "C":
            # the kernel's grouped calls as the trainer makes them, and the
            # control without projection, against the plain QR
            runs = {"kernel": rounds_from(torch, loss_fn, hier, plan,
                                          np_state, batches)}
            with qr_replaced(lambda p: no_projection(torch, p)):
                runs["no_projection"] = rounds_from(torch, loss_fn, hier,
                                                    plan, np_state, batches)
            lk = runs["kernel"][1]
            read = {label: psgd_readings(torch, run[0], sp, run[1], lp)
                    for label, run in runs.items()}
            del runs
            if not within_psgd_limits(read["kernel"]):
                fail(f"plan C kernel vs plain QR after 2 rounds: "
                     f"{read['kernel']} (limits: losses {PSGD_LOSS_TOL}, "
                     f"params {PSGD_PARAM_TOL})")
            if within_psgd_limits(read["no_projection"]):
                fail(f"plan C control QR without projection reads "
                     f"{read['no_projection']} against plain, within the "
                     f"limits: they would not fail a wrong QR")
            print(f"phase 9C kernel vs plain QR (one grouped call a fire): "
                  f"2 rounds from one converted state, losses "
                  f"{fmt(lk.tolist())} vs {fmt(lp.tolist())}; max|kernel - "
                  f"plain| / max|plain| per part: {fmt_read(read['kernel'])} "
                  f"(held: losses <= {PSGD_LOSS_TOL}, params <= "
                  f"{PSGD_PARAM_TOL}); control without projection "
                  f"{fmt_read(read['no_projection'])} (must fail)")
        else:
            runs, panels = psgd_witnesses(torch, loss_fn, hier, plan,
                                          np_state, batches)
            lk = runs["kernel"][1]
            read = {label: psgd_readings(torch, run[0], sp, run[1], lp)
                    for label, run in runs.items()}
            read["kernel_vs_fp64"] = psgd_readings(
                torch, runs["kernel"][0], runs["fp64"][0], lk,
                runs["fp64"][1])
            del runs
            lo, hi = panels["sigma2_over_sigma1"]
            print(f"phase 9B kernel vs plain QR: 2 rounds from one "
                  f"converted state, losses {fmt(lk.tolist())} vs "
                  f"{fmt(lp.tolist())}; max|kernel - plain| / max|plain| "
                  f"per part: {fmt_read(read['kernel'])} (held: losses <= "
                  f"{PSGD_LOSS_TOL}, params <= {PSGD_PARAM_TOL})")
            print(f"phase 9B witnesses: on the kernel run's {panels['panels']}"
                  f" panels sigma2/sigma1 in [{lo:.3e}, {hi:.3e}], max|Q - "
                  f"Q_fp64| kernel {panels['kernel_vs_fp64']:.3e} plain "
                  f"{panels['plain_vs_fp64']:.3e}; trajectories against "
                  f"plain: fp64 QR {fmt_read(read['fp64'])}; one-pass CGS "
                  f"{fmt_read(read['one_pass'])}; control without "
                  f"projection {fmt_read(read['no_projection'])} (must "
                  f"fail); kernel against fp64 QR "
                  f"{fmt_read(read['kernel_vs_fp64'])}")
            print(f"phase 9B QR against fp64 on the trainer's "
                  f"{panels['stacks']} panel stacks (held: max|Q - Q_fp64| "
                  f"<= {QR_FP64_FACTOR} x plain's + {QR_FP64_FLOOR:.3e} per "
                  f"stack): kernel {panels['kernel_vs_fp64']:.3e}, outside "
                  f"on {panels['kernel_beyond']} stacks; control without "
                  f"projection {panels['control_vs_fp64']:.3e}, outside on "
                  f"{panels['control_beyond']} (must be outside)")
            if panels["kernel_beyond"]:
                fail(f"plan B: the kernel's Q is further from an fp64 QR "
                     f"than {QR_FP64_FACTOR} x the plain CGS2's + "
                     f"{QR_FP64_FLOOR:.3e} on {panels['kernel_beyond']} of "
                     f"{panels['stacks']} panel stacks")
            if not panels["control_beyond"]:
                fail("plan B: the control QR without projection is within "
                     "the fp64 limit on every panel stack: it would not "
                     "fail a wrong QR")
            if not within_psgd_limits(read["kernel"]):
                fail(f"plan B kernel vs plain QR after 2 rounds: "
                     f"{read['kernel']} (limits: losses {PSGD_LOSS_TOL}, "
                     f"params {PSGD_PARAM_TOL})")
            if within_psgd_limits(read["no_projection"]):
                fail(f"plan B control QR without projection reads "
                     f"{read['no_projection']} against plain, within the "
                     f"limits: they would not fail a wrong QR")
        del sp, np_state
        profile_round(torch, make_hier_round(loss_fn, sgd(0.1), hier),
                      res.state, batches[0],
                      f"phase 9{tag} (one round, 8 steps + 4 local + 1 "
                      f"global fire)", TRAIN_CLASSES)
        del sim, res, batches
        torch.cuda.empty_cache()
    return out, fires


# --------------------------------------------------------------------- #
# phase 8: qint8 pack/unpack and batched QR against their plain versions


def qint8_edge_rows(torch):
    """The CPU test's edge cases (tests/test_torch_codecs.py) on the card,
    as [rows, 32] fp32 with block 8: all-zero blocks, values exactly
    k + 0.5 steps (scale 2^-3), +-absmax, signed zeros, subnormals, 1e30."""
    amax = 127 / 8
    ties = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    tie_block = [t * 0.125 for t in ties] + [amax]
    specials = [3.0, -3.0, -0.0, 0.0, 1e-40, -1e-41, 1e-45, 2.0]
    big = [1e30, -1e30, 1e29, 1.0, -0.0, 1e-40, 5e29, -7e29]
    rows = [[0.0] * 32,
            tie_block + [-t for t in tie_block]
            + [-t for t in tie_block[::-1]] + tie_block,
            specials + big + [-v for v in specials] + big[::-1]]
    return torch.tensor(rows, dtype=torch.float32, device="cuda")


def phase_codecs(torch):
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    gen = torch.Generator(device="cuda").manual_seed(13)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    # qint8: bit for bit, every leaf size of ResNet-18 at 16 rows, the
    # bucket row, other blocks (255: byte stores), bf16 input, edge values
    sizes = sorted(set(resnet18_leaf_sizes(torch)))
    cases = [(f"n{n}", randn(TOPK_ROWS, n) * 3, QINT8_BLOCK) for n in sizes]
    cases += [("bucket row", randn(TOPK_ROWS, 2_359_296), QINT8_BLOCK),
              ("block 255", randn(TOPK_ROWS, 70_000) * 1e3, 255),
              ("block 128 n 1000", randn(TOPK_ROWS, 1000) * 1e-3, 128),
              ("rows 1 n 1", randn(1, 1), 255),
              ("bf16", randn(TOPK_ROWS, 36864).to(torch.bfloat16), 256),
              ("edge values", qint8_edge_rows(torch), 8),
              ("edge values n 29", qint8_edge_rows(torch)[:, :29]
               .contiguous(), 8)]
    t0 = time.perf_counter()
    worst_q = worst_u = 0.0
    for label, x, block in cases:
        n = x.shape[1]
        w = kops.qint8_pack(x, block, impl="kernel")
        wp = kops.qint8_pack(x, block, impl="plain")
        u = kops.qint8_unpack(w, n, impl="kernel")
        up = kops.qint8_unpack(wp, n, impl="plain").contiguous()
        torch.cuda.synchronize()
        if not torch.equal(w, wp):
            bad = (w != wp).nonzero()[:4].tolist()
            fail(f"qint8_pack {label} (rows {x.shape[0]} n {n} block "
                 f"{block}): wire differs from the plain version at {bad}")
        if not same_bits(torch, u, up):
            fail(f"qint8_unpack {label}: values differ from the plain "
                 f"version in their bits")
        worst_q = max(worst_q, (w.int() - wp.int()).abs().max().item())
        worst_u = max(worst_u, (u - up).abs().max().item())
    ties = kops.qint8_pack(qint8_edge_rows(torch), 8, impl="kernel")
    if ties[1, 0, :7].tolist() != [0, 2, 2, 0, -2, -2, 126]:
        fail(f"qint8_pack did not round the ties half to even: "
             f"{ties[1, 0, :7].tolist()}")
    qint8_check_s = time.perf_counter() - t0
    del cases, w, wp, u, up
    print(f"phase 8 codecs: qint8 pack/unpack bit-identical to plain at the "
          f"{len(sizes)} leaf sizes of ResNet-18 (16 rows, block 256), the "
          f"bucket row [16, 2359296], block 255, block 128, bf16 input, "
          f"ties (half to even), zeros, signed zeros, subnormals, 1e30 in "
          f"{qint8_check_s:.2f}s")

    # times of one local qint8 fire on the uniform layout (10 buckets of
    # [16, 2359296]), L2 flushed before every launch
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    buckets = [randn(TOPK_ROWS, 2_359_296) for _ in range(10)]
    wires = [kops.qint8_pack(b, QINT8_BLOCK, impl="kernel") for b in buckets]

    n = buckets[0].shape[1]
    pack_ms = fire_each_ms(torch, lambda x: kops.qint8_pack(
        x, QINT8_BLOCK, impl="kernel"), buckets, flush, 5)
    pack_plain = fire_each_ms(torch, lambda x: kops.qint8_pack(
        x, QINT8_BLOCK, impl="plain"), buckets, flush, 2)
    unpack_ms = fire_each_ms(torch, lambda w: kops.qint8_unpack(
        w, n, impl="kernel"), wires, flush, 5)
    unpack_plain = fire_each_ms(torch, lambda w: kops.qint8_unpack(
        w, n, impl="plain"), wires, flush, 2)
    qint8_bytes = sum(b.numel() * 4 + w.numel() for b, w in
                      zip(buckets, wires))
    qint8_bound = qint8_bytes / HBM_BYTES_PER_S * 1e3
    print(f"phase 8 qint8 times (one local fire, 10 launches, L2 flushed "
          f"before each): qint8_pack ms={fmt_ms(pack_ms)} plain_ms="
          f"{fmt_ms(pack_plain)} bound_ms={qint8_bound:.4f} (bytes, "
          f"{qint8_bytes} B); qint8_unpack ms={fmt_ms(unpack_ms)} plain_ms="
          f"{fmt_ms(unpack_plain)} bound_ms={qint8_bound:.4f}; no single "
          f"PyTorch call computes either")
    del buckets, wires
    torch.cuda.empty_cache()
    qr = phase_qr(torch, randn, flush)
    del flush
    torch.cuda.empty_cache()
    base = {"library_ms": None}
    return ({**base, "max_abs_err": worst_q, "ms": pack_ms,
             "plain_ms": pack_plain, "bound_ms": qint8_bound,
             "bound_by": "bytes"},
            {**base, "max_abs_err": worst_u, "ms": unpack_ms,
             "plain_ms": unpack_plain, "bound_ms": qint8_bound,
             "bound_by": "bytes"},
            qr)


def fire_each_ms(torch, fn, items, flush, reps, sleep=100_000) -> Ms:
    """A fire of one call per item, each call timed after its own flush:
    the readings are the fires' sums.  Read again after a sleep ten times
    as long where their mean and median differ, as time_ms does."""
    fn(items[0])
    torch.cuda.synchronize()
    fires = [[time_ms(torch, lambda: fn(it), flush, 1, sleep)
              for it in items] for _ in range(reps)]
    ms = Ms([sum(f) for f in fires], sleep,
            sum(t.late for f in fires for t in f), timed=reps * len(items))
    if reps > 1 and ms.spread() and sleep < 10 * LONG_SLEEP_CYCLES:
        again = fire_each_ms(torch, fn, items, flush, reps, 10 * sleep)
        return Ms(again.readings, again.sleep, again.late, short=ms,
                  timed=again.timed)
    return ms


def qr_fires():
    """Phase 8's grouped QR calls, (label, segments): the Pipelined
    PowerSGD fire's 10 buckets as one call, one ResNet-18 and one
    rwkv6-1.6b (phase 12's size) per-leaf fire at rank 2."""
    return [("(ii) 10 buckets", [(16, 1536, 2)] * 10),
            ("(iii) resnet18 per leaf", list(RESNET_QR_FIRE)),
            ("(iv) rwkv6 per leaf", list(RWKV_QR_FIRE))]


def qr_bound_ms(shapes) -> float:
    """Least time for the QR of these panels: each byte read once and
    written once over HBM bandwidth (the operations are far below it)."""
    return sum(2 * b * a * r * 4 for b, a, r in shapes) / HBM_BYTES_PER_S * 1e3


def phase_qr(torch, randn, flush):
    """Phase 8's batched QR: the kernel against its plain version (raw Q
    within QR_TOL), against batched_qr_blocked_plain (its arithmetic,
    within QR_EMU_ULPS; a control on another schedule must fail that),
    grouped calls against single-panel calls bit for bit, and projector
    and orthonormality against torch.linalg.qr; a zero column and a panel
    of condition 1e6; then the times of fires (i)-(v)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.batched_qr import batched_qr_many, panel_plan

    def orth_err(q):
        eye = torch.eye(q.shape[-1], device="cuda")
        return (q.transpose(-1, -2) @ q - eye).abs().max().item()

    def proj_err(q, p):
        """max|Q Q^T - L L^T| against torch.linalg.qr's L, 1024 rows of
        the [a, a] projectors at a time."""
        ql, _ = torch.linalg.qr(p)
        worst = 0.0
        for i in range(0, q.shape[-2], 1024):
            d = (q[..., i:i + 1024, :] @ q.transpose(-1, -2)
                 - ql[..., i:i + 1024, :] @ ql.transpose(-1, -2))
            worst = max(worst, d.abs().max().item())
        return worst

    shapes = [(16, a, 2) for a in (3, 512, 1536)]
    shapes += [(16, 1536, r) for r in range(1, 9)]
    shapes += [(4, 65536, 8), (2, 40, 12), (1, 3000, 20), (3, 7, 3)]
    for _, fire in qr_fires():
        shapes += [sh for sh in dict.fromkeys(fire) if sh not in shapes]
    t0 = time.perf_counter()
    worst_qr = worst_rel = worst_orth = worst_proj = 0.0
    worst_ulps, modes = 0, set()
    for sh in shapes:
        p = randn(*sh)
        q = kops.batched_qr(p, impl="kernel")
        qp = kops.batched_qr(p, impl="plain")
        qe = kref.batched_qr_blocked_plain(p)
        torch.cuda.synchronize()
        err = (q - qp).abs().max().item()
        rel = err / qp.abs().max().item()
        ulps = ulps_apart(torch, q, qe)
        orth, proj = orth_err(q), proj_err(q, p)
        label = f"{list(sh)} ({panel_plan(*sh[1:]).mode})"
        if not rel <= QR_TOL or not orth <= QR_ORTH_TOL \
                or not proj <= QR_ORTH_TOL:
            fail(f"batched_qr {label}: raw Q vs plain {rel:.3e} (tol "
                 f"{QR_TOL}), |Q^T Q - I| {orth:.3e}, projector vs "
                 f"torch.linalg.qr {proj:.3e} (tol {QR_ORTH_TOL})")
        if ulps > QR_EMU_ULPS:
            fail(f"batched_qr {label}: {ulps} ulps from "
                 f"batched_qr_blocked_plain (limit {QR_EMU_ULPS})")
        worst_qr, worst_rel = max(worst_qr, err), max(worst_rel, rel)
        worst_orth, worst_proj = max(worst_orth, orth), max(worst_proj, proj)
        worst_ulps = max(worst_ulps, ulps)
        modes.add(panel_plan(*sh[1:]).mode)
    # control: the emulation on another schedule (a row a thread at a
    # time) must be further than the limit from the kernel
    p = randn(16, 1536, 2)
    control_ulps = ulps_apart(torch, kops.batched_qr(p, impl="kernel"),
                              kref.batched_qr_blocked_plain(
                                  p, panel_plan(1536, 2)._replace(unit=1)))
    if not control_ulps > QR_EMU_ULPS:
        fail(f"batched_qr: the control schedule reads {control_ulps} ulps, "
             f"within the limit {QR_EMU_ULPS}: it would not fail a kernel "
             f"that sums in another order")
    # grouped calls against single-panel calls, bit for bit
    grouped = 0
    for label, fire in qr_fires() + [("all cases", shapes)]:
        ps = [randn(*sh) for sh in fire]
        for q, p in zip(batched_qr_many(ps), ps):
            if not same_bits(torch, q, kops.batched_qr(p, impl="kernel")):
                fail(f"batched_qr {label}: a grouped panel {list(p.shape)} "
                     f"differs from its single call")
            grouped += 1
    deficient = randn(16, 1536, 4)
    deficient[:, :, 2] = 0.0
    q = kops.batched_qr(deficient, impl="kernel")
    torch.cuda.synchronize()
    if not torch.isfinite(q).all() or q[:, :, 2].abs().max().item() != 0.0:
        fail("batched_qr: a zero column did not come back as exact zeros")
    # condition ~1e6: CGS2 stays orthonormal, one pass (CGS) must not
    u, _ = torch.linalg.qr(randn(16, 1536, 4))
    v, _ = torch.linalg.qr(randn(16, 4, 4))
    sv = torch.tensor([1.0, 1e-2, 1e-4, 1e-6], device="cuda")
    ill = (u * sv) @ v.transpose(-1, -2)
    ill_k = orth_err(kops.batched_qr(ill, impl="kernel"))
    ill_p = orth_err(kops.batched_qr(ill, impl="plain"))
    ill_one = orth_err(kref.batched_qr_plain(ill, passes=1))
    if not ill_k <= QR_ORTH_TOL or not ill_p <= QR_ORTH_TOL:
        fail(f"batched_qr on a panel of condition 1e6: |Q^T Q - I| kernel "
             f"{ill_k:.3e}, plain {ill_p:.3e} > {QR_ORTH_TOL}")
    if not ill_one > QR_ORTH_TOL:
        fail(f"one-pass control reads |Q^T Q - I| {ill_one:.3e} <= "
             f"{QR_ORTH_TOL}: the limit would not fail plain CGS")
    print(f"phase 8 batched_qr: {len(shapes)} shapes ("
          f"{', '.join(str(list(x)) for x in shapes)}; modes "
          f"{sorted(modes)}) in {time.perf_counter() - t0:.2f}s: max|kernel"
          f"-plain|={worst_qr:.3e} (max {worst_rel:.3e} of max|Q|, tol "
          f"{QR_TOL}); vs batched_qr_blocked_plain {worst_ulps} ulps (limit "
          f"{QR_EMU_ULPS}; the control schedule reads {control_ulps}, and "
          f"fails, as it must); {grouped} panels of grouped calls "
          f"bit-identical to single calls; max|Q^T Q-I|={worst_orth:.3e} "
          f"max projector vs torch.linalg.qr={worst_proj:.3e} (tol "
          f"{QR_ORTH_TOL}); zero column exact; condition 1e6: |Q^T Q-I| "
          f"kernel={ill_k:.3e} plain={ill_p:.3e} one-pass control="
          f"{ill_one:.3e}")

    # times, the L2 flushed before every launch, each reading after a
    # LONG_SLEEP_CYCLES sleep: (i) the Pipelined fire's 10 calls of
    # [16, 1536, 2]; (ii)-(iv) grouped calls; (v) the [4, 65536, 2] panel
    def lib_fire(ps):
        readings, _ = fire_ms(torch, lambda: [torch.linalg.qr(p) for p in ps],
                              flush, 5, strict=False)
        return Ms(readings, TOPK_SLEEP_CYCLES)

    panels = [randn(16, 1536, 2) for _ in range(10)]
    qr_ms = fire_each_ms(torch, lambda p: kops.batched_qr(p, impl="kernel"),
                         panels, flush, 10, LONG_SLEEP_CYCLES)
    qr_plain = fire_each_ms(torch, lambda p: kops.batched_qr(p, impl="plain"),
                            panels, flush, 3)
    qr_lib = lib_fire(panels)
    a, r = 1536, 2
    qr_bytes = sum(2 * p.numel() * 4 for p in panels)
    # CGS2 per panel: two passes of (dots + update) against the j earlier
    # columns for each column j, then the norm and the scale
    qr_ops = sum(16 * a * (4 * r * (r - 1) + 3 * r) for _ in panels)
    t_bytes, t_ops = qr_bytes / HBM_BYTES_PER_S, qr_ops / FP32_FLOPS
    qr_bound = max(t_bytes, t_ops) * 1e3
    qr_by = "bytes" if t_bytes >= t_ops else "operations"
    lines = [f"(i) 10 calls of [16,1536,2]: ms={fmt_ms(qr_ms)} (fires "
             f"{fmt(qr_ms.readings)}) plain_ms="
             f"{fmt_ms(qr_plain)} torch_linalg_qr_ms={fmt_ms(qr_lib)} "
             f"bound_ms={qr_bound:.6f} ({qr_by}, {qr_bytes} B, {qr_ops} "
             f"flops)"]
    fires = {}
    for label, fire in qr_fires() + [("(v) [4,65536,2]", [(4, 65536, 2)])]:
        ps = [randn(*sh) for sh in fire]
        ms = time_ms(torch, lambda: batched_qr_many(ps), flush, 10,
                     LONG_SLEEP_CYCLES)
        fires[label] = {"ms": ms, "bound_ms": qr_bound_ms(fire),
                        "library_ms": lib_fire(ps)}
        lines.append(f"{label} ({len(fire)} segments, one call): "
                     f"ms={fmt_ms(ms)} (readings {fmt(ms.readings)}) "
                     f"torch_linalg_qr_ms="
                     f"{fmt_ms(fires[label]['library_ms'])} bound_ms="
                     f"{fires[label]['bound_ms']:.6f} (bytes)")
        del ps
    print("phase 8 batched_qr times (L2 flushed before each launch, sleep "
          f"{LONG_SLEEP_CYCLES} cycles; torch.linalg.qr a call a segment "
          f"after one flush): " + "; ".join(lines))
    del panels
    return {"max_abs_err": worst_qr, "ms": qr_ms, "plain_ms": qr_plain,
            "library_ms": qr_lib, "bound_ms": qr_bound, "bound_by": qr_by,
            "emulation_ulps": worst_ulps,
            "fires": {k: {n: float(v) for n, v in f.items()}
                      for k, f in fires.items()}}


# --------------------------------------------------------------------- #
# phase 10: the WKV6 kernels against their plain versions


def within(torch, out_k, out_p):
    """(ok, max |kernel - plain|, measure) against KERN_REL_TOL: fp32
    outputs by max|diff| / max|plain| (the measure); bf16 outputs per
    element within BF16_ULPS ulps of max(|kernel|, |plain|) plus
    KERN_REL_TOL * max|plain| (the measure: the largest share of an
    element's limit)."""
    k, p = out_k.float(), out_p.float()
    diff = (k - p).abs()
    err = diff.max().item()
    scale = max(p.abs().max().item(), 1e-30)
    if not torch.isfinite(k).all():
        return False, float("inf"), float("inf")
    if out_k.dtype == torch.float32:
        rel = err / scale
        return rel <= KERN_REL_TOL, err, rel
    ulp = bf16_ulp(torch, torch.maximum(k.abs(), p.abs()))
    share = (diff / (BF16_ULPS * ulp + KERN_REL_TOL * scale)).max().item()
    return share <= 1.0, err, share


def hold(torch, label, out_k, out_p):
    ok, err, measure = within(torch, out_k, out_p)
    if not ok:
        fail(f"{label}: kernel against plain {measure:.3e} of its limit "
             f"measure (max abs {err:.3e}; fp32 limit {KERN_REL_TOL} of "
             f"max|plain|, bf16 {BF16_ULPS} ulps + that)")
    return err, measure


def control(torch, label, out_bad, out_p):
    """A planted fault must fail the limit the kernels are held to."""
    ok, _, measure = within(torch, out_bad, out_p)
    if ok:
        fail(f"control {label} passed the kernel limit ({measure:.3e}): "
             f"the limit cannot see that fault")
    return measure


def wkv_inputs(torch, b, s, h, d, dtype, seed):
    """r/k/v/dy normal * 0.5, w uniform in [0.05, 0.999], per-row u, and
    nonzero s0 and dS_T, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device="cuda") * 0.5

    r, k, v, dy = (n(b, s, h, d).to(dtype) for _ in range(4))
    w = (torch.rand((b, s, h, d), generator=g, device="cuda") * 0.949
         + 0.05).to(dtype)
    return r, k, v, w, n(b, h, d), n(b, h, d, d), dy, n(b, h, d, d)


def wkv_bound(b, s, h, d, esize):
    """Least time of the forward and the backward: each input read once
    and each output written once over HBM bandwidth, against their fp32
    flops (forward y and the state update, 4 D^2 per step and head;
    backward dr, dk, dv, dw and G's update plus the states it needs,
    10 D^2) over the fp32 peak."""
    seq = b * s * h * d
    st = b * h * d * d * 4
    f_bytes = 5 * seq * esize + b * h * d * 4 + 2 * st        # r k v w y
    b_bytes = 9 * seq * esize + 2 * b * h * d * 4 + 3 * st    # +dy, grads
    out = []
    for nbytes, flops in ((f_bytes, 4 * d * d * s * b * h),
                          (b_bytes, 10 * d * d * s * b * h)):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
        out.append((max(t_b, t_o) * 1e3,
                    "bytes" if t_b >= t_o else "operations", nbytes))
    return out


def wkv_bwd_extra_bytes(b, s, h, d, esize):
    """Device-memory bytes the backward kernel moves beyond its inputs,
    outputs and checkpoints (csrc/rwkv6_wkv.cu's header): no scratch, and
    input re-reads at most (served from L2 when the cluster's CTAs run
    together): v and dy read by each of the D / 16 CTAs of a cluster, k, w
    and v again by the sub-checkpoint walk for all but each chunk's last
    sub-chunk of 8 steps.  Returns (scratch, re-reads)."""
    from repro_torch.kernels.ref import WKV_BWD_ROWS, WKV_BWD_SUB, WKV_CHUNK
    cl = d // WKV_BWD_ROWS
    seq = b * s * h * d * esize
    # steps the sub-checkpoint walk reads: each chunk but its last sub-chunk
    walked = sum(max(0, -(-min(WKV_CHUNK, s - t0) // WKV_BWD_SUB) - 1)
                 * WKV_BWD_SUB for t0 in range(0, s, WKV_CHUNK)) / s
    reads = (1 + (1 + walked) * 2 + cl * (1 + walked) + cl) * seq
    return 0, int(reads - 5 * seq)


def shifted_state_control(r, k, v, w, u, dr, dk, dw, dy):
    """dr and dw as a backward that read S_{t+1} for S_t (an off-by-one in
    the kernel's ring of on-chip states) would give them, from the right
    gradients in closed form (S_{t+1} = w S_t + k v^T): dr' = w (dr - u k
    dyv) + k dyv + u k dyv, dw' = w dw + k (dk - u r dyv); u broadcast to
    [B, S, H, D].  tests/test_torch_wkv_blocked.py holds the form against
    a direct loop."""
    dyv = (dy * v).sum(-1, keepdim=True)
    ukd = u * k * dyv
    return (w * (dr - ukd) + k * dyv + ukd,
            w * dw + k * (dk - u * r * dyv))


def staging_fault_control(kref, r, k, v, w, u, s0, stage):
    """y as a forward whose staging read r_{t+1} for r_t at the first step
    of every stage of ``stage`` steps would give it: the plain forward on
    r so shifted (the states never read r)."""
    import torch
    t = torch.arange(0, r.shape[1] - 1, stage, device=r.device)
    bad = r.clone()
    bad[:, t] = r[:, t + 1]
    return kref.rwkv6_wkv_forward_plain(bad, k, v, w, u, s0)[0]


def phase_wkv(torch):
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.rwkv6_wkv import (rwkv6_wkv_backward,
                                               rwkv6_wkv_forward)
    names = ("y", "sT", "dr", "dk", "dv", "dw", "du", "ds0")
    cases = [("training fp32", 8, 512, 32, 64, torch.float32),
             ("S64 fp32", 8, 64, 32, 64, torch.float32),
             ("S192 fp32", 8, 192, 32, 64, torch.float32),
             ("S192 bf16", 8, 192, 32, 64, torch.bfloat16),
             ("S130 D32 fp32", 2, 130, 4, 32, torch.float32)]
    worst, parts, blocked, fblocked = {}, [], [], []
    for i, (label, b, s, h, d, dtype) in enumerate(cases):
        inp = wkv_inputs(torch, b, s, h, d, dtype, seed=40 + i)
        r, k, v, w, u, s0, dy, dsT = inp
        yk, sTk, ck = rwkv6_wkv_forward(r, k, v, w, u, s0)
        gk = rwkv6_wkv_backward(r, k, v, w, u, ck, dy, dsT)
        yp, sTp, cp = kref.rwkv6_wkv_forward_plain(r, k, v, w, u, s0)
        gp = kref.rwkv6_wkv_backward_plain(r, k, v, w, u, cp, dy, dsT)
        # the kernels' schedules, emulated in plain PyTorch: the forward's
        # 8 x 4 tiles, y's row-group partials summed in order and q_t once
        # per step, each fmaf rounded once; the backward's row blocks,
        # sub-checkpoints and dv over the blocks in order
        fe = kref.rwkv6_wkv_forward_blocked_plain(r, k, v, w, u, s0)
        ge = kref.rwkv6_wkv_backward_blocked_plain(r, k, v, w, u, cp, dy,
                                                   dsT)
        torch.cuda.synchronize()
        hold(torch, f"wkv {label} checkpoints", ck, cp)
        meas = {}
        for name, a, bb in zip(names, (yk, sTk, *gk), (yp, sTp, *gp)):
            _, meas[name] = hold(torch, f"wkv {label} {name}", a, bb)
            worst[name] = max(worst.get(name, 0.0),
                              (a.float() - bb.float()).abs().max().item())
        parts.append(f"{label}: " + " ".join(
            f"{n}={m:.2e}" for n, m in meas.items()))
        meas = [hold(torch, f"wkv {label} {name} against the emulation",
                     a, e)[1] for name, a, e in zip(names[2:], gk, ge)]
        blocked.append(f"{label}: " + " ".join(
            f"{n}={m:.2e}" for n, m in zip(names[2:], meas)))
        if not (same_bits(torch, sTk, fe[1]) and same_bits(torch, ck, fe[2])):
            fail(f"wkv {label}: the forward's final state or a checkpoint "
                 f"differs from the emulation's")
        ulps = ulps_apart(torch, yk, fe[0])
        if ulps > WKV_FWD_EMU_ULPS:
            fail(f"wkv {label}: y {ulps} ulps from the emulation's (limit "
                 f"{WKV_FWD_EMU_ULPS})")
        fblocked.append(f"{label}: y {ulps} ulps")
        if i == 0:
            train = (inp, ck, yp, gp)
        del inp, yk, sTk, ck, gk, yp, sTp, cp, gp, ge, fe
    (r, k, v, w, u, s0, dy, dsT), ck, yp, gp = train
    # controls at the training shape: the bonus u dropped from y, and
    # from dk (a backward that forgets u's term); y with r_{t+1} at every
    # stage start (a staging fault); dr and dw read with S_{t+1} for S_t
    ctl_y = control(torch, "y without u", yp - v * (r * u[:, None] * k)
                    .sum(-1, keepdim=True), yp)
    ctl_stage = control(torch, "y with r_(t+1) at stage starts",
                        staging_fault_control(kref, r, k, v, w, u, s0,
                                              kref.WKV_FWD_STAGE), yp)
    ctl_dk = control(torch, "dk without u", gp[1] - u[:, None] * r
                     * (dy * v).sum(-1, keepdim=True), gp[1])
    bad_dr, bad_dw = shifted_state_control(r, k, v, w, u[:, None], gp[0],
                                           gp[1], gp[3], dy)
    ctl_dr = control(torch, "dr with S_{t+1}", bad_dr, gp[0])
    ctl_dw = control(torch, "dw with S_{t+1}", bad_dw, gp[3])
    del bad_dr, bad_dw
    # a rerun gives the same bits (no atomics)
    yk, sTk, ck1 = rwkv6_wkv_forward(r, k, v, w, u, s0)
    gk = rwkv6_wkv_backward(r, k, v, w, u, ck1, dy, dsT)
    yk2, sTk2, ck2 = rwkv6_wkv_forward(r, k, v, w, u, s0)
    gk2 = rwkv6_wkv_backward(r, k, v, w, u, ck2, dy, dsT)
    torch.cuda.synchronize()
    if not all(same_bits(torch, a, bb) for a, bb in zip(
            (yk, sTk, ck1, *gk), (yk2, sTk2, ck2, *gk2))):
        fail("wkv: a rerun gave other bits")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    # each kernel's time: the mean of 10 single-call readings (the median
    # printed beside it); the forward's after a longer sleep
    f_reps = [time_ms(torch, lambda: rwkv6_wkv_forward(r, k, v, w, u, s0),
                      flush, 1, WKV_FWD_SLEEP_CYCLES) for _ in range(10)]
    f_ms = statistics.fmean(f_reps)
    b_reps = [time_ms(torch, lambda: rwkv6_wkv_backward(
        r, k, v, w, u, ck1, dy, dsT), flush, 1) for _ in range(10)]
    b_ms = statistics.fmean(b_reps)
    f_plain = time_ms(torch, lambda: kref.rwkv6_wkv_forward_plain(
        r, k, v, w, u, s0), flush, 2)
    b_plain = time_ms(torch, lambda: kref.rwkv6_wkv_backward_plain(
        r, k, v, w, u, ck1, dy, dsT), flush, 1)
    (fb, fby, fbytes), (bb_, bby, bbytes) = wkv_bound(8, 512, 32, 64, 4)
    scratch, rereads = wkv_bwd_extra_bytes(8, 512, 32, 64, 4)
    ck_bytes = ck1.numel() * ck1.element_size()
    print(f"phase 10 wkv kernels vs plain (fp32 limit {KERN_REL_TOL} of "
          f"max|plain|, bf16 {BF16_ULPS} ulps + that; measures per "
          f"output): " + " | ".join(parts) + "; forward vs "
          f"rwkv6_wkv_forward_blocked_plain (sT and checkpoints "
          f"bit-identical, y within {WKV_FWD_EMU_ULPS} ulp): "
          + " | ".join(fblocked) + "; backward vs "
          f"rwkv6_wkv_backward_blocked_plain (same limits): "
          + " | ".join(blocked) + f"; controls: y without u {ctl_y:.3e}, "
          f"y with r_(t+1) at stage starts {ctl_stage:.3e}, dk without u "
          f"{ctl_dk:.3e}, dr with S_(t+1) {ctl_dr:.3e}, dw with S_(t+1) "
          f"{ctl_dw:.3e} (fail, as they must); rerun bit-identical; "
          f"training shape (B8 S512 H32 D64 fp32, L2 flushed): "
          f"fwd_ms={f_ms:.4f} (sleep {WKV_FWD_SLEEP_CYCLES} cycles; mean; "
          f"median {statistics.median(f_reps):.4f}; readings "
          f"{fmt(f_reps)}) "
          f"plain_ms={fmt_ms(f_plain)} "
          f"bound_ms={fb:.4f} ({fby}, {fbytes} B; the port's forward also "
          f"writes {ck_bytes} B of checkpoints); bwd_ms={b_ms:.4f} "
          f"(mean; median {statistics.median(b_reps):.4f}; readings "
          f"{fmt(b_reps)}) plain_ms={fmt_ms(b_plain)} "
          f"bound_ms={bb_:.4f} ({bby}, {bbytes} B); backward beyond "
          f"inputs, outputs and checkpoints: scratch {scratch} B, input "
          f"re-reads <= {rereads} B; library: none (no single PyTorch "
          f"call)")
    fwd = {"max_abs_err": max(worst["y"], worst["sT"]), "ms": f_ms,
           "plain_ms": f_plain, "bound_ms": fb, "bound_by": fby,
           "library_ms": None}
    bwd = {"max_abs_err": max(worst[n] for n in names[2:]), "ms": b_ms,
           "plain_ms": b_plain, "bound_ms": bb_, "bound_by": bby,
           "library_ms": None}
    return fwd, bwd


# --------------------------------------------------------------------- #
# phase 11: the attention kernels against their plain versions


def attn_inputs(torch, b, s, hq, hkv, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    return n(b, s, hq, d), n(b, s, hkv, d), n(b, s, hkv, d), n(b, s, hq, d)


def attn_bound(b, s, hq, hkv, d, window, esize):
    """Least time of the forward and the backward: the causal (and
    window) FLOPs the inputs need, 4 D per visible (query, key) pair and
    head forward (Q K^T and P V) and 10 D backward (S again, dP, dV, dK,
    dQ), at the card's best rate for an fp32-exact product of the type --
    bf16: the tensor cores (989 TFLOP/s); fp32: the lesser time of the
    CUDA cores (67 TFLOP/s) and of 3 TF32 products each on the tensor
    cores (495 / 3 TFLOP/s) -- against each input read once and each
    output written once.  Returns per pass (ms, "bytes" or "operations",
    flops, the basis in words)."""
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(s))
    qo = b * s * hq * d * esize
    kv = b * s * hkv * d * esize
    lse = b * hq * s * 4
    out = []
    for nbytes, flops in ((2 * qo + 2 * kv + lse, 4 * d * hq * b * pairs),
                          (4 * qo + 4 * kv + lse, 10 * d * hq * b * pairs)):
        if esize == 4:
            t_core = flops / FP32_FLOPS
            t_split = TF32_TERMS * flops / TF32_FLOPS
            t_o = min(t_core, t_split)
            basis = (f"{TF32_TERMS} TF32 products at {TF32_FLOPS / 1e12:.0f}"
                     f" TFLOP/s" if t_split <= t_core else
                     f"fp32 CUDA cores at {FP32_FLOPS / 1e12:.0f} TFLOP/s")
        else:
            t_o = flops / BF16_FLOPS
            basis = f"bf16 tensor cores at {BF16_FLOPS / 1e12:.0f} TFLOP/s"
        t_b = nbytes / HBM_BYTES_PER_S
        out.append((max(t_b, t_o) * 1e3,
                    "bytes" if t_b >= t_o else "operations", flops,
                    f"{nbytes} B" if t_b >= t_o else basis))
    return out


def sdpa_backward(torch, F, q, k, v, do):
    """One PyTorch call's backward as the yardstick: torch.autograd.grad
    of one scaled_dot_product_attention output (causal, GQA) with respect
    to q, k and v, given dO; the forward runs once, outside the timing."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def phase_attention(torch):
    import torch.nn.functional as F
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_fwd)
    cases = [("training fp32", 4, 1024, 48, 4, 128, 0, torch.float32),
             ("training bf16", 4, 1024, 48, 4, 128, 0, torch.bfloat16),
             ("window 4096 at S 8192", 1, 8192, 12, 1, 128, 4096,
              torch.float32),
             ("G3 D64 window 0", 2, 192, 6, 2, 64, 0, torch.float32),
             ("G5 D32 window 70", 1, 320, 5, 1, 32, 70, torch.float32),
             ("G3 D128 S200 ragged", 2, 200, 9, 3, 128, 0, torch.float32),
             ("G7 D64 window 100 bf16", 1, 256, 7, 1, 64, 100,
              torch.bfloat16),
             ("G12 D64 window 0", 2, 256, 12, 1, 64, 0, torch.float32),
             ("G3 D64 S200 ragged bf16", 2, 200, 6, 2, 64, 0,
              torch.bfloat16)]
    names = ("o", "lse", "dq", "dk", "dv")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    worst_f, worst_b, parts, records, controls = 0.0, 0.0, [], {}, []
    for i, (label, b, s, hq, hkv, d, win, dtype) in enumerate(cases):
        q, k, v, do = attn_inputs(torch, b, s, hq, hkv, d, dtype, 50 + i)
        ok_, lk = flash_attention_fwd(q, k, v, window=win)
        op, lp = kref.flash_attention_plain(q, k, v, window=win)
        op = op.contiguous()
        gk = flash_attention_backward(q, k, v, op, lp, do, window=win)
        gp = kref.flash_attention_backward_plain(q, k, v, op, lp, do,
                                                 window=win)
        torch.cuda.synchronize()
        meas = {}
        for name, a, bb in zip(names, (ok_, lk, *gk), (op, lp, *gp)):
            err, meas[name] = hold(torch, f"attention {label} {name}", a, bb)
            if name in ("o", "lse"):
                worst_f = max(worst_f, err)
            else:
                worst_b = max(worst_b, err)
        parts.append(f"{label}: " + " ".join(
            f"{n}={m:.2e}" for n, m in meas.items()))
        if win:
            # controls: the window one key short, forward and backward
            ob, lb = kref.flash_attention_plain(q, k, v, window=win - 1)
            gb = kref.flash_attention_backward_plain(q, k, v, ob, lb, do,
                                                     window=win - 1)
            controls.append(f"{label} window-1: o "
                            f"{control(torch, 'o, window - 1', ob, op):.2e}"
                            f" dk {control(torch, 'dk, window - 1', gb[1], gp[1]):.2e}")
            del ob, lb, gb
        if label.startswith("training"):
            # control: kv heads taken as h % Hkv instead of h // group
            perm = torch.arange(hq, device="cuda").reshape(
                hkv, hq // hkv).T.reshape(-1)
            ob, _ = kref.flash_attention_plain(q[:, :, perm], k, v)
            inv = torch.argsort(perm)
            controls.append(f"{label} kv head h % Hkv: o "
                            f"{control(torch, 'o, h % Hkv', ob[:, :, inv], op):.2e}")
            t = dict(
                ms=time_ms(torch, lambda: flash_attention_fwd(q, k, v),
                           flush, 10),
                plain_ms=time_ms(torch, lambda: kref.flash_attention_plain(
                    q, k, v), flush, 3),
                library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True), flush, 10),
                bwd_ms=time_ms(torch, lambda: flash_attention_backward(
                    q, k, v, op, lp, do), flush, 5),
                bwd_plain_ms=time_ms(torch, lambda: kref.
                                     flash_attention_backward_plain(
                                         q, k, v, op, lp, do), flush, 2),
                bwd_library_ms=time_ms(torch, sdpa_backward(
                    torch, F, q, k, v, do), flush, 3))
            (fb, fby, ff, fbasis), (bb_, bby, bf, bbasis) = attn_bound(
                b, s, hq, hkv, d, 0, q.element_size())
            t.update(bound_ms=fb, bound_by=fby, bwd_bound_ms=bb_,
                     bwd_bound_by=bby, flops=ff, bwd_flops=bf, basis=fbasis,
                     bwd_basis=bbasis)
            records[label] = t
        del q, k, v, do, ok_, lk, op, lp, gk, gp
    # the kernels against their arithmetic emulated in PyTorch
    # (flash_attention_split_plain: the same tiles, TF32 or bf16 operand
    # splits and per-mma sums), on each path (bf16 mma, fp32 3xTF32) and
    # each head dim, at the same limits
    split_parts = []
    for i, (d, dtype) in enumerate([(dd, dt) for dt in (torch.float32,
                                                        torch.bfloat16)
                                    for dd in (32, 64, 128)]):
        q, k, v, do = attn_inputs(torch, 1, 200, 6, 2, d, dtype, 70 + i)
        ok_, lk = flash_attention_fwd(q, k, v, window=70)
        gk = flash_attention_backward(q, k, v, ok_, lk, do, window=70)
        os_, ls_ = kref.flash_attention_split_plain(q, k, v, window=70)
        gs = kref.flash_attention_split_backward_plain(q, k, v, ok_, lk, do,
                                                       window=70)
        torch.cuda.synchronize()
        tag = f"D{d} {'fp32' if dtype == torch.float32 else 'bf16'}"
        meas = []
        for name, a, bb in zip(names, (ok_, lk, *gk), (os_, ls_, *gs)):
            _, m = hold(torch, f"attention vs split {tag} {name}", a, bb)
            meas.append(f"{name}={m:.2e}")
        split_parts.append(f"{tag}: " + " ".join(meas))
    # a rerun gives the same bits (no atomics)
    q, k, v, do = attn_inputs(torch, 2, 192, 6, 2, 64, torch.float32, 53)
    o1, l1 = flash_attention_fwd(q, k, v, window=70)
    g1 = flash_attention_backward(q, k, v, o1, l1, do, window=70)
    o2, l2 = flash_attention_fwd(q, k, v, window=70)
    g2 = flash_attention_backward(q, k, v, o2, l2, do, window=70)
    torch.cuda.synchronize()
    if not all(same_bits(torch, a, bb) for a, bb in zip(
            (o1, l1, *g1), (o2, l2, *g2))):
        fail("attention: a rerun gave other bits")
    print(f"phase 11 attention kernels vs plain (fp32 limit {KERN_REL_TOL} "
          f"of max|plain|, bf16 {BF16_ULPS} ulps + that; measures per "
          f"output): " + " | ".join(parts) + "; controls (fail, as they "
          f"must): " + "; ".join(controls) + "; vs split_plain (B1 S200 "
          f"Hq6 Hkv2 window 70): " + " | ".join(split_parts)
          + "; rerun bit-identical")
    for label, t in records.items():
        print(f"phase 11 attention {label} (B4 S1024 Hq48 Hkv4 D128 causal, "
              f"L2 flushed): fwd_ms={fmt_ms(t['ms'])} plain_ms="
              f"{fmt_ms(t['plain_ms'])} sdpa_ms={fmt_ms(t['library_ms'])} "
              f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}, "
              f"{t['flops']} flops, {t['basis']}); bwd_ms="
              f"{fmt_ms(t['bwd_ms'])} plain_ms={fmt_ms(t['bwd_plain_ms'])} "
              f"sdpa_bwd_ms={fmt_ms(t['bwd_library_ms'])} "
              f"bound_ms={t['bwd_bound_ms']:.4f} "
              f"({t['bwd_bound_by']}, {t['bwd_flops']} flops, "
              f"{t['bwd_basis']})")
    t = records["training fp32"]
    fwd = {"max_abs_err": worst_f, "ms": t["ms"], "plain_ms": t["plain_ms"],
           "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
           "library_ms": t["library_ms"]}
    bwd = {"max_abs_err": worst_b, "ms": t["bwd_ms"],
           "plain_ms": t["bwd_plain_ms"], "bound_ms": t["bwd_bound_ms"],
           "bound_by": t["bwd_bound_by"], "library_ms": t["bwd_library_ms"]}
    return fwd, bwd


# --------------------------------------------------------------------- #
# phases 12 and 13: full-width LM training


LM_CLASSES = (
    ("rwkv6_wkv", ("wkv6_",)),
    ("flash_attention", ("attn_",)),
    ("topk_compress", ("topk_",)),
    ("gemm", ("gemm", "cutlass", "xmma", "sm90_", "sm80_", "ampere",
              "nvjet")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("reduce", ("reduce",)),
    ("softmax", ("softmax",)),
)


def lm_counters():
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_fwd)
    from repro_torch.kernels.rwkv6_wkv import (rwkv6_wkv_backward,
                                               rwkv6_wkv_forward)
    from repro_torch.kernels.topk_compress import topk_compress
    return {"rwkv6_wkv_forward": rwkv6_wkv_forward,
            "rwkv6_wkv_backward": rwkv6_wkv_backward,
            "flash_attention_forward": flash_attention_fwd,
            "flash_attention_backward": flash_attention_backward,
            "topk_compress": topk_compress}


def lm_setup(torch, arch, n_layers, seq, impl="auto", **opts):
    """The arch at full width cut to ``n_layers``, random init from seed
    0, and a sampler of seq-token chains of the 512-token Markov task;
    ``opts`` go to ``build`` (param_dtype, remat).  For the VLM, the
    stub's patch embeddings (``cfg.frontend_tokens`` of them, from the
    sampler's generator) and their M-RoPE positions go in front of
    seq - frontend_tokens chain tokens; for the encoder-decoder (cut to
    ``n_layers`` encoder and ``n_layers`` decoder layers) the stub's
    ``cfg.frontend_tokens`` audio frames go beside seq chain tokens."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_markov_task, markov_lm_batch
    from repro_torch.models import build
    from repro_torch.models.stubs import (audio_frame_embeds,
                                          mrope_positions,
                                          vision_patch_embeds)
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    if cfg.is_encoder_decoder:
        cfg = dataclasses.replace(cfg, n_encoder_layers=n_layers)
    bundle = build(cfg, impl=impl, device="cuda", **opts)
    logits, floor = make_markov_task(LM_MARKOV_VOCAB, device="cuda")
    nv = cfg.frontend_tokens if cfg.family == "vlm" else 0

    def sample(gen, n):
        batch = markov_lm_batch(gen, n, seq - nv, logits)
        if nv:
            batch["vision_embeds"] = vision_patch_embeds(gen, n, nv,
                                                         cfg.d_model)
            batch["positions"] = mrope_positions(n, nv, seq - nv,
                                                 device="cuda")
        if cfg.is_encoder_decoder:
            batch["frames"] = audio_frame_embeds(gen, n, cfg.frontend_tokens,
                                                 cfg.d_model)
        return batch

    return cfg, bundle, sample, floor


def padded_bucket_bytes(torch, cfg, n_learners):
    """What default bucketing (4 MiB cap, pipelined, uniform) would hold
    for the top-k EF state (ref and err) against per-leaf, from meta
    tensors: nothing is allocated."""
    from repro_torch.comm import DEFAULT_BUCKET_BYTES
    from repro_torch.comm.bucket import BucketLayout
    from repro_torch.models import build
    from repro_torch.tree import leaves
    tmpl = build(cfg, device="meta").init_train()
    lay = BucketLayout.build(tmpl, lead_axes=0, uniform=True,
                             bucket_bytes=DEFAULT_BUCKET_BYTES)
    padded = sum(b.padded_size for b in lay.buckets) * 4
    per_leaf = sum(x.numel() for x in leaves(tmpl)) * 4
    return lay.n_buckets, 2 * n_learners * padded, 2 * n_learners * per_leaf


def lm_parts(torch, bundle, plan, state, rb):
    """The parts of a round, each across a synchronize: one SGD step on all
    learners, and one fire of each plan level on the trained state."""
    from repro_torch.comm import reduce_with
    from repro_torch.core.hier_avg import make_sgd_step
    from repro_torch.core.topology import average_over
    from repro_torch.optim import sgd
    step_batch = {k: v[(0,) * len(plan.batch_dims)] for k, v in rb.items()}
    step = make_sgd_step(bundle.loss_fn, sgd(0.1))
    parts = {"step": wall_ms(torch, lambda: step(state, step_batch), 2)}
    for lvl in plan.levels:
        cs = state.comm_state[lvl.name] if lvl.reducer.stateful else ()
        parts[lvl.name] = wall_ms(torch, lambda lvl=lvl, cs=cs: reduce_with(
            lvl.reducer, lambda t, cf=None, lvl=lvl: average_over(
                t, lvl.axes), state.params, cs), 2)
    return parts


def compare_params(torch, pk, pp):
    """Leaf by leaf on the card: (max |kernel - plain| / max|plain| of the
    leaf, coordinates beyond LM_PARAM_TOL of their leaf's max, all
    coordinates)."""
    worst, beyond, total = 0.0, 0, 0
    for a, b in zip(pk, pp):
        a, b = a.cuda(), b.cuda()
        d = (a - b).abs()
        scale = max(b.abs().max().item(), 1e-30)
        worst = max(worst, d.max().item() / scale)
        beyond += int((d > LM_PARAM_TOL * scale).sum())
        total += d.numel()
    return worst, beyond, total


def lm_phase(torch, *, label, arch, n_layers, hier, batch, seq, rounds,
             counters, check):
    """Train ``rounds`` rounds at P = 4 as (1, 2, 2), sgd(0.1), ``batch``
    chains of ``seq`` tokens per learner per step, eval loss of the
    averaged model after each round on 4 fixed chains; then the round's
    parts, 1 round kernel-vs-plain from one converted state, and a
    profiled round.  Returns the launch counts of the trained rounds."""
    from repro_torch.core.hier_avg import init_state, make_hier_round
    from repro_torch.core.topology import HierTopology, unstack_first
    from repro_torch.data.loader import HierDataLoader
    from repro_torch.optim import sgd
    from repro_torch.tree import leaves

    gc.collect()
    torch.cuda.empty_cache()
    cfg, bundle, sample, floor = lm_setup(torch, arch, n_layers, seq)
    topo = HierTopology(1, 2, 2)
    plan = hier.resolved_plan
    loader = HierDataLoader(sample, topo=topo, hier=hier,
                            per_learner_batch=batch, seed=0, device="cuda")
    eval_batch = sample(torch.Generator(device="cuda").manual_seed(1), 4)
    rnd = make_hier_round(bundle.loss_fn, sgd(0.1), hier)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(topo, bundle.init_train, sgd(0.1),
                       torch.Generator(device="cuda").manual_seed(0),
                       plan=plan, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p[0, 0, 0].numel() for p in leaves(state.params))
    zero_counts(counters)
    walls, losses, evals = [], [], []
    for _ in range(rounds):
        rb = loader.next_round()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = rnd(state, rb)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        with torch.no_grad():
            evals.append(bundle.loss_fn(unstack_first(state.params),
                                        eval_batch)[0].item())
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (np_isfinite(losses) and np_isfinite(evals)):
        fail(f"{label}: losses not finite: {losses} {evals}")
    if not evals[-1] < evals[0]:
        fail(f"{label}: eval loss did not fall: {evals}")
    check(launches, cfg, hier, rounds)

    parts = lm_parts(torch, bundle, plan, state, rb)
    print(f"{label} ({n_params} params per learner, {cfg.n_layers} of "
          f"{LM_FULL_DEPTH[arch]} layers, widths as published) P=4 (1, 2, 2)"
          f" plan {plan.describe()} sgd(0.1), {batch} x {seq} tokens per "
          f"learner per step of the {LM_MARKOV_VOCAB}-token Markov chain "
          f"(floor {floor:.4f} nats): init_s={init_s:.2f} rounds={rounds} "
          f"train_loss={fmt(losses)} eval_loss={fmt(evals)} round_wall_ms="
          f"{fmt(walls)} step_wall_ms={parts['step']:.3f} "
          + " ".join(f"{lvl.name}_fire_ms={parts[lvl.name]:.3f}"
                     for lvl in plan.levels)
          + f" peak_mem_gib={peak:.2f} launches={launches}")

    # kernel against plain: 1 round from one state copy, same batch
    rb = loader.next_round()
    cpu_state = comparison_copy(torch, state)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    for impl in ("kernel", "plain"):
        _, b_impl, _, _ = lm_setup(torch, arch, n_layers, seq, impl=impl)
        r_impl = make_hier_round(b_impl.loss_fn, sgd(0.1), hier)
        st = state_to(torch, cpu_state, "cuda")
        t0 = time.perf_counter()
        st, m = r_impl(st, rb)
        torch.cuda.synchronize()
        out[impl] = (m["loss"].item(), (time.perf_counter() - t0) * 1e3,
                     [p.cpu() for p in leaves(st.params)])
        del st, m
        gc.collect()
        torch.cuda.empty_cache()
    (lk, wk, pk), (lp, wp, pp) = out["kernel"], out["plain"]
    loss_rel = abs(lk - lp) / abs(lp)
    worst, beyond, total = compare_params(torch, pk, pp)
    if loss_rel > LM_LOSS_TOL or beyond > LM_SWAP_FRAC * total:
        fail(f"{label} kernel vs plain round: loss {loss_rel:.3e} (limit "
             f"{LM_LOSS_TOL}), {beyond} of {total} params beyond "
             f"{LM_PARAM_TOL} of their leaf's max (limit "
             f"{LM_SWAP_FRAC} of them)")
    print(f"{label} kernel vs plain: 1 round from one state copy: "
          f"loss {lk:.6f} vs {lp:.6f} (rel {loss_rel:.3e}, limit "
          f"{LM_LOSS_TOL}); params max rel {worst:.3e}, {beyond} of {total} "
          f"coordinates beyond {LM_PARAM_TOL} of their leaf's max (limit "
          f"{LM_SWAP_FRAC} of them); round_wall_ms kernel={wk:.1f} "
          f"plain={wp:.1f}")
    del out, pk, pp
    st = state_to(torch, cpu_state, "cuda")
    del cpu_state
    gc.collect()
    profile_round(torch, rnd, st, rb, f"{label} (one round)", LM_CLASSES)
    del st, rb
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def check_rwkv_launches(launches, cfg, hier, rounds):
    steps = hier.steps_per_round * rounds
    groups = topk_groups(lm_leaf_sizes(cfg), 4)
    want = {"rwkv6_wkv_forward": cfg.n_layers * (steps + rounds),
            "rwkv6_wkv_backward": cfg.n_layers * steps,
            "topk_compress": 25 * rounds,
            "topk_compress_calls": len(groups) * rounds,
            "flash_attention_forward": 0, "flash_attention_backward": 0}
    if launches != want:
        fail(f"rwkv launches {launches} != {want} (layers x (steps + "
             f"evals), layers x steps, 25 leaves and {len(groups)} grouped "
             f"calls x global fires)")


def check_dense_launches(launches, cfg, hier, rounds):
    steps = hier.steps_per_round * rounds
    want = {"flash_attention_forward": cfg.n_layers * (steps + rounds),
            "flash_attention_backward": cfg.n_layers * steps,
            "rwkv6_wkv_forward": 0, "rwkv6_wkv_backward": 0,
            "topk_compress": 0, "topk_compress_calls": 0}
    if launches != want:
        fail(f"dense launches {launches} != {want} (layers x (steps + "
             f"evals), layers x steps)")


def phase_lm(torch):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import HierAvgParams
    from repro_torch.launch import train as train_cli
    counters = lm_counters()
    rwkv_hier = HierAvgParams(plan=LM_RWKV_PLAN, bucket_bytes=0)
    n_buckets, padded, per_leaf = padded_bucket_bytes(
        torch, dataclasses.replace(get_config("rwkv6-1.6b"),
                                   n_layers=RWKV_TRAIN_LAYERS), 4)
    print(f"phase 12 padded buckets: default bucketing of rwkv6-1.6b at "
          f"{RWKV_TRAIN_LAYERS} layers packs {n_buckets} uniform buckets, so the "
          f"top-k EF ref/err at 4 learners would take {padded} B against "
          f"{per_leaf} B per leaf (meta tensors; not run)")
    rwkv = lm_phase(torch, label="phase 12 train rwkv6-1.6b", arch="rwkv6-1.6b",
                    n_layers=RWKV_TRAIN_LAYERS, hier=rwkv_hier, batch=2,
                    seq=512,
                    rounds=LM_ROUNDS, counters=counters,
                    check=check_rwkv_launches)
    dense = lm_phase(torch, label="phase 13 train starcoder2-15b",
                     arch="starcoder2-15b", n_layers=DENSE_LAYERS,
                     hier=HierAvgParams(k1=2, k2=4), batch=1, seq=1024,
                     rounds=LM_ROUNDS, counters=counters,
                     check=check_dense_launches)

    # the training CLI on the card (reduced, as the reference's always is)
    fwd = counters["rwkv6_wkv_forward"]
    fwd.launches = 0
    t0 = time.perf_counter()
    train_cli.main(["--arch", "rwkv6-1.6b", "--rounds", "2", "--learners",
                    "4", "--s", "2", "--batch", "2", "--seq", "64"])
    if fwd.launches <= 0:
        fail("the training CLI launched no WKV kernel")
    print(f"phase 13 cli: launch.train.main --arch rwkv6-1.6b (reduced) "
          f"--rounds 2 --learners 4 --seq 64 on the card in "
          f"{time.perf_counter() - t0:.2f}s, {fwd.launches} WKV forward "
          f"launches")
    return rwkv, dense



# --------------------------------------------------------------------- #
# phases 15 and 16: MoE/MLA and bf16 remat M-RoPE training


def state_to(torch, state, device):
    """A copy of a TrainState with its float tensors on ``device`` (bf16
    kept as it is: convert.train_state_to_numpy has no bf16 type); the
    reducers' integer RNG carries stay where they are."""
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.to(device, copy=True)
                    if isinstance(x, torch.Tensor) and x.is_floating_point()
                    else x, state)


def comparison_copy(torch, state):
    """A copy of ``state`` that one_round starts each round from: on the
    card where it fits beside the peak so far (the training's, since its
    reset) with a tenth of the card to spare, else on the host (where
    every round then moves the whole state to the card)."""
    from repro_torch.tree import leaves
    nbytes = sum(x.numel() * x.element_size() for x in leaves(state)
                 if isinstance(x, torch.Tensor))
    total = torch.cuda.get_device_properties(0).total_memory
    on_card = torch.cuda.max_memory_allocated() + nbytes < 0.9 * total
    return state_to(torch, state, "cuda" if on_card else "cpu")


def bf16_rounds(torch, label, bundle, hier, loader, eval_batch, counters,
                rounds, floor, eval_first=False):
    """Train ``rounds`` rounds at P = 4 as (1, 2, 2), sgd(0.1), from seed
    0, the launch counts set to 0 just before and read just after; the
    eval loss (after each round, and with ``eval_first`` of the init too)
    must fall.  Returns (state, the last round batch, launches)."""
    from repro_torch.core.hier_avg import init_state, make_hier_round
    from repro_torch.core.topology import HierTopology, unstack_first
    from repro_torch.optim import sgd
    from repro_torch.tree import leaves

    rnd = make_hier_round(bundle.loss_fn, sgd(0.1), hier)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(HierTopology(1, 2, 2), bundle.init_train, sgd(0.1),
                       torch.Generator(device="cuda").manual_seed(0),
                       plan=hier.resolved_plan, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    zero_counts(counters)
    walls, losses, evals, aux = [], [], [], []
    if eval_first:
        with torch.no_grad():
            evals.append(bundle.loss_fn(unstack_first(state.params),
                                        eval_batch)[0].item())
    for _ in range(rounds):
        rb = loader.next_round()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = rnd(state, rb)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        aux.append(m["aux_loss"].item() if "aux_loss" in m else 0.0)
        with torch.no_grad():
            evals.append(bundle.loss_fn(unstack_first(state.params),
                                        eval_batch)[0].item())
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (np_isfinite(losses) and np_isfinite(evals)
            and np_isfinite(aux)):
        fail(f"{label}: losses not finite: {losses} {evals} {aux}")
    if not evals[-1] < evals[0]:
        fail(f"{label}: eval loss did not fall: {evals}")
    n_params = sum(p[0, 0, 0].numel() for p in leaves(state.params))
    dtypes = sorted({str(p.dtype)[6:] for p in leaves(state.params)})
    print(f"{label} ({n_params} params per learner, {dtypes}) P=4 "
          f"(1, 2, 2) plan {hier.resolved_plan.describe()} sgd(0.1), "
          f"{LM_MARKOV_VOCAB}-token Markov chain (floor {floor:.4f} nats): "
          f"init_s={init_s:.2f} rounds={rounds} train_loss={fmt(losses)} "
          f"aux_loss={fmt(aux)} eval_loss={fmt(evals)} round_wall_ms="
          f"{fmt(walls)} peak_mem_gib={peak:.2f} launches={launches}")
    return state, rb, launches


def one_round(torch, rnd, cpu_state, rb):
    """One round from a copy of a state (on the host or the card,
    comparison_copy), on the card: (the new state, metrics, wall ms, peak
    GiB since the copy went up, less the bytes of a copy kept on the
    card, so the peak reads as the round's alone)."""
    from repro_torch.tree import leaves
    resident = sum(x.numel() * x.element_size() for x in leaves(cpu_state)
                   if isinstance(x, torch.Tensor) and x.is_cuda
                   and x.is_floating_point())
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    st = state_to(torch, cpu_state, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, m = rnd(st, rb)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return (st, m, wall,
            (torch.cuda.max_memory_allocated() - resident) / 2 ** 30)


def remat_identity(torch, label, make_round, cpu_state, rb, on=None):
    """One round with remat off and on from the same state copy: params,
    reducer state and metrics bit for bit; both peaks.  ``on``: the
    remat-on round's (CPU state, metrics, wall, peak) where the caller
    already ran it."""
    out = {True: on} if on is not None else {}
    for remat in (False, True):
        if remat in out:
            continue
        st, m, wall, peak = one_round(torch, make_round(remat), cpu_state,
                                      rb)
        out[remat] = (state_to(torch, st, "cpu"), m, wall, peak)
        del st
    (sa, ma, wa, pa), (sb, mb, wb, pb) = out[False], out[True]
    pairs = state_pairs(sa, sb) + [(ma[k].cpu(), mb[k].cpu()) for k in ma]
    bad = sum(not same_bits(torch, a, b) for a, b in pairs)
    if bad:
        fail(f"{label}: remat on and off differ in {bad} of {len(pairs)} "
             f"state leaves and metrics")
    print(f"{label} remat: 1 round from one state copy, remat off and on "
          f"bit-identical ({len(pairs)} state leaves and metrics); "
          f"round_wall_ms off={wa:.1f} on={wb:.1f}; peak_mem_gib "
          f"off={pa:.2f} on={pb:.2f}")
    return pa, pb, sb


def update_rel_l2(torch, new, want, old):
    """||(new - old) - (want - old)|| / ||want - old|| over all leaves as
    one vector (lists of CPU tensors), summed leaf by leaf on the card in
    fp64: the relative distance of a round's update from another's."""
    num = den = 0.0
    for a, b, o in zip(new, want, old):
        o = o.cuda().double()
        ua, ub = a.cuda().double() - o, b.cuda().double() - o
        num += float((ua - ub).square().sum())
        den += float(ub.square().sum())
        del o, ua, ub
    return math.sqrt(num / max(den, 1e-300))


def moe_dispatch_ms(torch, flush, b, t, e, c, d):
    """Device time of the one-hot dispatch and combine products of one MoE
    layer (x_ecd = disp^T x, y_t = comb y_ecd), forward and backward, at
    the trainer's shapes (the learners folded into b), bf16."""
    g = torch.Generator(device="cuda").manual_seed(7)
    slot = torch.randint(0, t, (b, 1, e, c), generator=g, device="cuda")
    disp = torch.zeros((b, t, e, c), dtype=torch.bfloat16, device="cuda")
    disp.scatter_(1, slot, 1.0)
    comb = (disp * torch.rand(disp.shape, generator=g, device="cuda").to(
        torch.bfloat16)).requires_grad_()
    xt = torch.randn((b, t, d), generator=g, device="cuda").to(
        torch.bfloat16).requires_grad_()
    y = torch.randn((b, e, c, d), generator=g, device="cuda").to(
        torch.bfloat16).requires_grad_()
    gx = torch.randn((b, e, c, d), generator=g, device="cuda").to(
        torch.bfloat16)
    gy = torch.randn((b, t, d), generator=g, device="cuda").to(
        torch.bfloat16)

    def fwd_bwd():
        x_ecd = torch.einsum("btec,btd->becd", disp, xt)
        yt = torch.einsum("btec,becd->btd", comb, y)
        torch.autograd.grad((x_ecd, yt), (xt, y, comb), (gx, gy))

    return time_ms(torch, fwd_bwd, flush, 5)


def kernel_sum_ms(kernels) -> float:
    return sum(k[2] for k in kernels) / 1e3 if kernels else float("nan")


def phase_moe(torch):
    """Phase 15: deepseek-v2-lite-16b (MoE + MLA) at published widths."""
    from repro_torch.comm import reduce_with
    from repro_torch.comm.sparse import TopKReducer
    from repro_torch.configs.base import HierAvgParams
    from repro_torch.core.hier_avg import make_hier_round
    from repro_torch.core.topology import average_over
    from repro_torch.data.loader import HierDataLoader
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.topk_compress import topk_compress_many
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import sgd
    from repro_torch.tree import leaves

    label = "phase 15 train deepseek-v2-lite-16b"
    counters = lm_counters()
    hier = HierAvgParams(k1=2, k2=4)
    cfg, bundle, sample, floor = lm_setup(
        torch, MOE_ARCH, MOE_LAYERS, MOE_SEQ, param_dtype=torch.bfloat16)
    loader = HierDataLoader(sample, topo=_topo(), hier=hier,
                            per_learner_batch=1, seed=0, device="cuda")
    eval_batch = sample(torch.Generator(device="cuda").manual_seed(1), 4)
    print(f"{label}: depth {cfg.n_layers} of {LM_FULL_DEPTH[MOE_ARCH]} "
          f"({cfg.first_k_dense} dense, then MoE: {cfg.n_experts} experts "
          f"+ {cfg.n_shared_experts} shared, top-{cfg.top_k}, capacity "
          f"{cfg.capacity_factor}; MLA kv_lora {cfg.kv_lora_rank}), widths "
          f"as published, bf16 params (fp32 router), 1 x {MOE_SEQ} tokens "
          f"per learner per step")
    state, rb, launches = bf16_rounds(
        torch, label, bundle, hier, loader, eval_batch, counters, LM_ROUNDS,
        floor)
    want = {k: 0 for k in launches}
    if launches != want:
        fail(f"{label}: launches {launches} != {want} (MLA attends with "
             f"its own products; the mean plan runs no codec)")
    parts = lm_parts(torch, bundle, hier.resolved_plan, state, rb)
    print(f"{label} parts: step_wall_ms={parts['step']:.3f} "
          + " ".join(f"{k}_fire_ms={v:.3f}" for k, v in parts.items()
                     if k != "step"))

    # remat off and on, one round from one state copy
    cpu_state = comparison_copy(torch, state)
    rb2 = loader.next_round()

    def make_round(remat):
        _, b, _, _ = lm_setup(torch, MOE_ARCH, MOE_LAYERS, MOE_SEQ,
                              param_dtype=torch.bfloat16, remat=remat)
        return make_hier_round(b.loss_fn, sgd(0.1), hier)

    del state
    *peaks, after = remat_identity(torch, label, make_round, cpu_state, rb2)

    # one top-k fire (ratio 0.05) over the stacked expert leaves, of the
    # round's update (the EF reference the params before the round, the
    # params after it): kernel against plain, bit for bit
    def expert_leaves(state):
        return {k: v.cuda() for k, v in
                state.params["layers"]["ffn"]["experts"].items()}

    before, now = expert_leaves(cpu_state), expert_leaves(after)
    del after
    axes = hier.resolved_plan.levels[-1].axes
    outs, fire_wall = {}, {}
    for impl in ("auto", "plain"):
        red = TopKReducer(TOPK_RATIO, impl=impl)
        ef = red.init_state(before)
        zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        avg, ef = reduce_with(red, lambda t, cf=None: average_over(t, axes),
                              now, ef)
        torch.cuda.synchronize()
        fire_wall[impl] = (time.perf_counter() - t0) * 1e3
        if impl == "auto":
            fire_launches = read_counts(counters)
        outs[impl] = [x.cpu() for x in leaves(avg) + leaves(ef.err)]
        del avg, ef
        gc.collect()
        torch.cuda.empty_cache()
    bad = sum(not same_bits(torch, a, b) for a, b in zip(outs["auto"],
                                                         outs["plain"]))
    if bad:
        fail(f"{label} top-k fire: kernel and plain differ in {bad} of "
             f"{len(outs['auto'])} averaged and EF leaves")
    del outs
    n_exp = len(now)
    if (fire_launches["topk_compress"], fire_launches["topk_compress_calls"]
            ) != (n_exp, n_exp):
        fail(f"{label} top-k fire launches {fire_launches}: want {n_exp} "
             f"segments in {n_exp} calls (each leaf over 1 GiB alone)")
    # one expert leaf's fp32 delta rows [4, n], as the fire selects them
    x = (now["w_up"].float() - before["w_up"].float()).reshape(4, -1)
    del now, before
    n = x.shape[1]
    k = TopKReducer(TOPK_RATIO).k_for(n)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    (kv, ki), = topk_compress_many([x], [k])
    pv, pi = kref.topk_compress_plain(x, k)
    if not (same_bits(torch, kv, pv) and torch.equal(ki, pi)):
        fail(f"{label}: top-k of the expert leaf [4, {n}] differs from "
             f"plain")
    zeros = int((x == 0).sum())
    del kv, ki, pv, pi
    gc.collect()
    torch.cuda.empty_cache()
    leaf = dict(
        ms=time_ms(torch, lambda: topk_compress_many([x], [k]), flush, 5),
        plain_ms=time_ms(torch, lambda: kref.topk_compress_plain(x, k),
                         flush, 2),
        library_ms=time_ms(torch, lambda: torch.topk(x.abs(), k, dim=1),
                           flush, 3),
        bound_ms=(x.numel() * 4 + 4 * k * 8) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes")
    del x
    print(f"{label} top-k fire over the {n_exp} stacked expert leaves "
          f"(ratio {TOPK_RATIO}, 4 rows each, of the round's update): "
          f"kernel and plain bit-identical; launches {fire_launches}; "
          f"fire_wall_ms kernel={fire_wall['auto']:.1f} plain="
          f"{fire_wall['plain']:.1f}; one leaf's delta [4, {n}] k={k} "
          f"({zeros} zero coordinates; L2 flushed): kernel_ms="
          f"{fmt_ms(leaf['ms'])} plain_ms={fmt_ms(leaf['plain_ms'])} "
          f"torch_topk_ms={fmt_ms(leaf['library_ms'])} bound_ms="
          f"{leaf['bound_ms']:.4f} (bytes: x read once, k values and "
          f"indices written)")

    # where the round's device time goes, and the dispatch/combine share
    rnd_k = make_round(False)
    st = state_to(torch, cpu_state, "cuda")
    del cpu_state
    kernels = profile_round(torch, rnd_k, st, rb2, f"{label} (one round)",
                            LM_CLASSES, ops=True)
    del st
    gc.collect()
    torch.cuda.empty_cache()
    capacity = max(1, math.ceil(MOE_SEQ * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor))
    disp = moe_dispatch_ms(torch, flush, 4, MOE_SEQ, cfg.n_experts,
                           capacity, cfg.d_model)
    n_moe = cfg.n_layers - cfg.first_k_dense
    per_round = disp * n_moe * hier.steps_per_round
    total = kernel_sum_ms(kernels)
    print(f"{label} dispatch and combine products (B4 T{MOE_SEQ} "
          f"E{cfg.n_experts} C{capacity} d{cfg.d_model} bf16, forward and "
          f"backward, L2 flushed): {fmt_ms(disp)} ms per MoE layer and "
          f"step, {per_round:.3f} ms per round ({n_moe} MoE layers x "
          f"{hier.steps_per_round} steps), {per_round / total:.4f} of the "
          f"profiled round's kernel sum {total:.3f} ms")

    # the training CLI on the card (reduced, as the reference's always is)
    t0 = time.perf_counter()
    train_cli.main(["--arch", MOE_ARCH, "--rounds", "2", "--learners", "4",
                    "--s", "2", "--batch", "2", "--seq", "64"])
    print(f"phase 15 cli: launch.train.main --arch {MOE_ARCH} (reduced) "
          f"--rounds 2 --learners 4 --seq 64 on the card in "
          f"{time.perf_counter() - t0:.2f}s")
    return fire_launches, leaf, peaks


def _topo():
    from repro_torch.core.topology import HierTopology
    return HierTopology(1, 2, 2)


def vlm_attn_times(torch, cfg, flush):
    """The attention kernels at the trainer's qwen2-vl shape (the learners
    folded into B), bf16: forward and backward against plain, SDPA and
    the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_fwd)
    b, s, hq, hkv, d = 4, VLM_SEQ, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    q, k, v, do = attn_inputs(torch, b, s, hq, hkv, d, torch.bfloat16, 90)
    o, lse = flash_attention_fwd(q, k, v)
    (fb, fby, _, fbasis), (bb, bby, _, bbasis) = attn_bound(
        b, s, hq, hkv, d, 0, 2)
    t = dict(
        ms=time_ms(torch, lambda: flash_attention_fwd(q, k, v), flush, 10),
        plain_ms=time_ms(torch, lambda: kref.flash_attention_plain(q, k, v),
                         flush, 3),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True), flush, 10),
        bound_ms=fb, bound_by=fby,
        bwd_ms=time_ms(torch, lambda: flash_attention_backward(
            q, k, v, o, lse, do), flush, 5),
        bwd_plain_ms=time_ms(torch, lambda: kref.
                             flash_attention_backward_plain(
                                 q, k, v, o, lse, do), flush, 2),
        bwd_library_ms=time_ms(torch, sdpa_backward(torch, F, q, k, v, do),
                               flush, 3),
        bwd_bound_ms=bb, bwd_bound_by=bby)
    print(f"phase 16 attention at qwen2-vl's training shape (B{b} S{s} "
          f"Hq{hq} Hkv{hkv} D{d} causal bf16, L2 flushed): fwd_ms="
          f"{fmt_ms(t['ms'])} plain_ms={fmt_ms(t['plain_ms'])} sdpa_ms="
          f"{fmt_ms(t['library_ms'])} bound_ms={fb:.4f} ({fby}, {fbasis}); "
          f"bwd_ms={fmt_ms(t['bwd_ms'])} plain_ms="
          f"{fmt_ms(t['bwd_plain_ms'])} sdpa_bwd_ms="
          f"{fmt_ms(t['bwd_library_ms'])} bound_ms={bb:.4f} ({bby}, "
          f"{bbasis})")
    return t


def phase_vlm(torch):
    """Phase 16: qwen2-vl-2b at published widths, bf16, remat, M-RoPE."""
    from repro_torch.configs.base import HierAvgParams
    from repro_torch.core.hier_avg import make_hier_round
    from repro_torch.data.loader import HierDataLoader
    from repro_torch.optim import sgd
    from repro_torch.tree import leaves

    label = "phase 16 train qwen2-vl-2b"
    counters = lm_counters()
    hier = HierAvgParams(plan=VLM_PLAN, bucket_bytes=0)
    opts = dict(param_dtype=torch.bfloat16, remat=True)
    cfg, bundle, sample, floor = lm_setup(torch, VLM_ARCH, VLM_LAYERS,
                                          VLM_SEQ, **opts)
    loader = HierDataLoader(sample, topo=_topo(), hier=hier,
                            per_learner_batch=1, seed=0, device="cuda")
    eval_batch = sample(torch.Generator(device="cuda").manual_seed(1), 4)
    print(f"{label}: depth {cfg.n_layers} of {LM_FULL_DEPTH[VLM_ARCH]}, "
          f"widths as published (d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, d_ff "
          f"{cfg.d_ff}, tied vocab {cfg.vocab_size}, M-RoPE sections "
          f"{cfg.mrope_sections}), bf16 params, remat, 1 x {VLM_SEQ} "
          f"tokens per learner per step ({cfg.frontend_tokens} stub patch "
          f"embeddings + {VLM_SEQ - cfg.frontend_tokens} chain tokens)")
    state, rb, launches = bf16_rounds(
        torch, label, bundle, hier, loader, eval_batch, counters, LM_ROUNDS,
        floor)
    steps = hier.steps_per_round * LM_ROUNDS
    sizes = lm_leaf_sizes(cfg)
    want = {"flash_attention_forward": cfg.n_layers * (2 * steps
                                                       + LM_ROUNDS),
            "flash_attention_backward": cfg.n_layers * steps,
            "topk_compress": len(sizes) * LM_ROUNDS,
            "topk_compress_calls": len(topk_groups(sizes, 4)) * LM_ROUNDS,
            "rwkv6_wkv_forward": 0, "rwkv6_wkv_backward": 0}
    if launches != want:
        fail(f"{label}: launches {launches} != {want} (layers x (2 x "
             f"steps under remat + evals), layers x steps, leaves and "
             f"grouped calls x global fires)")
    parts = lm_parts(torch, bundle, hier.resolved_plan, state, rb)
    print(f"{label} parts: step_wall_ms={parts['step']:.3f} "
          + " ".join(f"{k}_fire_ms={v:.3f}" for k, v in parts.items()
                     if k != "step"))
    cpu_state = comparison_copy(torch, state)
    del state
    rb2 = loader.next_round()

    def make_round(remat, impl="auto"):
        _, b, _, _ = lm_setup(torch, VLM_ARCH, VLM_LAYERS, VLM_SEQ,
                              impl=impl, param_dtype=torch.bfloat16,
                              remat=remat)
        plan = hier.resolved_plan if impl == "auto" \
            else plain_plan(hier.resolved_plan)
        return make_hier_round(b.loss_fn, sgd(0.1), hier, plan=plan)

    # kernel against plain (attention and top-k), one round from one state
    # copy, at the bf16 limits; a control on another batch must fail them
    old = leaves(cpu_state.params)
    news, losses, walls = {}, {}, {}
    shifted = dict(rb2, labels=rb2["labels"].roll(1, dims=-1))
    for tag, impl, batch in (("kernel", "auto", rb2), ("plain", "plain", rb2),
                             ("control", "auto", shifted)):
        st, m, walls[tag], peak = one_round(torch, make_round(True, impl),
                                            cpu_state, batch)
        if tag == "kernel":             # remat's "on" round, kept
            remat_on = (state_to(torch, st, "cpu"), m, walls[tag], peak)
            news[tag] = leaves(remat_on[0].params)
        else:
            news[tag] = [p.cpu() for p in leaves(st.params)]
        losses[tag] = m["loss"].item()
        del st, m
    def rel(tag):
        return abs(losses[tag] - losses["plain"]) / abs(losses["plain"])

    dist = update_rel_l2(torch, news["kernel"], news["plain"], old)
    ctrl = update_rel_l2(torch, news["control"], news["plain"], old)
    del news
    print(f"{label} kernel vs plain (attention and top-k): 1 round from one "
          f"state copy: loss {losses['kernel']:.6f} vs {losses['plain']:.6f} "
          f"(rel {rel('kernel'):.3e}, limit {BF16_LOSS_REL:.3e}); the "
          f"round's update rel L2 {dist:.4f} (limit {BF16_UPDATE_L2}); "
          f"control, the labels shifted by one: loss rel "
          f"{rel('control'):.3e}, update {ctrl:.4f} (must fail both); "
          f"round_wall_ms kernel={walls['kernel']:.1f} "
          f"plain={walls['plain']:.1f}")
    if rel("kernel") > BF16_LOSS_REL or dist > BF16_UPDATE_L2:
        fail(f"{label} kernel vs plain round outside the bf16 limits")
    if rel("control") <= BF16_LOSS_REL or ctrl <= BF16_UPDATE_L2:
        fail(f"{label}: the shifted-label control is within a limit")

    *peaks, _ = remat_identity(torch, label, make_round, cpu_state, rb2,
                               on=remat_on)
    del remat_on
    st = state_to(torch, cpu_state, "cuda")
    del cpu_state
    profile_round(torch, make_round(True), st, rb2, f"{label} (one round)",
                  LM_CLASSES, ops=True)
    del st
    gc.collect()
    torch.cuda.empty_cache()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    attn = vlm_attn_times(torch, cfg, flush)
    return launches, attn, peaks


# --------------------------------------------------------------------- #
# phase 14: elastic membership, telemetry, checkpoints and reshape


def missed_fire_check(torch, state, plan, active):
    """One fire of each level of the trainer's own reduce on ``state``
    with the learners ``~active[i]`` out: their params and EF (every
    stacked leaf) come out bit for bit unchanged, the others' change.
    Returns the number of absent learners checked."""
    from repro_torch.core.hier_avg import _make_reduce
    from repro_torch.tree import leaves

    reduce = _make_reduce(None, None, False)
    checked = 0
    for i, lvl in enumerate(plan.levels):
        m = torch.as_tensor(active[i]).to("cuda")
        out = reduce(lvl, state, m)
        before = leaves(state.params) + leaves(state.comm_state)
        after = leaves(out.params) + leaves(out.comm_state)
        absent = (~m).nonzero().tolist()
        stacked = [(a, b) for a, b in zip(before, after)
                   if tuple(a.shape[:3]) == tuple(m.shape)]
        for j in absent:
            if not all(same_bits(torch, a[tuple(j)], b[tuple(j)])
                       for a, b in stacked):
                fail(f"phase 14: absent learner {j} changed across a "
                     f"missed {lvl.name} fire")
        present = m.nonzero().tolist()
        if present and all(same_bits(torch, a[tuple(present[0])],
                                     b[tuple(present[0])])
                           for a, b in zip(leaves(state.params),
                                           leaves(out.params))):
            fail(f"phase 14: a present learner's params did not move in "
                 f"the {lvl.name} fire")
        checked += len(absent)
        del out
    return checked


def phase_elastic(torch, phase7_walls):
    """Phase 14: elastic rounds, a faulted run, telemetry, reshape and the
    training CLI with its new flags; returns the launch counts of the
    main path (the faulted kernel run and the CLI)."""
    import hashlib
    import warnings

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs.base import HierAvgParams
    from repro_torch.convert import train_state_to_numpy
    from repro_torch.core.hier_avg import (init_state, make_hier_round,
                                           make_sgd_step)
    from repro_torch.core.plan import ReductionPlan
    from repro_torch.core.simulator import Simulator
    from repro_torch.core.topology import HierTopology
    from repro_torch.elastic import (CommStateDropWarning, FaultSchedule,
                                     elastic_restore, level_deadlines,
                                     save_elastic_checkpoint)
    from repro_torch.kernels.qint8_pack import qint8_pack as qp
    from repro_torch.kernels.qint8_pack import qint8_unpack as qu
    from repro_torch.kernels.rwkv6_wkv import (rwkv6_wkv_backward,
                                               rwkv6_wkv_forward)
    from repro_torch.kernels.topk_compress import topk_compress as tk
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import sgd
    from repro_torch.telemetry import MetricsLogger, validate_jsonl
    from repro_torch.tree import leaves

    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    topo = HierTopology(1, 4, 4)
    loss_fn, init_fn, sample, _ = resnet_task(torch)
    n = 8 * topo.n_learners * 32

    def round_batches(seed, count):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        out = []
        for _ in range(count):
            b = sample(gen, n)
            out.append({k: v.reshape((4, 2) + topo.shape + (32,)
                                     + tuple(v.shape[1:]))
                        for k, v in b.items()})
        return out

    # (a) full participation: all-true masks equal the dense rounds bit for
    # bit; a mask with one learner out must not
    walls = {}
    for tag, spec, kw in (("per leaf", ELASTIC_PLANS[0], {"bucket_bytes": 0}),
                          ("plan A", ELASTIC_PLANS[1], {})):
        hier = HierAvgParams(plan=spec, **kw)
        plan = ReductionPlan.parse(spec)
        state = init_state(topo, init_fn, sgd(0.1),
                           torch.Generator(device="cuda").manual_seed(0),
                           plan=hier.resolved_plan, device="cuda")
        np_state = train_state_to_numpy(state)
        del state
        batches = round_batches(3, 2)
        ones = torch.ones((2,) + topo.shape, dtype=torch.bool)
        one_out = ones.clone()
        one_out[:, 0, 0, 0] = False
        wd, we = [], []
        sd, ld = rounds_from(torch, loss_fn, hier, plan, np_state, batches,
                             walls=wd)
        se, le = rounds_from(torch, loss_fn, hier, plan, np_state, batches,
                             [ones] * 2, walls=we)
        bad, _ = differing(torch, sd, se, ld, le)
        if bad:
            fail(f"phase 14a {tag}: all-true elastic rounds differ from the "
                 f"dense rounds in {bad} leaves")
        del se
        sc, lc = rounds_from(torch, loss_fn, hier, plan, np_state,
                             batches[:1], [one_out])
        sd1, ld1 = rounds_from(torch, loss_fn, hier, plan, np_state,
                               batches[:1])
        if not differing(torch, sd1, sc, ld1, lc)[0]:
            fail(f"phase 14a {tag}: a mask with one learner out equals the "
                 f"dense round (control)")
        walls[tag] = (wd, we)
        print(f"phase 14a {tag} {hier.resolved_plan.describe()}: 2 rounds "
              f"all-true elastic == dense bit for bit (params, EF, losses "
              f"{fmt(ld.tolist())}); one-learner-out control differs; round "
              f"wall ms dense {fmt(wd)} elastic {fmt(we)}")
        del sd, sc, sd1, np_state, batches

    # (b) a faulted run, plan A on the pipelined buckets, with the kernels
    # (the main path: counts set to 0 just before, read just after) and
    # with the plain versions
    hier = HierAvgParams(plan=ELASTIC_PLANS[1])
    plan = ReductionPlan.parse(ELASTIC_PLANS[1])
    resolved = hier.resolved_plan
    tmpl_sim = Simulator(loss_fn, init_fn, sample, topo=topo, hier=hier,
                         device="cuda")
    deadlines = level_deadlines(resolved, topo, tmpl_sim.template())
    faults = FaultSchedule(ELASTIC_FAULTS, topo,
                           [lvl.name for lvl in resolved.levels], seed=0,
                           deadlines=deadlines)
    masks = [faults.active(r) for r in range(TRAIN_ROUNDS)]
    sha = hashlib.sha256(b"".join(m.tobytes() for m in masks)).hexdigest()
    if sha != ELASTIC_MASK_SHA:
        fail(f"phase 14b: mask stream sha256 {sha} != the reference's "
             f"{ELASTIC_MASK_SHA}")
    fracs = [faults.active_frac(r).tolist() for r in range(TRAIN_ROUNDS)]
    if all(f[-1] == 1.0 for f in fracs):
        fail("phase 14b: no learner missed a global fire")
    modeled = [tmpl_sim.round_wall_estimate(f) for f in fracs]
    state = init_state(topo, init_fn, sgd(0.1),
                       torch.Generator(device="cuda").manual_seed(0),
                       plan=resolved, device="cuda")
    np_state = train_state_to_numpy(state)
    del state
    batches = round_batches(4, TRAIN_ROUNDS)
    counters = {"topk_compress": tk, "qint8_pack": qp, "qint8_unpack": qu}
    zero_counts(counters)
    wk, wp = [], []
    sk, lk = rounds_from(torch, loss_fn, hier, plan, np_state, batches, masks,
                         walls=wk)
    launches = read_counts(counters)
    if not all(launches[k] > 0 for k in counters):
        fail(f"phase 14b: a kernel of the path was not launched: {launches}")
    sp, lp = rounds_from(torch, loss_fn, hier, plain_plan(plan), np_state,
                         batches, masks, walls=wp)
    bad, _ = differing(torch, sk, sp, lk, lp)
    if bad:
        fail(f"phase 14b: kernel and plain faulted runs differ in {bad} "
             f"leaves (losses {lk.tolist()} vs {lp.tolist()})")
    del sp
    # one more SGD step first, so that every learner's params differ
    step = make_sgd_step(loss_fn, sgd(0.1))
    st, _ = step(sk, {k: v[0, 0] for k, v in batches[0].items()})
    checked = missed_fire_check(torch, st, resolved, masks[-1])
    del st
    print(f"phase 14b faulted run {ELASTIC_FAULTS} seed 0, plan "
          f"{resolved.describe()}: deadlines {deadlines}; active fractions "
          f"(local, global) {fracs}; modeled round walls s {modeled}; mask "
          f"sha256 {sha}; losses {fmt(lk.tolist())}; kernel == plain bit for "
          f"bit (params, EF, losses); round wall ms kernel {fmt(wk)} plain "
          f"{fmt(wp)}; {checked} absent learners bit-unchanged across a "
          f"missed fire; launches {launches}")
    del sk, np_state, batches

    # (c) telemetry: the Simulator with faults, fenced by a MetricsLogger,
    # telemetry off and on
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tel in (None, True):
            path = os.path.join(tmp, f"rows{tel}.jsonl")
            logger = MetricsLogger(path)
            sim = Simulator(loss_fn, init_fn, sample, topo=topo, hier=hier,
                            optimizer=sgd(0.1), per_learner_batch=32, seed=0,
                            faults=ELASTIC_FAULTS, telemetry=tel,
                            metrics=logger, device="cuda")
            res = sim.run(TRAIN_ROUNDS)
            logger.close()
            rows = validate_jsonl(path)
            if len(rows) != TRAIN_ROUNDS:
                fail(f"phase 14c: {len(rows)} train_round rows")
            runs[tel] = res
            del sim
        off, on = runs[None], runs[True]
        same = same_bits(torch, torch.from_numpy(off.losses),
                         torch.from_numpy(on.losses)) and all(
            same_bits(torch, a, b) for a, b in
            zip(leaves(off.state.params), leaves(on.state.params)))
        if not same:
            fail(f"phase 14c: telemetry on changed the trajectory: losses "
                 f"{off.losses} vs {on.losses}")
        if not np_isfinite(list(on.stats.values())):
            fail(f"phase 14c: telemetry stats not finite: {on.stats}")
        stats = {k.replace("telemetry/", ""): "[" + ",".join(
                     f"{float(x):.4e}" for x in v) + "]"
                 for k, v in sorted(on.stats.items())}
        print(f"phase 14c telemetry: losses and params with telemetry on "
              f"== off bit for bit ({fmt(on.losses)}); {TRAIN_ROUNDS} rows "
              f"valid; fenced (metrics=) round wall ms off "
              f"{fmt(off.measured_wall_s * 1e3)} on "
              f"{fmt(on.measured_wall_s * 1e3)}; stats {stats}")

        # (d) reshape: 16 learners -> (1, 2, 4), survivors bit-preserved
        state16 = on.state
        del runs, off, on
        ck = os.path.join(tmp, "fleet16")
        t0 = time.perf_counter()
        save_elastic_checkpoint(ck, state16, topo, step=state16.step,
                                plan=resolved)
        save_s = time.perf_counter() - t0
        new_topo = HierTopology(1, 2, 4)
        like = init_state(new_topo, init_fn, sgd(0.1),
                          torch.Generator(device="cuda").manual_seed(1),
                          plan=resolved, device="cuda")
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", CommStateDropWarning)
            got = elastic_restore(ck, like, new_topo=new_topo)
        restore_s = time.perf_counter() - t0
        drops = [str(w.message) for w in caught
                 if issubclass(w.category, CommStateDropWarning)]
        del like
        n_new = new_topo.n_learners
        for a, b in zip(leaves(state16.params) + leaves(state16.comm_state),
                        leaves(got.params) + leaves(got.comm_state)):
            if tuple(a.shape[:3]) != topo.shape:
                continue
            a8 = a.reshape((-1,) + tuple(a.shape[3:]))[:n_new]
            if not same_bits(torch, a8, b.reshape(a8.shape)):
                fail("phase 14d: a survivor's state changed in the reshape")
        del state16
        rnd = make_hier_round(loss_fn, sgd(0.1), hier)
        b = sample(torch.Generator(device="cuda").manual_seed(5),
                   8 * n_new * 32)
        b = {k: v.reshape((4, 2) + new_topo.shape + (32,)
                          + tuple(v.shape[1:])) for k, v in b.items()}
        got, m = rnd(got, b)
        loss8 = float(m["loss"])
        if not math.isfinite(loss8):
            fail(f"phase 14d: loss after the reshape {loss8}")
        print(f"phase 14d reshape: save_elastic_checkpoint at 16 learners "
              f"({save_s:.2f}s), elastic_restore onto {new_topo.shape} "
              f"({restore_s:.2f}s), survivors bit-preserved, "
              f"CommStateDropWarning: {drops or 'none'}; one round after "
              f"it: loss {loss8:.4f}")
        del got, rnd, b

        # (e) the training CLI on the card with the six new flags
        wkv = {"rwkv6_wkv_forward": rwkv6_wkv_forward,
               "rwkv6_wkv_backward": rwkv6_wkv_backward}
        zero_counts(wkv)
        out = {k: os.path.join(tmp, k) for k in ("ck", "m.jsonl",
                                                  "trace.json", "prof")}
        t0 = time.perf_counter()
        train_cli.main(["--arch", "rwkv6-1.6b", "--rounds", "2",
                        "--learners", "4", "--s", "2", "--batch", "2",
                        "--seq", "64", "--reducer", "topk:0.1",
                        "--faults", ELASTIC_FAULTS, "--telemetry",
                        "--metrics-out", out["m.jsonl"],
                        "--trace-out", out["trace.json"],
                        "--profile-dir", out["prof"], "--ckpt", out["ck"]])
        cli_s = time.perf_counter() - t0
        wkv_launches = read_counts(wkv)
        if not all(v > 0 for v in wkv_launches.values()):
            fail(f"phase 14e: the training CLI did not launch both WKV "
                 f"kernels: {wkv_launches}")
        with open(out["trace.json"]) as f:
            events = json.load(f)["traceEvents"]
        prof = os.listdir(out["prof"])
        arrays = load_checkpoint(out["ck"])
        rows = validate_jsonl(out["m.jsonl"])
        if not prof or not arrays or len(rows) != 2 or not all(
                np_isfinite(a) for a in arrays.values()):
            fail(f"phase 14e: profiler dir {prof}, {len(arrays)} "
                 f"checkpoint arrays, {len(rows)} rows")
        print(f"phase 14e cli: launch.train.main --arch rwkv6-1.6b "
              f"(reduced) --reducer topk:0.1 --faults --telemetry "
              f"--metrics-out --trace-out --profile-dir --ckpt on the card in "
              f"{cli_s:.2f}s: {len(events)} trace events, profiler files "
              f"{prof}, {len(arrays)} checkpoint arrays, {len(rows)} rows; "
              f"WKV launches {wkv_launches}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase 14 walls: phase 7 dense rounds ms {fmt(phase7_walls)}; "
          f"14a per leaf dense {fmt(walls['per leaf'][0])} elastic "
          f"{fmt(walls['per leaf'][1])}; plan A dense "
          f"{fmt(walls['plan A'][0])} elastic {fmt(walls['plan A'][1])}; "
          f"14b masked kernel {fmt(wk)}; peak_mem_gib={peak:.2f}")
    launches.update(wkv_launches)
    return launches


# --------------------------------------------------------------------- #
# phases 17 and 18: RWKV-6 serving, MLA + MoE paged serving


def rwkv_states_rel(torch, ca, cb) -> float:
    """max over layers and state kinds of max|a - b| / max|b|."""
    return max(rel_max(a[k], b[k]) for a, b in zip(ca, cb)
               for k in ("tm_shift", "wkv", "cm_shift"))


def without_bonus(params):
    """The RWKV tree with every layer's bonus u set to zero (the
    WKV's u term dropped): phase 17's kernel-vs-plain control."""
    tm = params["layers"]["tm"]
    return dict(params, layers=dict(
        params["layers"], tm=dict(tm, u=tm["u"].new_zeros(tm["u"].shape))))


def phase_rwkv_serve(torch, np):
    """Phase 17: rwkv6-1.6b at full width, RWKV_SERVE_LAYERS of its 24
    layers, bf16 params, through
    ServeEngine: RWKV_REQS seeded requests of RWKV_PLEN tokens in waves of
    RWKV_SLOTS, RWKV_NEW new tokens each.  The prefill runs the WKV
    forward kernel once a layer from the cache's zero state and keeps its
    final state for the decode (plain products).  Held, at fp32 compute
    over the same bf16 params: the kernel prefill's per-layer states and
    last-position logits against impl="plain" (control: plain with the
    bonus u dropped; the bf16 reading is printed beside it), and
    continuity, prefill(p[:n]) then 16 teacher-forced decode steps
    against prefill(p[:n + 16]) (control: the state of the prompt
    shifted by one token, continued with the same 16 tokens)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv_forward
    from repro_torch.models import build
    from repro_torch.serve import GenerationConfig, ServeEngine
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config("rwkv6-1.6b"),
                              n_layers=RWKV_SERVE_LAYERS)
    t0 = time.perf_counter()
    kern = build(cfg, param_dtype=torch.bfloat16, device="cuda")
    params = kern.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in leaves(params))
    rng = np.random.default_rng(17)
    reqs = [rng.integers(0, cfg.vocab_size, size=RWKV_PLEN).astype(np.int32)
            for _ in range(RWKV_REQS)]
    prefill_ms, decode_ms = [], []
    timed = dataclasses.replace(
        kern, prefill=sync_timed(torch, kern.prefill, prefill_ms),
        decode_step=sync_timed(torch, kern.decode_step, decode_ms))
    engine = ServeEngine(timed, params, max_len=RWKV_PLEN + RWKV_NEW,
                         gen=GenerationConfig(max_new_tokens=RWKV_NEW))
    torch.cuda.reset_peak_memory_stats()
    rwkv6_wkv_forward.launches = 0
    t0 = time.perf_counter()
    res = engine.serve_queue(reqs, slots=RWKV_SLOTS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rwkv6_wkv_forward.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    waves = -(-RWKV_REQS // RWKV_SLOTS)
    if launches != cfg.n_layers * waves:
        fail(f"phase 17: WKV forward launches {launches} != {cfg.n_layers} "
             f"layers x {waves} prefills")
    tokens = sum(r.steps for r in res)
    if tokens != RWKV_REQS * RWKV_NEW or not all(
            ((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()
            for r in res):
        fail(f"phase 17: {tokens} tokens or a token outside the vocab")
    print(f"phase 17 serve rwkv6-1.6b full width, {cfg.n_layers} of 24 "
          f"layers, bf16 "
          f"({n_params} params, init {init_s:.1f}s; ServeEngine, "
          f"{RWKV_REQS} x {RWKV_PLEN} tokens in {waves} waves of "
          f"{RWKV_SLOTS}, {RWKV_NEW} new): wall_s={wall:.3f} tokens_per_s="
          f"{tokens / wall:.2f} prefill_ms={fmt(prefill_ms)} "
          f"decode_ms_median={statistics.median(decode_ms):.3f} "
          f"decode_steps={len(decode_ms)} peak_mem_gib={peak:.2f} "
          f"wkv_forward_launches={launches}")

    # kernel prefill against plain, one wave: held at fp32 compute over
    # the bf16 params, reported at the served bf16
    batch = {"tokens": torch.tensor(np.stack(reqs[:RWKV_SLOTS]),
                                    device="cuda")}

    def pair_reading(compute_dtype):
        kw = dict(param_dtype=torch.bfloat16, compute_dtype=compute_dtype,
                  device="cuda")
        k_b, p_b = build(cfg, **kw), build(cfg, impl="plain", **kw)
        lk, ck = k_b.prefill(params, batch)
        lp, cp = p_b.prefill(params, batch)
        lc, cc = p_b.prefill(without_bonus(params), batch)
        return (max(rel_max(lk, lp), rwkv_states_rel(torch, ck, cp)),
                max(rel_max(lc, lp), rwkv_states_rel(torch, cc, cp)))

    sound, control = pair_reading(torch.float32)
    sound16, control16 = pair_reading(torch.bfloat16)

    # continuity at fp32 compute: the kernel's final state into decode
    f32 = build(cfg, param_dtype=torch.bfloat16,
                compute_dtype=torch.float32, device="cuda")
    toks = batch["tokens"]
    n = RWKV_PLEN - RWKV_CONT
    lw, cw = f32.prefill(params, {"tokens": toks})
    _, cn = f32.prefill(params, {"tokens": toks[:, :n]})
    _, cs = f32.prefill(params, {"tokens": toks[:, 1:n + 1]})
    for t in range(n, RWKV_PLEN):
        ln, cn = f32.decode_step(params, toks[:, t], cn)
        ls, cs = f32.decode_step(params, toks[:, t], cs)
    cont = max(rel_max(ln, lw), rwkv_states_rel(torch, cn, cw))
    cont_ctrl = max(rel_max(ls, lw), rwkv_states_rel(torch, cs, cw))
    del cw, cn, cs
    print(f"phase 17 rwkv kernel vs plain prefill (one wave, "
          f"{cfg.n_layers} layers' "
          f"states and the logits, max|diff|/max|ref|) at fp32 compute: "
          f"{sound:.4e} (limit {RWKV_PLAIN_TOL}), control bonus u dropped "
          f"{control:.4e} (must exceed); at bf16 compute, reported: "
          f"{sound16:.4e}, control {control16:.4e}; continuity "
          f"prefill({n}) + {RWKV_CONT} decode steps vs prefill({RWKV_PLEN}) "
          f"at fp32 compute: {cont:.4e} (limit {RWKV_CONT_TOL}), control "
          f"state of the prompt shifted by one token {cont_ctrl:.4e} (must "
          f"exceed)")
    # the WKV forward at the prefill's shape and type (w is fp32, so the
    # wrapper promotes r, k, v: the kernel runs in fp32)
    b, s, h, d = RWKV_SLOTS, RWKV_PLEN, cfg.ssm_heads, cfg.resolved_head_dim
    r, k, v, w, u, s0, _, _ = wkv_inputs(torch, b, s, h, d, torch.float32,
                                         170)
    s0 = torch.zeros_like(s0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    (fb, fby, fbytes), _ = wkv_bound(b, s, h, d, 4)
    ckpt_bytes = b * h * (-(-s // 64)) * d * d * 4
    fb_ck = (fbytes + ckpt_bytes) / HBM_BYTES_PER_S * 1e3
    t = dict(
        ms=time_ms(torch, lambda: rwkv6_wkv_forward(r, k, v, w, u, s0),
                   flush, 10, sleep=WKV_FWD_SLEEP_CYCLES),
        plain_ms=time_ms(torch, lambda: kref.rwkv6_wkv_forward_plain(
            r, k, v, w, u, s0), flush, 2),
        bound_ms=fb, bound_by=fby, bound_ms_with_checkpoints=fb_ck,
        library_ms=None)
    print(f"phase 17 WKV forward at the prefill's shape [{b}, {s}, {h}, "
          f"{d}] fp32, s0 zeros (L2 flushed): ms={fmt_ms(t['ms'])} "
          f"plain_ms={fmt_ms(t['plain_ms'])} bound_ms={fb:.4f} ({fby}, "
          f"{fbytes} B) with the {ckpt_bytes} B of checkpoints "
          f"{fb_ck:.4f}; library: none")
    del params
    return {"rwkv6_wkv_forward": launches}, t


def mla_moe_profile(torch, np, bundle, params, engine):
    """Device time of one decode step over the 8 slots by class (ranges
    around the latent gather, the absorbed attend, the routed MoE chunk
    and its expert products), GEMM kernels by name, and the idle share
    against an unprofiled step's wall."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import attention as att
    from repro_torch.models import moe
    slots, maxp = engine.slots, engine.max_pages_per_seq
    tables = (torch.arange(slots * maxp, dtype=torch.int32, device="cuda")
              .reshape(slots, maxp) + 1)
    lengths = torch.tensor([2000, 1900, 1500, 1200, 900, 600, 300, 100],
                           dtype=torch.int32, device="cuda")
    toks = torch.tensor(np.random.default_rng(3).integers(
        0, bundle.cfg.vocab_size, size=slots), dtype=torch.int32,
        device="cuda")
    active = torch.ones(slots, dtype=torch.bool, device="cuda")

    def step():
        return bundle.decode_step_paged(params, toks, engine.pages, tables,
                                        lengths, active)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    names = {(att, "_gather_latent"): "mla_gather",
             (att, "_mla_absorbed_attend"): "mla_attend",
             (moe, "_route_chunk"): "moe_route",
             (moe, "_expert_ffn"): "moe_experts"}
    saved = {key: getattr(*key) for key in names}

    def ranged(fn, label):
        def run(*a, **k):
            with record_function(label):
                return fn(*a, **k)
        return run
    try:
        for (mod, fn), label in names.items():
            setattr(mod, fn, ranged(saved[(mod, fn)], label))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    finally:
        for (mod, fn), f in saved.items():
            setattr(mod, fn, f)
    ranges = {label: 0.0 for label in names.values()}
    busy = gemm = 0.0
    for ev in prof.key_averages():
        dev = ev.device_time_total
        if ev.key in ranges and "CPU" in str(ev.device_type):
            ranges[ev.key] += dev
        elif "CUDA" in str(ev.device_type) and ev.self_device_time_total > 0:
            if ev.key in ranges:
                continue
            busy += ev.self_device_time_total
            if any(k in ev.key.lower() for k in ("gemm", "gemv", "cutlass",
                                                 "sm90_", "cublas",
                                                 "nvjet")):
                gemm += ev.self_device_time_total
    if busy <= 0:
        print("phase 18 profile: the profiler saw no device time (device "
              "breakdown not measured)")
        return
    cls = {"mla_gather": ranges["mla_gather"],
           "mla_attend": ranges["mla_attend"],
           "moe_dispatch": ranges["moe_route"] - ranges["moe_experts"],
           "moe_experts": ranges["moe_experts"]}
    cls["rest"] = busy - sum(cls.values())
    print(f"phase 18 profile (one decode step, 8 active slots, lengths "
          f"100..2000): wall_ms={wall_us / 1e3:.3f} device_ms="
          f"{busy / 1e3:.3f} idle_share={1 - busy / wall_us:.3f} "
          + " ".join(f"{k}_ms={v / 1e3:.3f} ({v / busy:.3f})"
                     for k, v in cls.items())
          + f" gemm_kernels_ms={gemm / 1e3:.3f} ({gemm / busy:.3f})")


def phase_mla_moe_serve(torch, np):
    """Phase 18: deepseek-v2-lite-16b at full width, MLA_SERVE_LAYERS of
    its 27 layers (one dense, then MoE), bf16, through PagedServeEngine (8 slots, pages of 16,
    chunks of 256): MOE_REQS seeded requests of 256..2048 tokens, budgets
    32..64, at the config's capacity factor.  Then dense against paged at
    a dropless capacity factor, fp32 compute and fp32 caches over the
    same params, on 4 requests of 1024 tokens: the first decode step's logits within
    MOE_DENSE_TOL (control: the paged step attending one page short), and
    the greedy agreement."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.serve import (GenerationConfig, PagedServeEngine,
                                   ServeEngine)

    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              n_layers=MLA_SERVE_LAYERS)
    t0 = time.perf_counter()
    bundle = build(cfg, param_dtype=torch.bfloat16,
                   cache_dtype=torch.bfloat16, device="cuda")
    params = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    rng = np.random.default_rng(18)
    plens = [int(n) for n in rng.integers(256, 2049, size=MOE_REQS)]
    budgets = [int(n) for n in rng.integers(32, 65, size=MOE_REQS)]
    reqs = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in plens]
    engine = PagedServeEngine(
        bundle, params, slots=8, page_size=16,
        max_len=max(p + n for p, n in zip(plens, budgets)),
        prefill_chunk=256, cache_dtype=torch.bfloat16,
        gen=GenerationConfig(max_new_tokens=64))
    decode_ms, prefill_ms = [], []
    engine._decode = sync_timed(torch, engine._decode, decode_ms)
    engine._prefill_chunk = sync_timed(torch, engine._prefill_chunk,
                                       prefill_ms)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = engine.serve_queue(reqs, max_new=budgets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    s = engine.steady_state_summary()
    if [r.steps for r in res] != budgets or not all(
            ((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()
            for r in res):
        fail("phase 18: a request's tokens missed its budget or the vocab")
    if s["refill_events"] < 1:
        fail("phase 18: no slot was refilled")
    tokens = sum(r.steps for r in res)
    print(f"phase 18 serve deepseek-v2-lite-16b full width, "
          f"{cfg.n_layers} of 27 layers, bf16 "
          f"({n_params} params, init {init_s:.1f}s; PagedServeEngine, 8 "
          f"slots, pages of 16, chunks of 256, capacity factor "
          f"{cfg.capacity_factor}): requests={len(res)} tokens={tokens} "
          f"wall_s={wall:.3f} tokens_per_s={tokens / wall:.2f} "
          f"decode_steps={engine.decode_calls} decode_ms_median="
          f"{statistics.median(decode_ms):.3f} prefill_chunks="
          f"{len(prefill_ms)} prefill_ms_median="
          f"{statistics.median(prefill_ms):.3f} peak_mem_gib={peak:.2f} "
          f"peak_pages_in_use={s['peak_pages_in_use']}/{s['pool_pages']} "
          f"refill_events={s['refill_events']}")
    mla_moe_profile(torch, np, bundle, params, engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # dense against paged, dropless, fp32 compute over the same params
    dl = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    f32 = build(dl, param_dtype=torch.bfloat16, compute_dtype=torch.float32,
                cache_dtype=torch.float32, device="cuda")
    first = {}

    def first_logits(tag, fn):
        def run(*a, **k):
            lg, cache = fn(*a, **k)
            first.setdefault(tag, lg.float())
            return lg, cache
        return run

    reqs4 = [rng.integers(0, cfg.vocab_size, size=MOE_CMP_PLEN)
             .astype(np.int32) for _ in range(4)]
    gen = GenerationConfig(max_new_tokens=MOE_CMP_NEW)
    dense = ServeEngine(dataclasses.replace(
        f32, decode_step=first_logits("dense", f32.decode_step)), params,
        max_len=MOE_CMP_PLEN + MOE_CMP_NEW, gen=gen)
    dres = dense.serve_queue(reqs4, slots=4)
    paged = PagedServeEngine(dataclasses.replace(
        f32, decode_step_paged=first_logits("paged", f32.decode_step_paged)),
        params, slots=4, page_size=16, max_len=MOE_CMP_PLEN + MOE_CMP_NEW,
        prefill_chunk=256, cache_dtype=torch.float32, gen=gen)
    pres = paged.serve_queue(reqs4)
    dtoks = np.stack([r.tokens for r in dres])
    ptoks = np.stack([r.tokens for r in pres])
    sound = rel_max(first["paged"], first["dense"])
    logits_ctrl = paged_one_page_short(torch, f32, params, reqs4, dtoks)
    control = rel_max(logits_ctrl, first["dense"])
    share, firstdiff = agreement(np, dtoks, ptoks)
    print(f"phase 18 dense vs paged (capacity factor "
          f"{dl.capacity_factor:.4f}, dropless; fp32 compute and caches "
          f"over the bf16 params; 4 x {MOE_CMP_PLEN} tokens, {MOE_CMP_NEW} new): first "
          f"tokens equal {bool((dtoks[:, 0] == ptoks[:, 0]).all())}; first "
          f"decode step's logits max|diff|/max|logit| {sound:.4e} (limit "
          f"{MOE_DENSE_TOL}), control attending one page short "
          f"{control:.4e} (must exceed); greedy tokens equal {share:.4f}, "
          f"first difference per request {firstdiff}")
    if not (dtoks[:, 0] == ptoks[:, 0]).all():
        fail("phase 18: the dense and paged prefills sampled different "
             "first tokens")
    if not math.isfinite(sound) or sound > MOE_DENSE_TOL:
        fail(f"phase 18 dense vs paged first decode logits {sound:.4e} > "
             f"{MOE_DENSE_TOL}")
    if not control > MOE_DENSE_TOL:
        fail(f"phase 18 control reads {control:.4e} <= {MOE_DENSE_TOL}")
    del params, paged, dense
    return {"tokens_per_s": tokens / wall, "peak_gib": peak}


def paged_one_page_short(torch, bundle, params, reqs, dtoks):
    """The first paged decode step of phase 18's comparison with every
    slot's length one page short: a fresh pool, each prompt prefilled in
    chunks of 256, then the step at lengths - 16 (it attends 16 fewer
    prompt keys, at a rope position 16 early, and writes its latent over
    position length - 16)."""
    page, chunk = 16, 256
    b = len(reqs)
    maxp = -(-max(len(p) for p in reqs) // page) + 2
    pages = bundle.init_paged_cache(1 + b * maxp, page)
    tables = (torch.arange(b * maxp, dtype=torch.int32, device="cuda")
              .reshape(b, maxp) + 1)
    for i, p in enumerate(reqs):
        for c0 in range(0, len(p), chunk):
            toks = torch.tensor(p[None, c0:c0 + chunk], device="cuda")
            _, pages = bundle.prefill_paged_chunk(params, toks, pages,
                                                  tables[i:i + 1], c0)
    lengths = torch.tensor([len(p) - page for p in reqs], dtype=torch.int32,
                           device="cuda")
    toks = torch.tensor(dtoks[:, 0], dtype=torch.int32, device="cuda")
    lg, _ = bundle.decode_step_paged(params, toks, pages, tables, lengths,
                                     torch.ones(b, dtype=torch.bool,
                                                device="cuda"))
    return lg.float()


# --------------------------------------------------------------------- #
# phases 22 and 23: the Hymba hybrid and the encoder-decoder at published
# widths, trained under Hier-AVG and served
#
# Phase 22, hymba-1.5b (d 1600, 25/5 heads of 64, d_ff 5504, d_inner 3200,
# state 16, window 1024, vocab 32001), 2 of its 32 layers, fp32: the two
# layers, the embedding and the head hold 200,302,400 params a learner, so
# 4 learners keep 3.2 GB of params and at the per-leaf top-k fire ~32 B a
# param a learner (params, EF ref and err, the delta, its decompressed and
# averaged trees), ~26 GB: fp32 fits with room.  2048 tokens a learner:
# the window masks keys, and the scan runs 8 chunks of 256 under remat.
# Phase 23, seamless-m4t-large-v2 (d 1024, 16/16 heads of 64, d_ff 8192
# relu, vocab 256206, 1024 stub frames), 2 + 2 of its 24 + 24 layers, 512
# text tokens: 617,099,264 params a learner, 525 M of them the embedding
# and the head; fp32 at ~32 B a param a learner would hold ~79 GB at the
# fire, more than the card's 80 GB with the steps' logits, so bf16 params
# with remat, as phase 16, at its measured 26.5 B (~61 GiB).
HYMBA_ARCH, HYMBA_LAYERS, HYMBA_SEQ = "hymba-1.5b", 2, 2048
SEAMLESS_ARCH, SEAMLESS_LAYERS, SEAMLESS_SEQ = ("seamless-m4t-large-v2", 2,
                                                512)
NEW_FAMILY_PLAN = "local@2/global@8:topk:0.05"
# rounds trained (the eval loss must fall from the init's over them):
# hymba's are the slow ones (the scan's step loop), 1; seamless 3, where
# its round limits below were read
HYMBA_ROUNDS, SEAMLESS_ROUNDS = 1, 3
# phase 23's kernel-against-plain round, bf16 after 3 rounds: phase 16's
# limits (BF16_LOSS_REL, BF16_UPDATE_L2) hold a round trained on labels
# shifted by one position too, which read loss rel 1.16e-4 and update
# 0.132 on an H100 there (5.4e-5 and 0.186 after 6 rounds), while the
# sound round read 3.8e-7 and 0.0577 (2.6e-6 / 0.0678 after 2 rounds,
# 2.5e-5 / 0.0745 after 6).  The loss averages ~2048 tokens a learner
# step, so independent bf16 roundings of 2^-9 shrink to ~2^-9 / 45 there:
# SEAMLESS_LOSS_REL 2^-15 (3.05e-5).  The update limit sits between the
# sound readings and the shifted ones: SEAMLESS_UPDATE_L2 0.1.  Both were
# set after those readings; the shifted-label control must fail both.
SEAMLESS_LOSS_REL, SEAMLESS_UPDATE_L2 = 2.0 ** -15, 0.1
# serving: one wave of SERVE_WAVE prompts, NEW_FAMILY_NEW greedy tokens
# each, fp32 params and cache (kernel and plain attention then differ by
# ~1e-6 of a logit, far inside the top-2 gaps of random weights, so the
# greedy tokens must be identical)
SERVE_WAVE, NEW_FAMILY_NEW = 4, 32
HYMBA_SERVE_PLEN, SEAMLESS_SERVE_PLEN = 2048, 512
# the round's device time by kernel class; the scan's forward steps are
# its addcmul kernels (its backward's products are elementwise ones)
NEW_FAMILY_CLASSES = (
    ("flash_attention", ("attn_",)),
    ("topk_compress", ("topk_",)),
    ("scan_addcmul", ("addcmul",)),
    ("gemm", ("gemm", "cutlass", "xmma", "sm90_", "sm80_", "ampere",
              "nvjet")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("reduce", ("reduce",)),
    ("softmax", ("softmax",)),
)


def sdpa_call(torch, F, q, k, v, window):
    """One scaled_dot_product_attention call computing the kernel's
    function on [B, S, H, D] inputs: causal, or under a boolean band mask
    of ``window`` keys (SDPA has no window flag), GQA."""
    s = q.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if not window:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    i = torch.arange(s, device="cuda")
    band = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=band, enable_gqa=True)


def attn_at_shape(torch, label, b, s, hq, hkv, d, window, dtype, seed):
    """The attention kernels at a model's training shape (the learners
    folded into B): forward (o, lse) and backward (dq, dk, dv) held to
    their plain versions at phase 11's limits, a control that must fail
    them (the window, or causality, one key short: plain with window
    ``(window or s) - 1``), and times against plain, one SDPA call (and
    its backward) and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_fwd)
    q, k, v, do = attn_inputs(torch, b, s, hq, hkv, d, dtype, seed)
    ok_, lk = flash_attention_fwd(q, k, v, window=window)
    op, lp = kref.flash_attention_plain(q, k, v, window=window)
    op = op.contiguous()
    gk = flash_attention_backward(q, k, v, op, lp, do, window=window)
    gp = kref.flash_attention_backward_plain(q, k, v, op, lp, do,
                                             window=window)
    torch.cuda.synchronize()
    meas, worst = {}, 0.0
    for name, a, bb in zip(("o", "lse", "dq", "dk", "dv"), (ok_, lk, *gk),
                           (op, lp, *gp)):
        err, meas[name] = hold(torch, f"{label} attention {name}", a, bb)
        worst = max(worst, err)
    short = (window or s) - 1
    ob, lb = kref.flash_attention_plain(q, k, v, window=short)
    gb = kref.flash_attention_backward_plain(q, k, v, ob, lb, do,
                                             window=short)
    ctrl = (control(torch, f"{label} o, window {short}", ob, op),
            control(torch, f"{label} dk, window {short}", gb[1], gp[1]))
    del ob, lb, gb, gk, gp
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    sdpa = sdpa_call(torch, F, q, k, v, window)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = sdpa_call(torch, F, qt.transpose(1, 2), kt.transpose(1, 2),
                    vt.transpose(1, 2), window)()
    dot = do.transpose(1, 2)
    (fb, fby, _, fbasis), (bb_, bby, _, bbasis) = attn_bound(
        b, s, hq, hkv, d, window, q.element_size())
    t = dict(
        ms=time_ms(torch, lambda: flash_attention_fwd(q, k, v,
                                                      window=window),
                   flush, 10),
        plain_ms=time_ms(torch, lambda: kref.flash_attention_plain(
            q, k, v, window=window), flush, 3),
        library_ms=time_ms(torch, sdpa, flush, 10),
        bound_ms=fb, bound_by=fby, max_abs_err=worst,
        bwd_ms=time_ms(torch, lambda: flash_attention_backward(
            q, k, v, op, lp, do, window=window), flush, 5),
        bwd_plain_ms=time_ms(torch, lambda: kref.
                             flash_attention_backward_plain(
                                 q, k, v, op, lp, do, window=window),
                             flush, 2),
        bwd_library_ms=time_ms(torch, lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), flush, 3),
        bwd_bound_ms=bb_, bwd_bound_by=bby)
    print(f"{label} attention at the training shape (B{b} S{s} Hq{hq} "
          f"Hkv{hkv} D{d} window {window} {str(dtype)[6:]}, L2 flushed): "
          f"kernel vs plain " + " ".join(f"{n}={m:.2e}"
                                         for n, m in meas.items())
          + f" (fp32: share of {KERN_REL_TOL} x max|plain|; bf16: share "
          f"of the element's limit); control window {short}: o "
          f"{ctrl[0]:.2e} dk {ctrl[1]:.2e} (must fail); fwd_ms="
          f"{fmt_ms(t['ms'])} plain_ms={fmt_ms(t['plain_ms'])} sdpa_ms="
          f"{fmt_ms(t['library_ms'])} bound_ms={fb:.4f} ({fby}, {fbasis}); "
          f"bwd_ms={fmt_ms(t['bwd_ms'])} plain_ms="
          f"{fmt_ms(t['bwd_plain_ms'])} sdpa_bwd_ms="
          f"{fmt_ms(t['bwd_library_ms'])} bound_ms={bb_:.4f} ({bby}, "
          f"{bbasis})")
    del q, k, v, do, ok_, lk, op, lp, out, qt, kt, vt, flush
    return t


def new_family_launches(label, launches, cfg, hier, remat, rounds):
    """Exact launch counts of ``rounds`` trained rounds and rounds + 1
    evals (the init's, then each round's): the causal attention forward
    once per layer per step (twice under remat) and per eval, its
    backward once per layer per step, top-k once per leaf per global fire
    in the reducer's grouped calls; no WKV."""
    steps = hier.steps_per_round * rounds
    sizes = lm_leaf_sizes(cfg)
    want = {"flash_attention_forward": cfg.n_layers * ((1 + remat) * steps
                                                       + rounds + 1),
            "flash_attention_backward": cfg.n_layers * steps,
            "topk_compress": len(sizes) * rounds,
            "topk_compress_calls": len(topk_groups(sizes, 4)) * rounds,
            "rwkv6_wkv_forward": 0, "rwkv6_wkv_backward": 0}
    if launches != want:
        fail(f"{label}: launches {launches} != {want} (layers x ({1 + remat}"
             f" x steps + rounds + 1 evals), layers x steps, leaves and "
             f"grouped calls x global fires)")


def kernel_plain_control(torch, label, make_round, cpu_state, rb, bf16,
                         profile):
    """One round from one state copy with the kernels, with their plain
    versions and, as the control, with the kernels on the labels shifted
    by one position (phase 16's control: an off-by-one in the targets).
    The control's round runs under the profiler (``profile``:
    profile_round's keyword arguments): the same program and shapes as
    the kernel's, on other labels, with the kernel round's unprofiled
    wall as the idle share's reference.  fp32 (phases 12-13's limits):
    the loss within LM_LOSS_TOL relative and params within LM_PARAM_TOL
    of their leaf's max except LM_SWAP_FRAC of them; bf16: the loss
    within SEAMLESS_LOSS_REL, the round's update within
    SEAMLESS_UPDATE_L2 relative L2.  The control must fail both.
    Returns the kernel round's wall ms."""
    from repro_torch.tree import leaves
    old = leaves(cpu_state.params)
    news, losses, walls = {}, {}, {}
    shifted = dict(rb, labels=rb["labels"].roll(1, dims=-1))
    for tag, impl, batch in (("kernel", "auto", rb), ("plain", "plain", rb),
                             ("control", "auto", shifted)):
        if tag == "control":
            st = state_to(torch, cpu_state, "cuda")
            torch.cuda.synchronize()
            _, (st, m) = profile_round(torch, make_round(impl), st, batch,
                                       wall_ms=walls["kernel"], keep=True,
                                       **profile)
        else:
            st, m, walls[tag], _ = one_round(torch, make_round(impl),
                                             cpu_state, batch)
        news[tag] = [p.cpu() for p in leaves(st.params)]
        losses[tag] = m["loss"].item()
        del st, m
        gc.collect()
        torch.cuda.empty_cache()

    def rel(tag):
        return abs(losses[tag] - losses["plain"]) / abs(losses["plain"])

    if bf16:
        lim_loss, lim_p = SEAMLESS_LOSS_REL, SEAMLESS_UPDATE_L2
        dist = update_rel_l2(torch, news["kernel"], news["plain"], old)
        ctrl = update_rel_l2(torch, news["control"], news["plain"], old)
        p_ok, c_ok = dist <= lim_p, ctrl <= lim_p
        words = (f"the round's update rel L2 {dist:.4f} (limit {lim_p}); "
                 f"control update {ctrl:.4f}")
    else:
        lim_loss = LM_LOSS_TOL
        worst, beyond, total = compare_params(torch, news["kernel"],
                                              news["plain"])
        _, c_beyond, _ = compare_params(torch, news["control"],
                                        news["plain"])
        p_ok = beyond <= LM_SWAP_FRAC * total
        c_ok = c_beyond <= LM_SWAP_FRAC * total
        words = (f"params max rel {worst:.3e}, {beyond} of {total} "
                 f"coordinates beyond {LM_PARAM_TOL} of their leaf's max "
                 f"(limit {LM_SWAP_FRAC} of them); control {c_beyond} "
                 f"beyond")
    del news
    print(f"{label} kernel vs plain (attention and top-k): 1 round from one "
          f"state copy: loss {losses['kernel']:.6f} vs {losses['plain']:.6f}"
          f" (rel {rel('kernel'):.3e}, limit {lim_loss:.3e}); {words}; "
          f"control, the labels shifted by one: loss rel "
          f"{rel('control'):.3e} (must fail both); round_wall_ms kernel="
          f"{walls['kernel']:.1f} plain={walls['plain']:.1f}")
    if rel("kernel") > lim_loss or not p_ok:
        fail(f"{label} kernel vs plain round outside its limits")
    if rel("control") <= lim_loss or c_ok:
        fail(f"{label}: the shifted-label control is within a limit")
    return walls["kernel"]


def ssm_head_ms(torch, state, cfg):
    """Host wall (across a synchronize) of the first layer's SSM head,
    mamba_apply, over the trainer's 4 learners at HYMBA_SEQ tokens each:
    forward and backward under vmap(grad) (a training step's), and the
    forward alone (an eval's)."""
    from repro_torch.models import mamba
    from repro_torch.tree import tree_map
    p = tree_map(lambda a: a.reshape((4,) + a.shape[3:])[:, 0].detach(),
                 state.params["layers"]["ssm"])
    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn((4, 1, HYMBA_SEQ, cfg.d_model), generator=g,
                    device="cuda")
    w = torch.randn((4, 1, HYMBA_SEQ, cfg.d_model), generator=g,
                    device="cuda")

    def head(p, x, w):
        return (mamba.mamba_apply(p, x, state=cfg.ssm_state)[0] * w).sum()

    step = torch.func.vmap(torch.func.grad(head))
    fwd = torch.func.vmap(head)
    with torch.no_grad():
        fwd_ms = wall_ms(torch, lambda: fwd(p, x, w), 2)
    return wall_ms(torch, lambda: step(p, x, w), 2), fwd_ms


def serve_new_family(torch, np, label, cfg, plen, seed):
    """``cfg`` (cut in depth) through ServeEngine with fp32 params and
    cache: one wave of SERVE_WAVE seeded prompts of ``plen`` tokens (and,
    for the encoder-decoder, the stub's frames), NEW_FAMILY_NEW greedy
    tokens each.  The prefill launches one attention forward per
    (decoder) layer; the greedy tokens with impl="plain" must be the
    kernel's.  Returns the forward launches."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models import build
    from repro_torch.models.stubs import audio_frame_embeds
    from repro_torch.serve import GenerationConfig, ServeEngine

    def bundle(impl):
        return build(cfg, param_dtype=torch.float32,
                     cache_dtype=torch.float32, impl=impl, device="cuda")

    kern = bundle("auto")
    params = kern.init(torch.Generator(device="cuda").manual_seed(seed))
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, size=(SERVE_WAVE, plen)
                           ).astype(np.int32)
    extras = None
    if cfg.is_encoder_decoder:
        extras = {"frames": audio_frame_embeds(
            torch.Generator(device="cuda").manual_seed(seed + 1), SERVE_WAVE,
            cfg.frontend_tokens, cfg.d_model)}
    prefill_ms, decode_ms = [], []
    timed = dataclasses.replace(
        kern, prefill=sync_timed(torch, kern.prefill, prefill_ms),
        decode_step=sync_timed(torch, kern.decode_step, decode_ms))
    gen = GenerationConfig(max_new_tokens=NEW_FAMILY_NEW)
    max_len = plen + NEW_FAMILY_NEW
    ServeEngine(kern, params, max_len=max_len, gen=GenerationConfig(
        max_new_tokens=2)).generate(prompts[:, :64], extras)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    toks = ServeEngine(timed, params, max_len=max_len, gen=gen).generate(
        prompts, extras)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention_fwd.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    plain = ServeEngine(bundle("plain"), params, max_len=max_len,
                        gen=gen).generate(prompts, extras)
    share, first = agreement(np, toks, plain)
    n_tok = SERVE_WAVE * NEW_FAMILY_NEW
    print(f"{label} serve (ServeEngine, fp32 params and cache, "
          f"{SERVE_WAVE} x {plen} tokens"
          + (f" + {cfg.frontend_tokens} stub frames" if extras else "")
          + f", {NEW_FAMILY_NEW} new each, one wave): wall_s={wall:.3f} "
          f"tokens_per_s={n_tok / wall:.2f} prefill_ms={prefill_ms[0]:.3f} "
          f"decode_ms_median={statistics.median(decode_ms):.3f} "
          f"decode_steps={len(decode_ms)} peak_mem_gib={peak:.2f} "
          f"flash_attention_forward_launches={launches}; greedy tokens "
          f"kernel vs plain equal {share:.4f}, first difference per "
          f"request {first}")
    if launches != cfg.n_layers:
        fail(f"{label} serve: attention forward launches {launches} != "
             f"{cfg.n_layers} layers x 1 prefill")
    if not ((toks >= 0) & (toks < cfg.padded_vocab)).all():
        fail(f"{label} serve: a token outside the (padded) vocab")
    if share != 1.0:
        fail(f"{label} serve: greedy tokens differ between impl kernel and "
             f"plain (first difference per request {first})")
    return launches


def new_family_phase(torch, np, *, label, arch, n_layers, seq, bf16, rounds,
                     seed):
    """Train ``arch`` at published widths cut to ``n_layers`` (decoder and
    encoder) with NEW_FAMILY_PLAN per leaf at P = 4 as (1, 2, 2), one
    sequence a learner, ``rounds`` rounds from seed 0 with exact
    launch counts; one round kernel vs plain with a shifted-label control;
    a profiled round; the attention kernels at the training shape; then
    serving.  Returns (launches, attention times, serve launches)."""
    from repro_torch.configs.base import HierAvgParams
    from repro_torch.core.hier_avg import make_hier_round
    from repro_torch.data.loader import HierDataLoader
    from repro_torch.optim import sgd

    counters = lm_counters()
    hier = HierAvgParams(plan=NEW_FAMILY_PLAN, bucket_bytes=0)
    opts = dict(param_dtype=torch.bfloat16, remat=True) if bf16 else {}
    cfg, bundle, sample, floor = lm_setup(torch, arch, n_layers, seq, **opts)
    loader = HierDataLoader(sample, topo=_topo(), hier=hier,
                            per_learner_batch=1, seed=0, device="cuda")
    eval_batch = sample(torch.Generator(device="cuda").manual_seed(1), 4)
    parts, t0 = {}, time.perf_counter()
    state, rb, launches = bf16_rounds(
        torch, label, bundle, hier, loader, eval_batch, counters, rounds,
        floor, eval_first=True)
    parts["train"] = time.perf_counter() - t0
    new_family_launches(label, launches, cfg, hier, bf16, rounds)
    ssm = None
    if cfg.family == "hybrid":
        ssm = ssm_head_ms(torch, state, cfg)
    # the copy the comparison's rounds start from: hymba's state (params
    # and EF ref/err, ~9.6 GB) fits on the card beside its ~49 GB peak,
    # seamless's (~20 GB beside ~61 GB) goes to the host
    cpu_state = comparison_copy(torch, state)
    del state
    rb2 = rb        # the last round's batch again: no new chains to draw

    def make_round(impl="auto"):
        _, b, _, _ = lm_setup(torch, arch, n_layers, seq, impl=impl, **opts)
        plan = hier.resolved_plan if impl == "auto" \
            else plain_plan(hier.resolved_plan)
        return make_hier_round(b.loss_fn, sgd(0.1), hier, plan=plan)

    # the control's round is the profiled one: the device time by class
    # (the hybrid's trace holds ~1.5 x 10^5 kernels, the scan's step loop,
    # so it records no host operators), the idle share against the kernel
    # round's wall
    t0 = time.perf_counter()
    round_ms = kernel_plain_control(
        torch, label, make_round, cpu_state, rb2, bf16,
        profile=dict(label=f"{label} (one round: the control's)",
                     classes=NEW_FAMILY_CLASSES, host_ops=bf16))
    del cpu_state
    parts["kernel_vs_plain_and_profile"] = time.perf_counter() - t0
    if ssm is not None:
        steps = hier.steps_per_round
        share = (steps * ssm[0] + ssm[1]) * cfg.n_layers / round_ms
        print(f"{label} SSM head (mamba_apply on the first layer's params, "
              f"4 learners x {seq} tokens, host wall across a synchronize): "
              f"step (vmap(grad)) {ssm[0]:.1f} ms, eval forward "
              f"{ssm[1]:.1f} ms; a round's {steps} steps and 1 eval over "
              f"{cfg.n_layers} layers: {share:.3f} of the kernel round's "
              f"{round_ms:.1f} ms")
    gc.collect()
    torch.cuda.empty_cache()
    dtype = torch.bfloat16 if bf16 else torch.float32
    t0 = time.perf_counter()
    attn = attn_at_shape(torch, label, 4, seq, cfg.n_heads, cfg.n_kv_heads,
                         cfg.resolved_head_dim, cfg.sliding_window, dtype,
                         seed)
    gc.collect()
    torch.cuda.empty_cache()
    parts["attention"] = time.perf_counter() - t0
    plen = HYMBA_SERVE_PLEN if cfg.family == "hybrid" \
        else SEAMLESS_SERVE_PLEN
    t0 = time.perf_counter()
    served = serve_new_family(torch, np, label.replace(" train", ""), cfg,
                              plen, seed)
    gc.collect()
    torch.cuda.empty_cache()
    parts["serve"] = time.perf_counter() - t0
    print(f"{label} seconds by part: " + " ".join(
        f"{k}={v:.1f}" for k, v in parts.items()))
    return launches, attn, served


def phase_hymba(torch, np):
    """Phase 22: hymba-1.5b at published widths, fp32, HYMBA_LAYERS of 32
    layers, HYMBA_SEQ tokens a learner (the 1024 window masks; the scan
    runs 8 chunks under remat)."""
    from repro_torch.configs import get_config
    cfg = get_config(HYMBA_ARCH)
    print(f"phase 22 train {HYMBA_ARCH}: depth {HYMBA_LAYERS} of "
          f"{cfg.n_layers}, widths as published (d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, "
          f"d_ff {cfg.d_ff}, SSM d_inner {cfg.d_model * cfg.ssm_expand} "
          f"state {cfg.ssm_state}, window {cfg.sliding_window}, vocab "
          f"{cfg.vocab_size}), fp32, 1 x {HYMBA_SEQ} tokens per learner per "
          f"step")
    return new_family_phase(torch, np, label="phase 22 train hymba-1.5b",
                            arch=HYMBA_ARCH, n_layers=HYMBA_LAYERS,
                            seq=HYMBA_SEQ, bf16=False, rounds=HYMBA_ROUNDS,
                            seed=220)


def phase_seamless(torch, np):
    """Phase 23: seamless-m4t-large-v2 at published widths, bf16 and
    remat, SEAMLESS_LAYERS encoder and decoder layers of 24 + 24,
    SEAMLESS_SEQ text tokens beside 1024 stub frames a learner."""
    from repro_torch.configs import get_config
    cfg = get_config(SEAMLESS_ARCH)
    print(f"phase 23 train {SEAMLESS_ARCH}: depth {SEAMLESS_LAYERS} + "
          f"{SEAMLESS_LAYERS} of {cfg.n_encoder_layers} + {cfg.n_layers}, "
          f"widths as published (d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, d_ff "
          f"{cfg.d_ff} {cfg.act}, vocab {cfg.vocab_size}), bf16 params, "
          f"remat, 1 x {SEAMLESS_SEQ} tokens + {cfg.frontend_tokens} stub "
          f"frames per learner per step")
    return new_family_phase(torch, np,
                            label="phase 23 train seamless-m4t-large-v2",
                            arch=SEAMLESS_ARCH, n_layers=SEAMLESS_LAYERS,
                            seq=SEAMLESS_SEQ, bf16=True,
                            rounds=SEAMLESS_ROUNDS, seed=230)


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
    seconds = {"build": round(build_s, 1)}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    kern = timed("3", phase_kernel, torch, kops, kref)
    cfg, _, params, engine, launches = timed("4", phase_serve, torch, np)
    timed("4b", phase_profile, torch, np, cfg, params, engine)
    timed("5", phase_logits, torch, np, cfg, params, engine)
    dense_launches_serve, dense_attn = timed(
        "4c", phase_dense_serve, torch, np, cfg, params, engine)
    timed("5b", phase_logits_mean, torch, np, cfg, params, engine)
    # the engine's timing wrappers close over its bound methods, a cycle
    # that keeps the 32 GB of weights alive until the collector runs
    del cfg, params, engine, _
    gc.collect()
    torch.cuda.empty_cache()

    topk = timed("6", phase_topk, torch)
    topk_launches, topk_calls, phase7_walls, phase7_fire = timed(
        "7", phase_train, torch)
    torch.cuda.empty_cache()
    pack, unpack, qr = timed("8", phase_codecs, torch)
    codec_launches, codec_fires = timed("9", phase_codec_train, torch)
    gc.collect()
    torch.cuda.empty_cache()
    wkv_fwd, wkv_bwd = timed("10", phase_wkv, torch)
    attn_fwd, attn_bwd = timed("11", phase_attention, torch)
    gc.collect()
    torch.cuda.empty_cache()
    rwkv_launches, dense_launches = timed("12-13", phase_lm, torch)
    gc.collect()
    torch.cuda.empty_cache()
    elastic = timed("14", phase_elastic, torch, phase7_walls)
    gc.collect()
    torch.cuda.empty_cache()
    moe_fire, expert_leaf, _ = timed("15", phase_moe, torch)
    gc.collect()
    torch.cuda.empty_cache()
    vlm, vlm_attn, _ = timed("16", phase_vlm, torch)
    gc.collect()
    torch.cuda.empty_cache()
    rwkv_serve, rwkv_serve_t = timed("17", phase_rwkv_serve, torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    timed("18", phase_mla_moe_serve, torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    dist = timed("19", phase_ranks, torch)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tune_dir:
        tuned, artifact = timed(
            "21", phase_autotune, torch, tune_dir,
            {"7": phase7_fire, "9A": codec_fires["A"],
             "9B": codec_fires["B"]})
        timed("20", phase_torchrun, torch, tune_dir, artifact)
    # the new families last, so that phases 19-21 run as they did before
    # them (phase 21's fit reads host-bound reductions)
    gc.collect()
    torch.cuda.empty_cache()
    hymba = timed("22", phase_hymba, torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    seamless = timed("23", phase_seamless, torch, np)
    print(f"phase seconds: {json.dumps(seconds)}")
    # phase 16's bf16 launches and times at qwen2-vl's shape and the
    # serving phases' (4c, 17) at their prefill shapes beside the attention
    # and WKV kernels; phase 15's expert-leaf fire and phase 16's launches
    # beside top-k
    serve_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    later = {
        "flash_attention_forward": {
            "bf16_launches": vlm["flash_attention_forward"],
            **{f"bf16_{k}": vlm_attn[k] for k in serve_keys},
            "serve_launches": dense_launches_serve["flash_attention_forward"],
            **{f"serve_{k}": dense_attn[k] for k in serve_keys}},
        "rwkv6_wkv_forward": {
            "serve_launches": rwkv_serve["rwkv6_wkv_forward"],
            **{f"serve_{k}": rwkv_serve_t[k] for k in serve_keys
               + ("bound_ms_with_checkpoints",)}},
        "flash_attention_backward": {
            "bf16_launches": vlm["flash_attention_backward"],
            **{f"bf16_{k}": vlm_attn[f"bwd_{k}"] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        "topk_compress": {
            "bf16_launches": vlm["topk_compress"],
            "bf16_grouped_calls": vlm["topk_compress_calls"],
            "expert_fire_launches": moe_fire["topk_compress"],
            **{f"expert_leaf_{k}": v for k, v in expert_leaf.items()}}}

    # phases 22 and 23: the attention kernels' launches, the serving
    # prefills' and their times at hymba's and seamless's training shapes,
    # and top-k's launches and calls
    for tag, (lk, t, served) in (("hymba", hymba), ("seamless", seamless)):
        fwd = later["flash_attention_forward"]
        fwd[f"{tag}_launches"] = lk["flash_attention_forward"]
        fwd[f"{tag}_serve_launches"] = served
        fwd.update({f"{tag}_{k}": t[k] for k in serve_keys})
        bwd = later["flash_attention_backward"]
        bwd[f"{tag}_launches"] = lk["flash_attention_backward"]
        bwd.update({f"{tag}_{k}": t[f"bwd_{k}"] for k in serve_keys})
        later["topk_compress"].update({
            f"{tag}_launches": lk["topk_compress"],
            f"{tag}_grouped_calls": lk["topk_compress_calls"]})

    def entry(name, source, replaces, launches, numbers):
        # phase 14's launches beside each kernel its path runs, and
        # phases 4c, 15-17's, 19's and 21's (the probe)
        extra = ({"elastic_launches": elastic[name]} if name in elastic
                 else {})
        if name in dist:
            extra["ranks_launches"] = dist[name]
        if name in tuned:
            extra["autotune_launches"] = tuned[name]
        extra.update(later.get(name, {}))
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": replaces, "launches": launches, **numbers,
                **extra}

    record = {"kernels": [
        entry("flash_decode", "flash_decode.cu",
              "src/repro/kernels/flash_decode.py:100", launches, kern),
        entry("topk_compress", "topk_compress.cu",
              "src/repro/kernels/topk_compress.py:175", topk_launches,
              {**topk, "grouped_calls": topk_calls}),
        entry("qint8_pack", "qint8_pack.cu",
              "src/repro/kernels/qint8_pack.py:66",
              codec_launches["qint8_pack"], pack),
        entry("qint8_unpack", "qint8_pack.cu",
              "src/repro/kernels/qint8_pack.py:89",
              codec_launches["qint8_unpack"], unpack),
        entry("batched_qr", "batched_qr.cu",
              "src/repro/kernels/batched_qr.py:78",
              codec_launches["batched_qr"],
              {**qr, "grouped_calls": codec_launches["batched_qr_calls"]}),
        entry("rwkv6_wkv_forward", "rwkv6_wkv.cu",
              "src/repro/kernels/rwkv6_wkv.py:69",
              rwkv_launches["rwkv6_wkv_forward"], wkv_fwd),
        entry("rwkv6_wkv_backward", "rwkv6_wkv.cu",
              "src/repro/kernels/rwkv6_wkv.py:69",
              rwkv_launches["rwkv6_wkv_backward"], wkv_bwd),
        entry("flash_attention_forward", "flash_attention.cu",
              "src/repro/kernels/flash_attention.py:99",
              dense_launches["flash_attention_forward"], attn_fwd),
        entry("flash_attention_backward", "flash_attention.cu",
              "src/repro/kernels/flash_attention.py:99",
              dense_launches["flash_attention_backward"], attn_bwd)]}
    print(smi_line())
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


# --------------------------------------------------------------------- #
# phases 19-20: the multi-GPU hierarchy on one card

HIER_AXES = ("pod", "group", "local", "fsdp", "model")
DIST_MESH = (1, 2, 1, 2, 1)
DIST_TOPO = (1, 2, 2)
DIST_PLANS = ("local@2/global@4:topk:0.01", "local@2/global@4:qint8")
DIST_BATCH = 32
# the gathered state after one round against the same round in one
# process on the card: tests/test_torch_hier.py's round limits per element
# (params, EF ref), the EF residual (what top-k did not send) bit for bit.
# A rank runs its 2 learners' convolutions as cuDNN grouped convolutions
# of 2 groups, and one process that vmaps all 4 learners runs groups of 4,
# which may round otherwise; so the one process runs each rank's 2
# learners as a group of 2, as the rank does, then the global fire over
# the whole grid: the two then differ only in the global mean's summation
# order (in-rank tree and the gloo sum, against one tree over the 4
# learners).  The phase prints, as the witness of that choice, the same
# comparison between the vmapped round of 4 and the grouped one, in one
# process and with no collective, and the gathered round against the
# vmapped one
DIST_RTOL, DIST_ATOL = 1e-5, 1e-6


def dist_rank(rank, world, out_dir):
    """Phase 19 on one rank (a spawned process): writes
    ``out_dir/rank<r>.json``."""
    import numpy as np
    import torch

    from repro_torch.checkpoint.checkpoint import gather_blocks
    from repro_torch.configs.base import HierAvgParams
    from repro_torch.core.hier_avg import (init_state, make_hier_round,
                                           state_rows)
    from repro_torch.core.plan import ReductionPlan, resolve_plan
    from repro_torch.core.topology import HierTopology
    from repro_torch.data.loader import HierDataLoader
    from repro_torch.kernels.qint8_pack import qint8_pack as qp
    from repro_torch.kernels.qint8_pack import qint8_unpack as qu
    from repro_torch.kernels.topk_compress import topk_compress as tk
    from repro_torch.optim import sgd
    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import (RankMesh, make_constraint_fn,
                                               shard_plan)
    from repro_torch.telemetry import gradstats
    from repro_torch.tree import leaves

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    refused = list(collectives.probe_gloo_cuda(dev))
    mesh = RankMesh(DIST_MESH, HIER_AXES, rank=rank)
    topo = HierTopology(*DIST_TOPO)
    block = mesh.block_topology(topo)
    sp = shard_plan(mesh)
    cf = make_constraint_fn(mesh)
    loss_fn, init_fn, sample, _ = resnet_task(torch)
    counters = {"topk_compress": tk, "qint8_pack": qp, "qint8_unpack": qu}
    opt = sgd(0.1)
    rec = {"refused": refused, "plans": {}}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b))
                   if isinstance(x, torch.Tensor))

    for spec in DIST_PLANS:
        hier = HierAvgParams(plan=spec)
        plan = resolve_plan(hier, None, None, shards=sp)
        state0 = init_state(block, init_fn, opt,
                            torch.Generator(device="cuda").manual_seed(0),
                            plan=plan, shards=sp, device="cuda")
        loader = HierDataLoader(sample, topo=topo, hier=hier,
                                per_learner_batch=DIST_BATCH, seed=5,
                                mesh=mesh, device="cuda")
        b0 = loader.next_round()
        rnd = make_hier_round(loss_fn, opt, hier, mesh=mesh,
                              constraint_fn=cf, shards=sp)
        # the main path: one round, counts from 0, every rank starting
        # together
        torch.cuda.synchronize()
        collectives.barrier()
        zero_counts(counters)
        collectives.reset_counts()
        t0 = time.perf_counter()
        state1, m = rnd(state0, b0)
        torch.cuda.synchronize()
        r = {"first_round_ms": (time.perf_counter() - t0) * 1e3,
             "launches": read_counts(counters),
             "collectives": collectives.counts(),
             "loss": float(collectives.world_mean(m["loss"].reshape(1)))}
        tel = None
        if spec == DIST_PLANS[0]:
            # telemetry across the ranks: the same round with it on, the
            # grid's statistics on every rank, the trajectory unchanged;
            # the control is the EF mass of this rank's block alone
            tel = make_hier_round(loss_fn, opt, hier, mesh=mesh,
                                  constraint_fn=cf, shards=sp,
                                  telemetry=True)
            st_t, mt = tel(state0, b0)
            r["tel_eq_off"] = same(st_t, state1)
            r["telemetry"] = {k: float(v) for k, v in mt.items()
                              if k.startswith("telemetry/")}
            r["ef_mass_block"] = float(gradstats.ef_mass(
                st_t.comm_state[plan.levels[-1].name]))
            del st_t
        # kernel against plain, and an all-true mask against dense, on the
        # rank's own block, bit for bit
        plain = make_hier_round(loss_fn, opt, hier, mesh=mesh,
                                constraint_fn=cf, shards=sp,
                                plan=plain_plan(ReductionPlan.parse(spec)))
        r["kernel_eq_plain"] = same(plain(state0, b0)[0], state1)
        elastic = make_hier_round(loss_fn, opt, hier, mesh=mesh,
                                  constraint_fn=cf, shards=sp, elastic=True)
        r["mask_eq_dense"] = same(elastic(
            state0, b0, np.ones((len(plan.levels),) + DIST_TOPO, bool))[0],
            state1)
        whole = gather_blocks(state1, mesh, topo, state_rows(state1, plan))
        if rank == 0:
            r["vs_one_process"] = one_process_round(
                torch, hier, whole, loss_fn, init_fn, sample, r["loss"])
            if tel is not None:
                r["tel_one_process"] = one_process_telemetry(
                    torch, hier, loss_fn, init_fn, sample)
        del whole
        # one round's wall, then one with each collective timed, every
        # rank starting together (rank 0 has just run the one-process
        # rounds alone)
        st = state1
        for timed_round in (False, True):
            b = loader.next_round()
            if not timed_round:
                st_before, b_before = st, b
            torch.cuda.synchronize()
            collectives.barrier()
            collectives.reset_counts()
            t0 = time.perf_counter()
            with (collectives.timed() if timed_round
                  else contextlib.nullcontext()):
                st, _ = rnd(st, b)
            torch.cuda.synchronize()
            key = "timed_round_ms" if timed_round else "round_ms"
            r[key] = (time.perf_counter() - t0) * 1e3
            if not timed_round:
                st_after = st
        r["collective_s"] = collectives.seconds()
        if tel is not None:
            # the untimed round again with telemetry on: its wall beside
            # round_ms, and the same state
            torch.cuda.synchronize()
            collectives.barrier()
            t0 = time.perf_counter()
            st_t, _ = tel(st_before, b_before)
            torch.cuda.synchronize()
            r["tel_round_ms"] = (time.perf_counter() - t0) * 1e3
            r["tel_eq_off_2"] = same(st_t, st_after)
            del st_t
        rec["plans"][spec] = r
        del st, state0, state1, st_before, st_after
        torch.cuda.empty_cache()
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    collectives.barrier()


def one_process_round(torch, hier, whole, loss_fn, init_fn, sample, loss):
    """The same round in one process on the card, the whole (1, 2, 2) grid
    on the same shard-aware layout (an unbound mesh): each rank's learners
    take the round's steps and local fires as a group of their own
    (``local@2`` twice), then the global level fires once over the whole
    grid, as ``make_hier_round`` fires it.  Returns, for the gathered
    round against that one (the check), the elements outside the limits,
    the EF residual's elements that differ, and the largest relative
    difference per leaf; and the same for two comparisons that explain
    the reference's design: the round that vmaps all 4 learners in one
    process (no collective) against the grouped one, and the gathered
    round against the vmapped one."""
    from repro_torch.comm import reduce_with
    from repro_torch.configs.base import HierAvgParams
    from repro_torch.core.hier_avg import init_state, make_hier_round
    from repro_torch.core.plan import resolve_plan
    from repro_torch.core.topology import HierTopology, average_over
    from repro_torch.data.loader import HierDataLoader
    from repro_torch.optim import sgd
    from repro_torch.parallel.sharding import RankMesh, shard_plan
    from repro_torch.tree import leaves, tree_map

    topo = HierTopology(*DIST_TOPO)
    usp = shard_plan(RankMesh(DIST_MESH, HIER_AXES))
    opt = sgd(0.1)
    plan = resolve_plan(hier, None, None, shards=usp)
    full = init_state(topo, init_fn, opt,
                      torch.Generator(device="cuda").manual_seed(0),
                      plan=plan, shards=usp, device="cuda")
    batch = HierDataLoader(sample, topo=topo, hier=hier,
                           per_learner_batch=DIST_BATCH, seed=5,
                           device="cuda").next_round()
    local = HierAvgParams(plan=plan.levels[0].describe())
    rnd = make_hier_round(loss_fn, opt, local)
    steps = hier.steps_per_round
    blocks, losses = [], []
    for g in range(DIST_TOPO[1]):
        st = init_state(HierTopology(1, 1, DIST_TOPO[2]), init_fn, opt,
                        torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
        flat = tree_map(lambda x: x.reshape(
            (steps,) + tuple(x.shape[2:]))[:, :, g:g + 1], batch)
        for t in range(0, steps, local.steps_per_round):
            st, m = rnd(st, tree_map(
                lambda x: x[t:t + local.steps_per_round], flat))
            losses.append(float(m["loss"]))
        blocks.append(st.params)
    params = tree_map(lambda *b: torch.cat(b, dim=1), *blocks)
    glob = plan.levels[-1]
    cs = full.comm_state[glob.name] if glob.reducer.stateful else ()
    params, cs = reduce_with(
        glob.reducer, lambda t, cf=None, sp=None: average_over(
            t, glob.axes, cf, sp), params, cs)
    vmapped, vm = make_hier_round(loss_fn, opt, hier, shards=usp)(full,
                                                                  batch)
    stateful = glob.reducer.stateful

    def drift(a_params, a_cs, b_params, b_cs):
        over, worst = 0, 0.0
        pairs = list(zip(leaves(a_params), leaves(b_params)))
        if stateful:
            pairs += list(zip(leaves(a_cs.ref), leaves(b_cs.ref)))
        for a, b in pairs:
            d = (a.float() - b.float()).abs()
            worst = max(worst, d.max().item()
                        / max(b.float().abs().max().item(), 1e-30))
            over += int((d > DIST_ATOL + DIST_RTOL * b.float().abs()).sum())
        err_diff = 0
        if stateful:
            err_diff = sum(int((a != b).sum()) for a, b in zip(
                leaves(a_cs.err), leaves(b_cs.err)))
        return {"elements_outside": over,
                "of_elements": sum(a.numel() for a, _ in pairs),
                "ef_residual_elements_differing": err_diff,
                "max_rel_per_leaf": worst}

    wcs = whole.comm_state[glob.name] if stateful else None
    vcs = vmapped.comm_state[glob.name] if stateful else None
    return {**drift(whole.params, wcs, params, cs),
            "loss_diff": abs(loss - sum(losses) / len(losses)),
            "witness_vmapped4_vs_grouped": drift(vmapped.params, vcs,
                                                 params, cs),
            "witness_vmapped4_loss_diff": abs(float(vm["loss"])
                                              - sum(losses) / len(losses)),
            "gathered_vs_vmapped4": drift(whole.params, wcs,
                                          vmapped.params, vcs)}


def one_process_telemetry(torch, hier, loss_fn, init_fn, sample):
    """Phase 19's round with telemetry on, in one process on the card:
    the whole (1, 2, 2) grid on the ranks' shard-aware layout (an unbound
    mesh), each rank's learners' gradients taken as a group of their own
    (the ranks' cuDNN group count), so that the round differs from the
    world's only in the global fire's summation order.  Returns the
    ``telemetry/*`` values."""
    from repro_torch.core import hier_avg
    from repro_torch.core.plan import resolve_plan
    from repro_torch.core.topology import HierTopology
    from repro_torch.data.loader import HierDataLoader
    from repro_torch.optim import sgd
    from repro_torch.parallel.sharding import RankMesh, shard_plan
    from repro_torch.tree import tree_map

    topo = HierTopology(*DIST_TOPO)
    usp = shard_plan(RankMesh(DIST_MESH, HIER_AXES))
    opt = sgd(0.1)
    plan = resolve_plan(hier, None, None, shards=usp)
    full = hier_avg.init_state(topo, init_fn, opt,
                               torch.Generator(device="cuda").manual_seed(0),
                               plan=plan, shards=usp, device="cuda")
    batch = HierDataLoader(sample, topo=topo, hier=hier,
                           per_learner_batch=DIST_BATCH, seed=5,
                           device="cuda").next_round()
    whole_grad_fn = hier_avg.stacked_grad_fn

    def grouped(fn):
        inner = whole_grad_fn(fn)

        def grad_fn(params, b):
            parts = [inner(tree_map(lambda x: x[:, g:g + 1], params),
                           tree_map(lambda x: x[:, g:g + 1], b))
                     for g in range(DIST_TOPO[1])]
            return tuple(tree_map(lambda *xs: torch.cat(xs, dim=1),
                                  *[p[i] for p in parts]) for i in (0, 1))

        return grad_fn

    hier_avg.stacked_grad_fn = grouped
    try:
        rnd = hier_avg.make_hier_round(loss_fn, opt, hier, shards=usp,
                                       telemetry=True)
    finally:
        hier_avg.stacked_grad_fn = whole_grad_fn
    _, m = rnd(full, batch)
    return {k: float(v) for k, v in m.items() if k.startswith("telemetry/")}


def phase_ranks(torch):
    """Phase 19: a gloo world of 4 processes on the card (see the module
    docstring); returns each kernel's launches summed over the ranks and
    plans."""
    from repro_torch.testing import spawn_world
    world = math.prod(DIST_MESH)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        spawn_world(dist_rank, world, d, timeout=600)
        recs = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                recs.append(json.load(f))
    wall = time.perf_counter() - t0
    refused = recs[0]["refused"]
    print(f"phase 19 ranks: {world} processes on {smi_line()}, gloo on CUDA "
          f"tensors; collectives gloo refuses on the card: "
          f"{', '.join(refused) or 'none'}; mesh {DIST_MESH} "
          f"over {DIST_TOPO}, ResNet-18 width 64, {DIST_BATCH} per learner "
          f"per step; world wall {wall:.1f}s; peak GiB per process "
          + " ".join(f"{r['peak_gib']:.3f}" for r in recs))
    if refused:
        fail(f"phase 19: gloo refuses {refused} on CUDA tensors")
    out = {}
    for spec in DIST_PLANS:
        rs = [r["plans"][spec] for r in recs]
        one = rs[0]["vs_one_process"]
        launches = {k: sum(r["launches"][k] for r in rs)
                    for k in rs[0]["launches"] if not k.endswith("_calls")}
        secs = {k: [round(r["collective_s"][k] * 1e3, 3) for r in rs]
                for k in rs[0]["collective_s"]}
        witness = {k: one.pop(k) for k in ("witness_vmapped4_vs_grouped",
                                           "witness_vmapped4_loss_diff",
                                           "gathered_vs_vmapped4")}
        print(f"phase 19 {spec}: loss {rs[0]['loss']:.6f}; launches per "
              f"rank {[r['launches'] for r in rs]}; collectives per rank "
              f"{[r['collectives'] for r in rs]}; round wall ms, the "
              f"world's (the largest over the ranks, each round started "
              f"by a barrier) first "
              f"{max(r['first_round_ms'] for r in rs):.1f}, then "
              f"{max(r['round_ms'] for r in rs):.1f}, with collectives "
              f"timed {max(r['timed_round_ms'] for r in rs):.1f}; per rank "
              f"first {fmt([r['first_round_ms'] for r in rs])}, then "
              f"{fmt([r['round_ms'] for r in rs])}, timed "
              f"{fmt([r['timed_round_ms'] for r in rs])}; collective ms by "
              f"kind (per rank) {secs}; kernel == plain "
              f"{[r['kernel_eq_plain'] for r in rs]}; all-true mask == "
              f"dense {[r['mask_eq_dense'] for r in rs]}; gathered vs one "
              f"process (ranks' grouping): {one}; witness, one process, "
              f"no collective: {witness}")
        if not all(r["kernel_eq_plain"] for r in rs):
            fail(f"phase 19 {spec}: kernel and plain rounds differ on a rank")
        if not all(r["mask_eq_dense"] for r in rs):
            fail(f"phase 19 {spec}: an all-true mask differs from dense")
        if one["elements_outside"] or one["ef_residual_elements_differing"]:
            fail(f"phase 19 {spec}: the gathered round is outside the "
                 f"limits of the one-process round: {one}")
        want = ("topk_compress",) if "topk" in spec else ("qint8_pack",
                                                          "qint8_unpack")
        for k in want:
            if not launches[k]:
                fail(f"phase 19 {spec}: {k} was not launched on the ranks")
            out[k] = out.get(k, 0) + launches[k]
        if any(r["collectives"]["reduce_scatter"] == 0 for r in rs):
            fail(f"phase 19 {spec}: a rank ran no reduce-scatter")
        if "telemetry" in rs[0]:
            check_rank_telemetry(spec, rs)
    return out


def check_rank_telemetry(spec, rs):
    """Phase 19's telemetry: the same values on every rank, the
    trajectory unchanged, each statistic within TEL_CARD_RTOL of the
    one-process round, the block-only control outside it."""
    world = rs[0]["telemetry"]
    one = rs[0]["tel_one_process"]
    rel = {k: abs(world[k] - one[k]) / max(abs(one[k]), 1e-30)
           for k in one}
    ef = [k for k in world if k.startswith("telemetry/ef_mass/")]
    ctl = {k: abs(r["ef_mass_block"] - world[k]) / world[k]
           for r in rs for k in ef}
    print(f"phase 19 {spec} telemetry on the ranks: {world}; relative "
          f"difference from the one-process round (limit "
          f"{TEL_CARD_RTOL:g}): max {max(rel.values()):.3e} "
          f"{ {k.split('telemetry/')[1]: f'{v:.2e}' for k, v in rel.items()} }"
          f"; control (a rank's block-only EF mass) "
          f"{min(ctl.values()):.3e} to {max(ctl.values()):.3e} off; round "
          f"wall ms, the world's, telemetry off "
          f"{max(r['round_ms'] for r in rs):.1f} / on "
          f"{max(r['tel_round_ms'] for r in rs):.1f} (per rank off "
          f"{fmt([r['round_ms'] for r in rs])}, on "
          f"{fmt([r['tel_round_ms'] for r in rs])}); trajectory on == off "
          f"{[r['tel_eq_off'] and r['tel_eq_off_2'] for r in rs]}")
    if any(r["telemetry"] != world for r in rs):
        fail(f"phase 19 {spec}: the ranks read different telemetry: "
             f"{[r['telemetry'] for r in rs]}")
    if not all(r["tel_eq_off"] and r["tel_eq_off_2"] for r in rs):
        fail(f"phase 19 {spec}: telemetry changed the trajectory on a rank")
    if sorted(world) != sorted(one) or max(rel.values()) > TEL_CARD_RTOL:
        fail(f"phase 19 {spec}: telemetry on the ranks against the "
             f"one-process round: {rel}")
    if min(ctl.values()) <= TEL_CARD_RTOL:
        fail(f"phase 19 {spec}: the block-only EF mass control is within "
             f"the limit: {ctl}")


# --------------------------------------------------------------------- #
# phase 21: the autotune loop on the card

# a payload ladder past the reference grid's 64x64-160x160 leaves (which
# the card reads as launch-bound), up to phase 7's fire: 16 learners of
# 8 leaves of 1024 x 1364 fp32 (11,173,888 elements a learner, ResNet-18's
# 11,172,160), and the three codecs with kernels at that size
AUTOTUNE_LADDER = (
    ("global", (1, 2, 4), "mean", 8, (256, 256)),
    ("global", (1, 4, 4), "mean", 8, (512, 512)),
    ("global", (1, 4, 4), "mean", 8, (1024, 1024)),
    ("global", (1, 4, 4), "mean", 8, (1024, 1364)),
    ("local", (1, 4, 4), "mean", 8, (1024, 1364)),
    ("global", (1, 4, 4), "topk:0.05", 8, (1024, 1364)),
    ("global", (1, 4, 4), "qint8:128", 8, (1024, 1364)),
    ("global", (1, 4, 4), "powersgd:2", 8, (1024, 1364)),
)
AUTOTUNE_REPS = 12
# the ladder's fire-size codec points: 2.3-9.5 ms each, device-bound (the
# grid's host-bound points read 0.4-1.5 ms whatever their size).  Each
# codec's rate is fitted to its points, the fire-size one 55 times the
# bytes of the grid's; what is left at this size is the shared terms'
# misfit and the min-of-12 spread (under 1%), so the fit must predict
# each within 5%.  A 2x error in a codec's rate reads 40-80% off.
AUTOTUNE_FIRE_POINTS = AUTOTUNE_LADDER[-3:]
AUTOTUNE_FIRE_RTOL = 0.05
AUTOTUNE_CLI = ["--arch", "rwkv6-1.6b", "--rounds", "2", "--learners", "4",
                "--s", "2", "--batch", "2", "--seq", "64"]


def autotune_cli(torch, argv, rows):
    """``launch.train.main(argv)`` in this process under deterministic
    algorithms (an operation without a deterministic version warns, and
    its warnings are returned), its train_round rows to ``rows``:
    (stdout, losses, warnings)."""
    import io
    import warnings

    from repro_torch.launch import train as ttrain
    buf = io.StringIO()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with contextlib.redirect_stdout(buf), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ttrain.main(argv + ["--metrics-out", rows])
    finally:
        torch.use_deterministic_algorithms(False)
    with open(rows) as f:
        losses = [json.loads(ln)["loss"] for ln in f]
    odd = sorted({str(w.message)[:120] for w in caught
                  if "determinis" in str(w.message)})
    return buf.getvalue(), losses, odd


def phase_autotune(torch, out_dir, fire_walls):
    """Phase 21 (see the module docstring).  ``fire_walls``: the global
    fire walls (ms) phases 7, 9A and 9B measured.  Returns (each kernel's
    launches in the probe, the calibration artifact's path)."""
    from repro_torch.autotune import (ProbePoint, default_grid,
                                      fit_comm_model, predict_seconds,
                                      run_probe)
    from repro_torch.configs.base import HierAvgParams
    from repro_torch.core.plan import resolve_plan
    from repro_torch.core.simulator import init_template
    from repro_torch.core.theory import CommModel, level_reduction_seconds
    from repro_torch.core.topology import HierTopology
    from repro_torch.kernels.batched_qr import batched_qr as bq
    from repro_torch.kernels.qint8_pack import qint8_pack as qp
    from repro_torch.kernels.qint8_pack import qint8_unpack as qu
    from repro_torch.kernels.topk_compress import topk_compress as tk

    counters = {"topk_compress": tk, "qint8_pack": qp, "qint8_unpack": qu,
                "batched_qr": bq}
    points = default_grid() + [ProbePoint(*pt) for pt in AUTOTUNE_LADDER]
    probe_json = os.path.join(out_dir, "probe.json")
    torch.cuda.synchronize()
    zero_counts(counters)
    t0 = time.perf_counter()
    samples = run_probe(points, reps=AUTOTUNE_REPS, out=probe_json)
    probe_s = time.perf_counter() - t0
    launches = read_counts(counters)
    for s in samples:
        print(f"phase 21 probe {s['level']}@{s['tier']} {s['spec']} "
              f"{tuple(s['topo'])} {s['n_leaves']}x{s['leaf_shape'][0]}x"
              f"{s['leaf_shape'][1]} cap {s['cap']}: dense "
              f"{s['dense_bytes']} B, payload {s['payload_bytes']} B, "
              f"{s['messages']} messages, min {s['min_us']} us, median "
              f"{s['warm_us']} us, first {s['compile_s']} s")
    for k in ("topk_compress", "qint8_pack", "qint8_unpack", "batched_qr"):
        if not launches[k]:
            fail(f"phase 21: the probe did not launch {k}: {launches}")
    # one card: a "dci" sample crossed no slower link than an "ici" one,
    # so the fit reads the ici samples and leaves slow_bw unfitted
    ici = [s for s in samples if s["tier"] == "ici"]
    cal = fit_comm_model(ici, source=probe_json)
    artifact = os.path.join(out_dir, "calibration.json")
    cal.save(artifact)
    dci_rel = sorted(abs(predict_seconds(cal.model, s) - s["min_us"] * 1e-6)
                     / (s["min_us"] * 1e-6)
                     for s in samples if s["tier"] == "dci")
    m = cal.model
    def rel(model, s):
        t = s["min_us"] * 1e-6
        return abs(predict_seconds(model, s) - t) / t

    def sq_err(model):
        return sum((predict_seconds(model, s) - s["min_us"] * 1e-6) ** 2
                   for s in ici)

    placeholder = statistics.median(rel(CommModel(), s) for s in ici)
    rss, rss_placeholder = sq_err(m), sq_err(CommModel())
    fire = [s for s in ici if (s["level"], tuple(s["topo"]), s["spec"],
                               s["n_leaves"], tuple(s["leaf_shape"]))
            in AUTOTUNE_FIRE_POINTS]
    halved = dataclasses.replace(m, codec_bw=tuple(
        (c, bw / 2) for c, bw in m.codec_bw or ()))
    fire_rel = {name: max(rel(model, s) for s in fire) for name, model in (
        ("fit", m), ("placeholders", CommModel()),
        ("codec rates halved", halved),
        ("fast_bw halved", dataclasses.replace(m, fast_bw=m.fast_bw / 2)))}
    print(f"phase 21 fit ({len(ici)} ici samples of {len(samples)}, probe "
          f"{probe_s:.1f}s, launches {launches}): fitted {list(cal.fitted)}; "
          f"fast_bw {m.fast_bw:.6e} B/s, latency {m.latency:.6e} s, "
          f"compress_bw {m.compress_bw:.6e} B/s, codec_bw {m.codec_bw}, "
          f"slow_bw {m.slow_bw:.6e} (fitted: {'slow_bw' in cal.fitted}); "
          f"median relative error {cal.median_rel_err:.4f} (the reference's "
          f"CPU tolerance 0.75: "
          f"{'within' if cal.median_rel_err <= 0.75 else 'outside'}; the "
          f"uncalibrated placeholder rates {placeholder:.4f}), max "
          f"{cal.max_rel_err:.4f}; squared error {rss:.6e} s^2 against the "
          f"placeholders' {rss_placeholder:.6e}; per sample "
          f"{[round(rel(m, s), 3) for s in ici]}; the dci samples under it "
          f"(not fitted): median {dci_rel[len(dci_rel) // 2]:.4f}; largest "
          f"relative error on the {len(fire)} fire-size codec points (limit "
          f"{AUTOTUNE_FIRE_RTOL}): "
          f"{ {k: round(v, 4) for k, v in fire_rel.items()} }")
    if "slow_bw" in cal.fitted:
        fail("phase 21: the fit read a slow tier from one card")
    if len(fire) != len(AUTOTUNE_FIRE_POINTS) \
            or fire_rel["fit"] > AUTOTUNE_FIRE_RTOL:
        fail(f"phase 21: the fit misses the fire-size codec points: "
             f"{fire_rel}")
    for ctl in ("placeholders", "codec rates halved"):
        if fire_rel[ctl] <= AUTOTUNE_FIRE_RTOL:
            fail(f"phase 21: the control ({ctl}) is within the limit: "
                 f"{fire_rel}")

    # the calibrated bill of the global fires phases 7 and 9 measured
    loss_fn, init_fn, _, _ = resnet_task(torch)
    template = init_template(init_fn, "cuda")
    topo = HierTopology(1, 4, 4)
    bills = []
    for tag, hier in (("7", HierAvgParams(plan=TRAIN_PLAN, bucket_bytes=0)),
                      ("9A", HierAvgParams(plan=CODEC_PLANS[0])),
                      ("9B", HierAvgParams(plan=CODEC_PLANS[1]))):
        lvl = resolve_plan(hier, None, None).levels[-1]
        cal_ms = level_reduction_seconds(lvl, topo, template, m)[2] * 1e3
        ref_ms = level_reduction_seconds(lvl, topo, template,
                                         CommModel())[2] * 1e3
        wall = fire_walls[tag]
        bills.append(f"{tag} {lvl.describe()}: measured {wall:.3f} ms, "
                     f"calibrated bill {cal_ms:.3f} ms (measured/billed "
                     f"{wall / cal_ms:.3f}), uncalibrated bill {ref_ms:.3f}"
                     f" ms")
    print("phase 21 bill of the global fires (P = 16 as (1, 4, 4), "
          "ResNet-18's parameters): " + "; ".join(bills))

    # --autotune against --plan ranked[0], in this process
    out, auto, odd = autotune_cli(
        torch, AUTOTUNE_CLI + ["--autotune", artifact],
        os.path.join(out_dir, "auto.jsonl"))
    ranked = [ln.strip() for ln in out.splitlines() if ln.startswith("  #")]
    ctl = [ln for ln in out.splitlines() if ln.startswith("controller:")]
    if len(ranked) != 3 or not ctl:
        fail(f"phase 21: --autotune printed no ranking or no controller "
             f"line:\n{out}")
    top = ranked[0].split()[1]
    _, plain, odd2 = autotune_cli(torch, AUTOTUNE_CLI + ["--plan", top],
                                  os.path.join(out_dir, "plan.jsonl"))
    print(f"phase 21 --autotune (reduced rwkv6-1.6b, 2 rounds): ranked "
          f"{ranked}; {ctl[0]}; losses {auto} against --plan {top} {plain}"
          f"; operations without a deterministic version: "
          f"{sorted(set(odd + odd2)) or 'none'}")
    if len(auto) != 2 or auto != plain:
        fail(f"phase 21: --autotune's losses {auto} differ from --plan "
             f"{top}'s {plain}")
    return launches, artifact


TORCHRUN_PLAN = "local@2/global@4:topk:0.05"


def torchrun_train(label, extra):
    """launch.train under torchrun, one process, NCCL, reduced rwkv6-1.6b
    for 2 rounds, with ``extra`` arguments: (lines, seconds).  Fails
    unless the run exits 0 with 2 finite rounds and the metrics'
    all-reduce on NCCL."""
    from repro_torch.testing import _free_port
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc_per_node", "1", "--master_addr", "127.0.0.1",
           "--master_port", str(_free_port()), "-m",
           "repro_torch.launch.train", "--arch", "rwkv6-1.6b", "--rounds",
           "2", "--learners", "4", "--batch", "2", "--seq", "64",
           "--backend", "nccl"] + extra
    # S keeps its default (2): torchrun's own parser reads "--s" as an
    # abbreviation of its options
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    rounds = [ln for ln in lines if ln.startswith("round ")]
    coll = [ln for ln in lines if ln.startswith("collectives: ")]
    print(f"phase 20 torchrun --nproc_per_node 1 --backend nccl {label} "
          f"(reduced rwkv6-1.6b, 2 rounds): exit {proc.returncode} in "
          f"{wall:.1f}s; "
          + " | ".join(ln for ln in lines if ln.startswith(
              ("Hier-AVG", "autotune", "  #", "controller")))
          + " | " + " | ".join(rounds + coll))
    if proc.returncode != 0:
        fail(f"phase 20 {label}: launch.train under torchrun failed:\n"
             f"{proc.stderr[-3000:]}")
    if not any("backend=nccl" in ln for ln in lines) or len(rounds) != 2:
        fail(f"phase 20 {label}: no NCCL run of 2 rounds in {lines}")
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in rounds]
    if not all(math.isfinite(v) for v in losses):
        fail(f"phase 20 {label}: losses {losses}")
    if not coll or json.loads(coll[0][len("collectives: "):])[
            "all_reduce"] < 2:
        fail(f"phase 20 {label}: the metrics' all-reduce did not run on "
             f"NCCL: {coll}")
    return lines


def phase_torchrun(torch, out_dir, artifact):
    """Phase 20: launch.train under torchrun, one process, NCCL: the top-k
    plan with telemetry, then telemetry and the plan phase 21's
    calibration ranks first."""
    rows_path = os.path.join(out_dir, "torchrun_topk.jsonl")
    torchrun_train(f"--plan {TORCHRUN_PLAN} --telemetry",
                   ["--plan", TORCHRUN_PLAN, "--telemetry",
                    "--metrics-out", rows_path])
    with open(rows_path) as f:
        rows = [json.loads(ln) for ln in f]
    ef = [r.get("telemetry/ef_mass/global") for r in rows]
    print(f"phase 20 --plan {TORCHRUN_PLAN} --telemetry rows: "
          + " | ".join(json.dumps({k: v for k, v in r.items()
                                   if k.startswith("telemetry/")})
                       for r in rows))
    if len(rows) != 2 or not all(
            v is not None and math.isfinite(v) and v > 0 for v in ef):
        fail(f"phase 20: the top-k run's rows carry no positive EF mass of "
             f"the global level: {ef}")
    lines = torchrun_train("--telemetry --autotune",
                           ["--telemetry", "--autotune", artifact])
    if not any(ln.startswith("controller:") for ln in lines):
        fail(f"phase 20: --autotune printed no controller line: {lines}")


if __name__ == "__main__":
    main()
