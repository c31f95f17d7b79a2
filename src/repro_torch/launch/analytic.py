"""Analytic roofline model (PyTorch port of ``repro/launch/analytic.py``).

Sizes a training step, a prefill or a decode step per device from the
configuration alone: compute (FLOPs over the peak rate), memory (bytes
over the HBM rate) and the collectives, itemized so the largest can be
attacked:

  tp_act     — Megatron-style activation all-reduces over the TP axis
  fsdp       — ZeRO-3 param all-gather + grad reduce-scatter over fsdp
  local_avg  — the paper's local reduction (per K1 steps, over S)
  global_avg — the paper's global reduction (per K2 steps, over P;
               crosses the slow tier in the multi-pod mesh)

All terms are per-device, per-SGD-step (train) or per-decode-step/prefill,
in seconds.  The layout is the reference's target spec (a 256-device pod,
or 2 pods; ``launch/mesh.py`` keeps it), with the per-device constants of
an NVIDIA H100 below in place of the reference's TPU ones.  A
calibration artifact (autotune/calibrate.py; ``comm_model=`` or
``$REPRO_CALIBRATION``) replaces the link/codec constants with MEASURED
ones for the reduction terms, and only those it fitted: its unfitted
fields are ``CommModel`` defaults, not measurements.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.base import (ArchConfig, HierAvgParams,
                                      InputShape, INPUT_SHAPES)

# Per-device constants of one NVIDIA H100 SXM5 80GB at its full 700 W
# power limit (a card set below it runs slower under load), from NVIDIA's
# H100 Tensor Core GPU datasheet unless noted:
# dense bf16 tensor-core rate, without sparsity (989 TFLOP/s)
PEAK_FLOPS = 989e12
# HBM3 bandwidth (3.35 TB/s)
HBM_BW = 3.35e12
# the fast tier: NVLink 4, 18 links per GPU, 900 GB/s both directions
# together, so 450 GB/s each way (what a ring's step sends)
LINK_BW = 450e9
# the slow tier: the node's InfiniBand, one ConnectX-7 NDR port of
# 400 Gb/s per GPU (DGX H100 system datasheet), 50 GB/s
DCI_BW = 50e9

BF16 = 2


def _ring(n: int) -> float:
    return 2.0 * (n - 1) / n if n > 1 else 0.0


def _attn_flops_per_token_layer(cfg: ArchConfig, ctx: float) -> float:
    """fwd QK^T + PV flops per token per layer (2 flops/MAC)."""
    if cfg.family == "ssm":
        hd = cfg.resolved_head_dim
        return 4.0 * cfg.ssm_heads * hd * hd          # wkv state update+read
    hq = cfg.n_heads
    hd = cfg.v_head_dim if cfg.kv_lora_rank else cfg.resolved_head_dim
    f = 4.0 * hq * hd * ctx
    if cfg.family == "hybrid":
        di = cfg.d_model * cfg.ssm_expand
        f += 4.0 * di * cfg.ssm_state                 # selective scan
    return f


def _ctx(cfg: ArchConfig, shape: InputShape, rolling: bool) -> float:
    if shape.kind == "train":
        s = shape.seq_len
        w = cfg.sliding_window
        return (w if (w and w < s) else s / 2.0)      # causal avg
    # decode/prefill context length actually attended
    if shape.kind == "decode":
        t = shape.seq_len
        if rolling:
            t = min(t, cfg.long_context_window)
        if cfg.sliding_window:
            t = min(t, cfg.sliding_window)
        if cfg.family == "ssm":
            t = 1
        return float(t)
    s = shape.seq_len
    w = cfg.sliding_window
    return (w if (w and w < s) else s / 2.0)


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    collective_parts: Dict[str, float]
    bottleneck: str
    model_flops_per_device: float
    details: Dict[str, float]

    def as_dict(self):
        d = dataclasses.asdict(self)
        return d


def analytic_roofline(cfg: ArchConfig, shape_name: str, *,
                      multi_pod: bool = False,
                      hier: Optional[HierAvgParams] = None,
                      sliding_rolling: Optional[bool] = None,
                      comm_model=None) -> Roofline:
    shape = INPUT_SHAPES[shape_name]
    hier = hier or HierAvgParams(k1=4, k2=8)
    # measured link/codec constants for the reduction terms.  An
    # explicit CommModel wins wholesale; a Calibration — passed in or
    # configured via $REPRO_CALIBRATION — only displaces the constants
    # it actually FITTED: its unfitted fields are CommModel base
    # defaults, which differ from this module's H100 numbers and carry
    # no measurement
    from repro_torch.autotune.calibrate import (Calibration,
                                                resolve_calibration)
    ici_bw, dci_bw, codec_bw = LINK_BW, DCI_BW, None
    cal = None
    if comm_model is None:
        cal = resolve_calibration()
    elif isinstance(comm_model, Calibration):
        cal = comm_model
    else:
        ici_bw, dci_bw = comm_model.fast_bw, comm_model.slow_bw
        codec_bw = comm_model.compress_bw
    if cal is not None:
        if "fast_bw" in cal.fitted:
            ici_bw = cal.model.fast_bw
        if "slow_bw" in cal.fitted:
            dci_bw = cal.model.slow_bw
        if "compress_bw" in cal.fitted:
            codec_bw = cal.model.compress_bw
    lay = cfg.layout
    pods = 2 if multi_pod else 1
    chips = pods * 256
    tp = lay.tp
    fsdp = lay.fsdp
    learners = pods * lay.learners_per_pod
    P = learners
    S = lay.local if lay.local > 1 else (pods if pods > 1 else 1)

    n_active = cfg.active_param_count()
    n_total = cfg.param_count()
    # per-learner param shard bytes (bf16), sharded over fsdp x tp
    p_shard = n_total * BF16 / (fsdp * tp)
    rolling = (shape.name == "long_500k" and cfg.family in
               ("dense", "moe", "vlm", "audio") and not cfg.kv_lora_rank) \
        if sliding_rolling is None else sliding_rolling
    ctx = _ctx(cfg, shape, rolling)
    L = cfg.n_layers

    parts: Dict[str, float] = {}
    det: Dict[str, float] = {}

    if shape.kind == "train":
        tokens_global = shape.global_batch * shape.seq_len
        tokens_dev = tokens_global / chips
        mult = 6.0  # fwd + bwd
        flops = mult * n_active * tokens_dev \
            + 3.0 * _attn_flops_per_token_layer(cfg, ctx) * L * tokens_dev
        micro = lay.microbatch
        # HBM: weights touched 3x (fwd read, bwd read, grad write) PER
        # microbatch pass + activation traffic ~ c * tokens * d * L
        bytes_w = 3.0 * p_shard * micro
        bytes_a = 12.0 * tokens_dev * cfg.d_model * BF16 * L
        bytes_ = bytes_w + bytes_a
        # collectives (per step, per device):
        tok_learner = tokens_global / learners / micro
        tok_tp_local = tok_learner / fsdp               # per-device tokens
        parts["tp_act"] = (4.0 * tok_tp_local * cfg.d_model * BF16 * L
                           * micro * _ring(tp)) / LINK_BW
        if cfg.uses_moe:
            # all-to-all dispatch/combine over the expert (tp) axis
            parts["moe_a2a"] = (4.0 * tok_tp_local * cfg.d_model * BF16
                                * (L - cfg.first_k_dense) * micro
                                * (tp - 1) / tp) / LINK_BW
        if fsdp > 1:
            parts["fsdp"] = (2.0 * p_shard * micro * (fsdp - 1)) / LINK_BW
        if hier.plan is None:
            if S > 1:
                bw = ici_bw if lay.local > 1 else dci_bw
                parts["local_avg"] = (p_shard * _ring(S)) / bw / hier.k1
            if P > 1:
                bw = dci_bw if multi_pod else ici_bw
                parts["global_avg"] = (p_shard * _ring(P)) / bw / hier.k2
        else:
            # N-level plan: each level over its own link tier and its own
            # compressed payload (reducer payload factor vs dense bf16).
            # Pipelined levels (comm/bucket.py) overlap each bucket's
            # collective with the next bucket's compress, so they expose
            # max(compute, comm) per stage + the fill/drain ramp instead
            # of the serial sum (same model as theory.plan_comm_per_round;
            # the realistic-leaf template makes the bucket count honest).
            from repro_torch.core.theory import (CommModel,
                                                 param_template,
                                                 scheduled_wall)
            plan = hier.resolved_plan
            template = param_template(
                n_total, n_leaves=max(1, 8 * cfg.n_layers))
            dense_bytes = sum(2 * leaf.numel()
                              for leaf in template.values())
            compress_bw = codec_bw if codec_bw is not None \
                else CommModel().compress_bw
            sizes = {0: pods, 1: lay.groups, 2: lay.local}
            for lvl in plan.levels:
                n = 1
                for ax in lvl.axes:
                    n *= sizes[ax]
                if n <= 1:
                    continue
                crosses = 0 in lvl.axes and pods > 1
                bw = dci_bw if crosses else ici_bw
                factor = lvl.reducer.payload_bytes(template) / dense_bytes
                comm = p_shard * factor * _ring(n) / bw
                m = lvl.reducer.n_messages(template)
                s_cmp = (p_shard / compress_bw / m
                         if getattr(lvl.reducer, "has_codec", True)
                         else 0.0)
                overlaps = getattr(lvl.reducer, "overlaps", False)
                wall = scheduled_wall(s_cmp, comm / m, m, overlaps)
                if overlaps and m > 1:
                    det[f"overlap_x_{lvl.name}"] = \
                        (comm + m * s_cmp) / wall
                parts[f"{lvl.name}_avg"] = wall / lvl.period
        det["tokens_per_device"] = tokens_dev
        model_flops = mult * n_active * tokens_dev
    elif shape.kind == "prefill":
        tokens_dev = shape.global_batch * shape.seq_len / chips
        flops = 2.0 * n_active * tokens_dev \
            + _attn_flops_per_token_layer(cfg, ctx) * L * tokens_dev
        bytes_ = n_total * BF16 / chips + 8.0 * tokens_dev * cfg.d_model \
            * BF16 * L
        parts["tp_act"] = (4.0 * tokens_dev * cfg.d_model * BF16 * L
                           * _ring(tp)) / LINK_BW
        if cfg.uses_moe:
            parts["moe_a2a"] = (4.0 * tokens_dev * cfg.d_model * BF16
                                * (L - cfg.first_k_dense)
                                * (tp - 1) / tp) / LINK_BW
        model_flops = 2.0 * n_active * tokens_dev
    else:  # decode
        B = shape.global_batch
        toks_dev = B / chips * tp   # batch shards over 'data' only
        flops = (2.0 * n_active * B
                 + _attn_flops_per_token_layer(cfg, ctx) * L * B) / chips
        # cache read per step: full context window per sequence
        if cfg.family == "ssm":
            hd = cfg.resolved_head_dim
            cache = B * L * cfg.ssm_heads * hd * hd * 4
        elif cfg.kv_lora_rank:
            cache = B * L * ctx * (cfg.kv_lora_rank
                                   + cfg.qk_rope_head_dim) * BF16
        else:
            cache = B * L * 2 * ctx * cfg.n_kv_heads \
                * cfg.resolved_head_dim * BF16
            if cfg.family == "hybrid":
                di = cfg.d_model * cfg.ssm_expand
                cache += B * L * di * cfg.ssm_state * 4
        bytes_ = n_total * BF16 / chips + cache / chips
        parts["tp_act"] = (4.0 * (B / chips * tp) * cfg.d_model * BF16 * L
                           * _ring(tp)) / LINK_BW / tp
        det["cache_bytes_per_device"] = cache / chips
        model_flops = 2.0 * n_active * B / chips

    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_ / HBM_BW
    collective_s = sum(parts.values())
    dom = max((("compute", compute_s), ("memory", memory_s),
               ("collective", collective_s)), key=lambda kv: kv[1])[0]
    return Roofline(compute_s, memory_s, collective_s, parts, dom,
                    model_flops, det)
