"""The benchmark's own arithmetic: a model's multiply-adds against
FlopCounterMode over the frozen reference on meta tensors, and the bytes
of the top-k, WKV6 and qint8 calls against the bound column of PERF.md's
kernel table (NVIDIA H100, 3.35e12 B/s) at that table's shapes."""
from __future__ import annotations

import json
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import perfbench_tiny as tiny
from perfbench.bench import yardstick
from perfbench.bench.spec import Spec
from perfbench.reference import resnet as ref_resnet
from perfbench.reference import rwkv6 as ref_rwkv

SPEC = Spec(tiny.REPO)
RESNET = SPEC.config("resnet18-cifar10")
RWKV = SPEC.config("rwkv6-1.6b")


def meta_params(specs, lead=()):
    return {p: torch.empty(lead + tuple(s), device="meta")
            for p, s in specs}


@pytest.mark.parametrize("width", [64, 16])
def test_resnet_macs_equal_flop_counter(width):
    cfg = dict(RESNET, width=width)
    p = meta_params(ref_resnet.param_specs(cfg))
    x = torch.empty((1, 32, 32, 3), device="meta")
    with FlopCounterMode(display=False) as fc:
        ref_resnet.logits(p, x, cfg)
    adapter = SPEC.model("resnet")
    assert 2 * adapter.macs_per_sample(cfg, {}) == fc.get_total_flops()


def test_resnet18_width64_counts():
    adapter = SPEC.model("resnet")
    assert adapter.macs_per_sample(RESNET, {}) == 555_422_720
    n = sum(math.prod(s) for _, s in ref_resnet.param_specs(RESNET))
    assert n == RESNET["params_per_learner"] == 11_172_160


def test_rwkv6_macs_per_token():
    """The products FlopCounterMode sees (every weight, the head and the
    WKV output's r . (S + u k v^T)) plus what it does not: the outer
    product k v^T and the state update, D^2 each a head."""
    cfg = dict(RWKV, d_model=256, d_ff=512, ssm_heads=4, head_dim=64,
               vocab_size=1024)
    L, B, S = 1, 1, 8
    p = meta_params(ref_rwkv.param_specs(cfg), (L,))
    tok = torch.zeros((L, B, S), dtype=torch.long, device="meta")
    with FlopCounterMode(display=False) as fc:
        ref_rwkv.learner_losses(p, {"tokens": tok, "labels": tok}, cfg)
    adapter = SPEC.model("rwkv6")
    seen = fc.get_total_flops() / (2 * B * S)
    unseen = cfg["n_layers"] * 2 * cfg["ssm_heads"] * cfg["head_dim"] ** 2
    assert adapter.macs_per_token(cfg) == seen + unseen
    # at the cell's widths, 2 layers: 0.7552 TFLOP a 512-token sample
    assert adapter.macs_per_token(RWKV) == 245_891_072
    assert 6 * adapter.macs_per_sample(RWKV, {"seq": 512}) == \
        pytest.approx(7.5538e11, rel=1e-4)


def lm_leaf_sizes(n_layers):
    return [math.prod(s) for _, s in
            ref_rwkv.param_specs(dict(RWKV, n_layers=n_layers))]


def test_topk_bytes_reproduce_the_kernel_table():
    sizes = [math.prod(s) for _, s in ref_resnet.param_specs(RESNET)]
    fire = sum(yardstick.topk_bytes(16, n, 0.05) for n in sizes)
    assert round(yardstick.least_ms(fire), 4) == 0.2348
    fire = sum(yardstick.topk_bytes(4, n, 0.05) for n in lm_leaf_sizes(4))
    assert round(yardstick.least_ms(fire), 4) == 2.5760
    traffic = SPEC.traffic("topk-perleaf-b32")
    assert yardstick.round_topk_bytes(sizes, traffic, 16) == \
        sum(yardstick.topk_bytes(16, n, 0.05) for n in sizes)


def test_wkv_bytes_reproduce_the_kernel_table():
    fwd, bwd = yardstick.wkv_bytes(8, 512, 32, 64)
    assert round(yardstick.least_ms(fwd), 4) == 0.0526
    assert round(yardstick.least_ms(bwd), 4) == 0.0939
    adapter = SPEC.model("rwkv6")
    traffic = SPEC.traffic("topk-perleaf-2x512")
    per = adapter.round_kernel_bytes(RWKV, traffic)
    assert per == {"wkv6_fwd": 2 * 8 * fwd, "wkv6_bwd": 2 * 8 * bwd}


def test_qint8_bytes_reproduce_the_kernel_table():
    sizes = [math.prod(s) for _, s in ref_resnet.param_specs(RESNET)]
    traffic = SPEC.traffic("qint8-bucketed-b32")
    units = yardstick.codec_units(sizes, traffic, "qint8")
    assert units == [2_359_296] * 10
    pack = sum(yardstick.qint8_bytes(16, n) for n in units)
    assert round(yardstick.least_ms(pack), 4) == 0.5652
    # 4 local fires a round, pack and unpack each
    assert yardstick.round_qint8_bytes(sizes, traffic, 16) == 4 * 2 * pack


def test_peaks_and_configs_agree_with_benchmark_json():
    assert yardstick.PEAKS["fp32_flops"] == 67e12
    assert yardstick.PEAKS["hbm_bytes_per_s"] == 3.35e12
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((tiny.REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
