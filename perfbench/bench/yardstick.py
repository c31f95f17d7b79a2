"""The benchmark's own arithmetic: the chip's peaks, and the operations
and bytes of the work a round asks for, counted from the configuration's
shapes and the plan, whatever implements them.

Bytes count each input byte read once and each output byte written once
(scratch, checkpoints and re-reads are the implementation's, and are not
counted); a kernel's least time is its bytes over the memory bandwidth.
A model's operations are 2 per multiply-add of its forward pass, times 3
for the forward and the backward; recomputation, the optimizer and the
reductions are not counted.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

from perfbench.reference.hier_avg import (QINT8_BLOCK, bucket_runs,
                                          parse_plan)

# One NVIDIA H100 SXM (the data sheet's rates), at its 700 W limit.  The
# cells run float32 with TF32 off: the tensor cores' rates do not apply.
PEAKS = {
    "fp32_flops": 67e12,          # float32 outside the tensor cores
    "hbm_bytes_per_s": 3.35e12,
}
FP32 = 4
INT32 = 4


def least_ms(nbytes: float) -> float:
    return nbytes / PEAKS["hbm_bytes_per_s"] * 1e3


# -- the reducers' codec units and fires ---------------------------------- #

def codec_units(leaf_sizes: List[int], traffic: Dict, codec: str
                ) -> List[int]:
    """Per-learner lengths of what one fire of ``codec`` works on: the
    leaves, or the (padded) buckets under the traffic's bucketing."""
    if traffic["bucket_bytes"] > 0 and codec in ("topk", "qint8"):
        return [n for _, n in bucket_runs(leaf_sizes,
                                          traffic["bucket_bytes"],
                                          traffic["overlap"])]
    return list(leaf_sizes)


def fires_per_round(traffic: Dict, codec: str) -> List[Tuple[int, object]]:
    """(fires a round, level) of each level of the plan that runs
    ``codec``."""
    levels = parse_plan(traffic["plan"])
    steps = levels[-1].period
    return [(steps // lvl.period, lvl) for lvl in levels
            if lvl.codec == codec]


def topk_bytes(rows: int, n: int, ratio: float) -> int:
    """One top-k call on [rows, n] fp32: x read, values and int32 indices
    of k = round(ratio n) entries a row written."""
    k = max(1, min(n, int(round(ratio * n))))
    return rows * n * FP32 + rows * k * (FP32 + INT32)


def qint8_bytes(rows: int, n: int, block: int = QINT8_BLOCK) -> int:
    """One pack or one unpack of [rows, n] fp32 (they move the same
    bytes): the fp32 side, and the wire of nb blocks of ``block`` int8
    and a 4-byte scale."""
    nb = -(-n // block)
    return rows * n * FP32 + rows * nb * (block + 4)


def wkv_bytes(b: int, s: int, h: int, d: int) -> Tuple[int, int]:
    """(forward, backward) of one fp32 WKV6 call on [b, s, h, d]: forward r,
    k, v, w read, y written, u and the initial and final states; backward
    those four, dy read, their four gradients written, u and du, the
    final state's gradient read and the initial's written and the
    initial state read."""
    seq = b * s * h * d
    st = b * h * d * d * FP32
    fwd = 5 * seq * FP32 + b * h * d * FP32 + 2 * st
    bwd = 9 * seq * FP32 + 2 * b * h * d * FP32 + 3 * st
    return fwd, bwd


def round_topk_bytes(leaf_sizes: List[int], traffic: Dict,
                     learners: int) -> int:
    total = 0
    for fires, lvl in fires_per_round(traffic, "topk"):
        per = sum(topk_bytes(learners, n, lvl.arg)
                  for n in codec_units(leaf_sizes, traffic, "topk"))
        total += fires * per
    return total


def round_qint8_bytes(leaf_sizes: List[int], traffic: Dict,
                      learners: int) -> int:
    """Pack and unpack together, every qint8 fire of a round."""
    total = 0
    for fires, lvl in fires_per_round(traffic, "qint8"):
        block = int(lvl.arg) if lvl.arg else QINT8_BLOCK
        per = sum(qint8_bytes(learners, n, block)
                  for n in codec_units(leaf_sizes, traffic, "qint8"))
        total += fires * 2 * per
    return total


def steps_per_round(traffic: Dict) -> int:
    return parse_plan(traffic["plan"])[-1].period


def learners(cfg: Dict) -> int:
    return math.prod(cfg["topology"])
