"""Reading the program's own spans in the traced round: the profiler's
annotations that ``repro_torch/telemetry/spans.py`` opens (``hier.round``,
``hier.step``, ``hier.fire.<level>``, ``comm.<stage>``), and the device
operations launched inside each, found through their launches.  A trace
without the spans (a program that opens none) gives None."""
from __future__ import annotations

import statistics
from typing import List, Optional, Tuple

from perfbench.bench import trace as tr

# a fire's codec stages: everything in it but the learner mean
CODEC = ("comm.compress", "comm.decompress", "comm.finalize")


def found(trace: tr.Trace, name: str) -> List[Tuple[float, float]]:
    """[(start, end)] in us of the host annotations ``name``."""
    return [(e.ts, e.ts + e.dur) for e in trace.host if e.name == name]


def device_ms(trace: tr.Trace, start: float, end: float) -> float:
    """The device's busy time (the union of its operations) of what was
    launched inside [start, end], in ms."""
    return tr.busy_us(tr.launched(trace, start, end).device) / 1e3


def mean_device_ms(ctx, name: str) -> Optional[float]:
    """The mean over the traced round's spans ``name`` of each one's
    device time, in ms."""
    if ctx.trace is None:
        return None
    spans = found(ctx.trace, name)
    if not spans:
        return None
    return statistics.fmean(device_ms(ctx.trace, a, b) for a, b in spans)


def codec_ms(ctx, fire: str) -> Optional[float]:
    """The mean over the spans ``fire`` of the device time of the codec
    stages (:data:`CODEC`) inside each, in ms."""
    if ctx.trace is None:
        return None
    fires = found(ctx.trace, fire)
    stages = [s for name in CODEC for s in found(ctx.trace, name)]
    if not fires or not stages:
        return None
    per_fire = []
    for a, b in fires:
        ops = [op for s, e in stages if a <= s and e <= b
               for op in tr.launched(ctx.trace, s, e).device]
        per_fire.append(tr.busy_us(ops) / 1e3)
    return statistics.fmean(per_fire)


def mean_device_ops(ctx, name: str) -> Optional[float]:
    """The mean over the spans ``name`` of the number of device
    operations (kernels, copies, sets) launched inside each."""
    if ctx.trace is None:
        return None
    spans = found(ctx.trace, name)
    if not spans:
        return None
    return statistics.fmean(len(tr.launched(ctx.trace, a, b).device)
                            for a, b in spans)
