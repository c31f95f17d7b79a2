"""What the metric readers share: a kernel's share of its roofline from
the traced rounds, and the leaf sizes of a configuration."""
from __future__ import annotations

import math
import re
from typing import List, Optional

from perfbench.bench import trace as tr
from perfbench.bench import yardstick


def leaf_sizes(ctx) -> List[int]:
    return [math.prod(s) for _, s in ctx.adapter.param_specs(ctx.cfg)]


def roofline_pct(ctx, pattern: str, round_bytes: int) -> Optional[float]:
    """100 x the least time of ``round_bytes`` (a round's) over the traced
    round's device time of the kernels whose name ``pattern`` finds; None
    where the trace has none of them or the round asks for no bytes."""
    if ctx.trace is None or not round_bytes:
        return None
    found = re.compile(pattern)
    us = tr.device_time_us(ctx.trace, lambda name: bool(found.search(name)))
    if not us:
        return None
    least = yardstick.least_ms(round_bytes)
    return 100.0 * least / (us / 1e3)
