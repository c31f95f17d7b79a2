"""Reading a ``torch.profiler`` Chrome trace: the device's operations,
the time the device was busy, the longest device operations and the idle
gaps by what the host was doing then."""
from __future__ import annotations

import bisect
import gzip
import json
from typing import Dict, List, NamedTuple, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "python_function", "user_annotation") + LAUNCH_CATS
# host operations looked back over for the one that covers a gap's start
SCAN = 4096


class Event(NamedTuple):
    name: str
    ts: float       # us
    dur: float      # us
    corr: Optional[int] = None   # the profiler's link of a launch to its
                                 # device operation


class Trace(NamedTuple):
    device: List[Event]
    host: List[Event]


def load(path: str) -> Trace:
    with (gzip.open if path.endswith(".gz") else open)(path, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        corr = (e.get("args") or {}).get("correlation") \
            if cat in DEVICE_CATS + LAUNCH_CATS else None
        ev = Event(str(e.get("name", "")), float(e["ts"]), float(e["dur"]),
                   corr)
        if cat in DEVICE_CATS:
            dev.append(ev)
        elif cat in HOST_CATS:
            host.append(ev)
    return Trace(sorted(dev, key=lambda e: e.ts),
                 sorted(host, key=lambda e: e.ts))


def launched(trace: Trace, start_us: float, end_us: float) -> Trace:
    """The device operations launched inside [start, end] of the host's
    clock, each found through its launch (the profiler's correlation id;
    one without an id by its own start), so that an offset between the
    host's and the device's clocks moves none in or out; and the host
    operations that overlap [start, end]."""
    calls = {e.corr for e in trace.host
             if e.corr is not None and start_us <= e.ts <= end_us}
    dev = [e for e in trace.device
           if (e.corr in calls if e.corr is not None
               else start_us <= e.ts < end_us)]
    host = [e for e in trace.host
            if e.ts < end_us and e.ts + e.dur > start_us]
    return Trace(dev, host)


def busy_intervals(events: List[Event]) -> List[Tuple[float, float]]:
    """The union of the events' intervals, in order."""
    out: List[List[float]] = []
    for e in sorted(events, key=lambda e: e.ts):
        end = e.ts + e.dur
        if out and e.ts <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([e.ts, end])
    return [(a, b) for a, b in out]


def busy_us(events: List[Event]) -> float:
    return sum(b - a for a, b in busy_intervals(events))


def short_name(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    base = name.split("(")[0].strip()
    if base.startswith("void "):
        base = base[5:]
    return base[:160]


def device_time_us(trace: Trace, match) -> Optional[float]:
    """Summed duration of the device operations whose name ``match``
    accepts; None where there is none."""
    hits = [e.dur for e in trace.device if match(e.name)]
    return sum(hits) if hits else None


def top_device_ops(trace: Trace, n: int = 10) -> List[List]:
    by: Dict[str, float] = {}
    for e in trace.device:
        k = short_name(e.name)
        by[k] = by.get(k, 0.0) + e.dur
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e6] for k, v in top]


def idle_gaps(trace: Trace, start_us: float, end_us: float,
              n: int = 10, skip=("perfbench.window",)) -> List[List]:
    """The device's idle time inside [start, end], grouped by the host
    operation that was running at the start of each gap (the innermost:
    the latest started of those that cover that instant), the largest
    groups first.  Host operations named in ``skip`` (the benchmark's
    own annotation of the window) are passed over."""
    gaps, at = [], start_us
    for a, b in busy_intervals(trace.device):
        if b <= start_us or a >= end_us:
            continue
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if end_us > at:
        gaps.append((at, end_us))
    by: Dict[str, float] = {}
    host = trace.host
    starts = [e.ts for e in host]
    for a, b in gaps:
        name = "(no host operation)"
        # the latest-started host operation that covers a
        top_i = bisect.bisect_right(starts, a) - 1
        for i in range(top_i, max(top_i - SCAN, -1), -1):
            if host[i].ts + host[i].dur > a and host[i].name not in skip:
                name = host[i].name[:160]
                break
        by[name] = by.get(name, 0.0) + (b - a)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e6] for k, v in top]
