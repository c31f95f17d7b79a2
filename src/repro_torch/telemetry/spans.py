"""Spans on the program's hot path, and host-side span timers with device
fencing and Chrome-trace export (PyTorch port of
``repro/telemetry/spans.py``).

:func:`span` is the one hook the program's hot path calls.  The round
(core/hier_avg.py) and the reducers (comm/reducer.py, comm/bucket.py)
open these spans:

* ``hier.round`` — the whole of a ``make_hier_round`` round;
* ``hier.step`` — each SGD step of all learners inside it;
* ``hier.fire.<level>`` — each level's fire (its reducer and the learner
  mean), an inner level firing at an outer boundary included;
* ``comm.compress``, ``comm.decompress``, ``comm.mean``,
  ``comm.finalize`` — the four stages of a fire, once a fire on the
  serial path and once a bucket on the pipelined one.

A span costs one flag check when nothing listens.  Under an open
``torch.profiler`` session it is a ``record_function`` range, so it sits
in the profiler's Chrome trace as a ``user_annotation`` on the
profiler's clock, and the device operations launched inside it are found
by correlation id.  Under an installed :class:`SpanTracer`
(:func:`installed`) it is also recorded there.  No span runs inside a
``vmap``-ped or differentiated function, and none changes a result.

:class:`SpanTracer` (``launch/train.py --trace-out``) decomposes a
training round into phases the host can honestly time:

* ``data`` — batch construction / reshaping;
* ``device`` — dispatch + device execution.  CUDA launches are async,
  so a span that merely *calls* the round measures dispatch only; call
  :meth:`SpanTracer.fence` on the results INSIDE the span to
  synchronize their device and bill the device wait where it belongs;
* ``host_sync`` — the device→host transfer of the metrics;

and, installed, the round's own spans above.  With ``profile_dir`` (the
``--profile-dir`` flag) it runs a ``torch.profiler`` session whose Chrome
trace (host ops and, on the card, its kernels) is written under
``profile_dir`` when the profiler stops.

Spans are stamped with ``time.time_ns()``.  Export is the Chrome
trace-event format (``{"traceEvents": [...]}``, complete events,
microsecond timestamps) against the same ``baseTimeNanoseconds`` as the
profiler's trace: the profiler's when the tracer ran a session, else the
tracer's own start.  Both files then overlay on one clock in
https://ui.perfetto.dev.  Nesting is enforced by the context-manager
stack, so child spans are always contained in their parent's
[ts, ts+dur] interval.
"""
from __future__ import annotations

import gzip
import json
import os
import time
from contextlib import contextmanager, nullcontext
from typing import Any, Dict, List, Optional

import torch

# the profiler's own state, ~0.2 us a read: record_function entered with
# no session open costs ~12 us, so the hook checks first
_profiler_enabled = torch._C._autograd._profiler_enabled
_NULL = nullcontext()
_TRACER: Optional["SpanTracer"] = None


def span(name: str):
    """A context manager around one phase of the program: a
    ``record_function`` range under an open profiler session, a span of
    the installed :class:`SpanTracer` (and that range), else one shared
    null context."""
    if _TRACER is not None:
        return _TRACER.span(name)
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


@contextmanager
def installed(tracer: Optional["SpanTracer"]):
    """Make ``tracer`` the process's tracer inside the block (``None``:
    leave things as they are), so the program's :func:`span` calls are
    recorded in it."""
    global _TRACER
    if tracer is None:
        yield None
        return
    prev, _TRACER = _TRACER, tracer
    try:
        yield tracer
    finally:
        _TRACER = prev


class SpanTracer:
    """Collects host-side spans; each is also a ``record_function``
    range while a profiler session is open (its own, with
    ``profile_dir``, or another's)."""

    def __init__(self, profile_dir: Optional[str] = None):
        self.profile_dir = profile_dir
        self.spans: List[Dict[str, Any]] = []
        self._stack: List[Dict[str, Any]] = []
        # the exported trace's time origin (epoch ns): this start, or
        # the profiler's baseTimeNanoseconds once its session has run
        self.base_ns = time.time_ns()
        self._prof = None

    # ------------------------------------------------------------ #

    @contextmanager
    def span(self, name: str, cat: str = "host",
             args: Optional[Dict[str, Any]] = None):
        """Time a phase.  Yields the span record; on exit it carries
        ``ts`` (epoch ns) and ``dur`` (ns)."""
        rec = {"name": name, "cat": cat, "ts": time.time_ns(), "dur": 0,
               "depth": len(self._stack), "args": dict(args or {})}
        self._stack.append(rec)
        ann = None
        if _profiler_enabled():
            ann = torch.profiler.record_function(name)
            ann.__enter__()
        try:
            yield rec
        finally:
            if ann is not None:
                ann.__exit__(None, None, None)
            self._stack.pop()
            rec["dur"] = time.time_ns() - rec["ts"]
            self.spans.append(rec)

    def fence(self, value: Any) -> None:
        """Synchronize the device of every tensor in ``value`` so the
        enclosing span is billed the device wait, not just the async
        dispatch."""
        from repro_torch.tree import leaves
        for dev in {x.device for x in leaves(value)
                    if isinstance(x, torch.Tensor)}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # ------------------------------------------------------------ #
    # torch.profiler session (--profile-dir)

    def start_profiler(self) -> None:
        if self.profile_dir and self._prof is None:
            from torch.profiler import ProfilerActivity
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()

    def stop_profiler(self) -> None:
        """End the profiler session, write its Chrome trace to
        ``<profile_dir>/trace.json.gz`` and take its time origin as the
        tracer's."""
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            os.makedirs(self.profile_dir, exist_ok=True)
            path = os.path.join(self.profile_dir, "trace.json.gz")
            self._prof.export_chrome_trace(path)
            self._prof = None
            with gzip.open(path, "rt") as f:
                # a trace without the key is stamped from the epoch
                self.base_ns = int(json.load(f).get("baseTimeNanoseconds",
                                                    0))

    # ------------------------------------------------------------ #

    def export_chrome_trace(self, path: str) -> None:
        """Write the collected spans as a Chrome trace-event file, in us
        from ``base_ns`` (written as ``baseTimeNanoseconds``)."""
        events: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": 0,
            "args": {"name": "repro host"}}]
        for s in self.spans:
            events.append({
                "name": s["name"], "cat": s["cat"], "ph": "X",
                "ts": round((s["ts"] - self.base_ns) / 1e3, 3),
                "dur": round(s["dur"] / 1e3, 3),
                "pid": 0, "tid": 0, "args": s["args"]})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "baseTimeNanoseconds": self.base_ns}, f)
