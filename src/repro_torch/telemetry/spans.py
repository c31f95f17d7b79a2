"""Host-side span timers with device fencing, Chrome-trace export
(PyTorch port of ``repro/telemetry/spans.py``).

:class:`SpanTracer` decomposes a training round into phases the host
can honestly time:

* ``data`` — batch construction / reshaping;
* ``device`` — dispatch + device execution.  CUDA launches are async,
  so a span that merely *calls* the round measures dispatch only; call
  :meth:`SpanTracer.fence` on the results INSIDE the span to
  synchronize their device and bill the device wait where it belongs;
* ``host_sync`` — the device→host transfer of the metrics.

The compute / compress / collective split inside the device span is
attached as MODELED child spans (:meth:`add_modeled_children`,
``cat="modeled"``) priced by ``theory.level_reduction_seconds`` —
clearly labeled so nobody mistakes an analytic bill for a measurement.
For real device profiles, pass ``profile_dir`` (the ``--profile-dir``
flag): spans are then bracketed by ``torch.profiler.record_function``
annotations inside a ``torch.profiler.profile`` session, whose Chrome
trace (host ops and, on the card, its kernels) is written under
``profile_dir`` when the profiler stops.

Export is the Chrome trace-event format (``{"traceEvents": [...]}``,
complete events, microsecond timestamps) — drop ``trace.json`` onto
https://ui.perfetto.dev to view.  Nesting is enforced by the context-
manager stack, so child spans are always contained in their parent's
[ts, ts+dur] interval (the property tests/test_telemetry.py pins).
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


class SpanTracer:
    """Collects host-side spans; optionally brackets them with
    ``torch.profiler.record_function`` annotations when ``profile_dir``
    is set."""

    def __init__(self, profile_dir: Optional[str] = None):
        self.profile_dir = profile_dir
        self.spans: List[Dict[str, Any]] = []
        self._stack: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()
        self._profiling = False
        self._prof = None

    # ------------------------------------------------------------ #

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    @contextmanager
    def span(self, name: str, cat: str = "host",
             args: Optional[Dict[str, Any]] = None):
        """Time a phase.  Yields the span record; on exit it carries
        ``ts``/``dur`` (seconds relative to tracer start)."""
        rec = {"name": name, "cat": cat, "ts": self._now(), "dur": 0.0,
               "depth": len(self._stack), "args": dict(args or {})}
        self._stack.append(rec)
        ann = None
        if self._profiling:
            import torch
            ann = torch.profiler.record_function(name)
            ann.__enter__()
        try:
            yield rec
        finally:
            if ann is not None:
                ann.__exit__(None, None, None)
            self._stack.pop()
            rec["dur"] = self._now() - rec["ts"]
            self.spans.append(rec)

    def fence(self, value: Any) -> None:
        """Synchronize the device of every tensor in ``value`` so the
        enclosing span is billed the device wait, not just the async
        dispatch."""
        import torch

        from repro_torch.tree import leaves
        for dev in {x.device for x in leaves(value)
                    if isinstance(x, torch.Tensor)}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def add_modeled_children(self, parent: Dict[str, Any],
                             phases: List
                             ) -> None:
        """Attach analytic child spans ``[(name, dur_s), ...]`` laid out
        sequentially from ``parent``'s start, ``cat="modeled"`` — the
        per-level compute/compress/collective decomposition the host
        cannot measure inside one fused jit program."""
        t = parent["ts"]
        for name, dur in phases:
            self.spans.append({
                "name": name, "cat": "modeled", "ts": t,
                "dur": float(dur), "depth": parent["depth"] + 1,
                "args": {"modeled": True}})
            t += float(dur)

    # ------------------------------------------------------------ #
    # torch.profiler bracketing (--profile-dir)

    def start_profiler(self) -> None:
        if self.profile_dir and not self._profiling:
            import torch
            from torch.profiler import ProfilerActivity
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self._profiling = True

    def stop_profiler(self) -> None:
        """End the profiler session and write its Chrome trace to
        ``<profile_dir>/trace.json.gz``."""
        if self._profiling:
            import os
            self._prof.__exit__(None, None, None)
            os.makedirs(self.profile_dir, exist_ok=True)
            self._prof.export_chrome_trace(
                os.path.join(self.profile_dir, "trace.json.gz"))
            self._prof = None
            self._profiling = False

    # ------------------------------------------------------------ #

    def export_chrome_trace(self, path: str) -> None:
        """Write the collected spans as a Chrome trace-event file."""
        events: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": 0,
            "args": {"name": "repro host"}}]
        for s in self.spans:
            events.append({
                "name": s["name"], "cat": s["cat"], "ph": "X",
                "ts": round(s["ts"] * 1e6, 3),
                "dur": round(s["dur"] * 1e6, 3),
                "pid": 0, "tid": 0, "args": s["args"]})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"},
                      f)
