"""Structured runtime metrics: typed channels + per-round rows (PyTorch
port of ``repro/telemetry/metrics.py``; plain Python, copied, and the row
schemas are the reference's).

:class:`MetricsLogger` is the host-side half of the telemetry plane
(the device-side half is gradstats.py).  It carries three typed
channels —

* **counters** — monotonically increasing integers (``rounds``,
  ``refill_events``);
* **gauges** — last-write-wins floats (``pages_in_use``);
* **histograms** — bounded reservoirs summarized as
  count/mean/min/p50/p95/max (``round_wall_s``);

— and a structured **row** stream: one dict per event (train round,
serve step, serve summary), stamped with ``schema_version`` and
validated against the frozen per-subsystem key schema in
:data:`ROW_SCHEMAS`.  Rows land in an in-memory ring buffer (cheap to
keep on; consumers like ``CostAwarePlan.observe`` read it back) and,
when a path is given, a JSONL file sink with buffered writes (one
``write()`` per ``flush_every`` rows, not per row — the sink must never
become the per-round host-sync hotspot it exists to measure).

Schema stability is a compatibility contract: removing a key from a
subsystem's REQUIRED set, or renaming a subsystem, breaks downstream
readers (CI's JSONL smoke, dashboards) — bump :data:`SCHEMA_VERSION`
and keep a migration note here when you must.  ADDING optional keys is
always safe; rows may carry any extras beyond the required set.

Non-finite floats are serialized as ``null`` so the JSONL stays strict
JSON (``json.load`` everywhere, not just Python).
"""
from __future__ import annotations

import json
import math
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

# bump on any backwards-incompatible row change (key removal/rename);
# see module docstring
SCHEMA_VERSION = 1

# frozen REQUIRED keys per subsystem — the golden sets
# tests/test_telemetry.py pins and ci.yml's JSONL smoke checks.
# ``schema_version``/``subsystem`` are stamped by log_row itself.
ROW_SCHEMAS: Dict[str, frozenset] = {
    # one row per training round (core/simulator.py, launch/train.py)
    "train_round": frozenset({
        "schema_version", "subsystem", "round", "loss", "wall_s"}),
    # one row per decode step of the paged serving engine
    "serve_step": frozenset({
        "schema_version", "subsystem", "step", "active_slots",
        "occupancy", "new_tokens", "pages_in_use"}),
    # one row per serve_queue call (both engines)
    "serve_summary": frozenset({
        "schema_version", "subsystem", "engine", "requests", "tokens",
        "decode_steps", "wall_s", "tokens_per_s", "wasted_ratio",
        "refill_events", "peak_pages_in_use"}),
}


def _jsonify(v: Any) -> Any:
    """Plain-JSON view of a row value: numpy scalars/arrays unwrapped,
    non-finite floats to null (strict-JSON portability)."""
    if isinstance(v, (np.generic,)):
        v = v.item()
    if isinstance(v, np.ndarray):
        return [_jsonify(x) for x in v.tolist()]
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if isinstance(v, dict):
        return {k: _jsonify(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonify(x) for x in v]
    return v


def _summary(values: List[float]) -> Dict[str, float]:
    a = np.asarray(values, dtype=np.float64)
    return {"count": int(a.size), "mean": float(a.mean()),
            "min": float(a.min()), "p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)), "max": float(a.max())}


class MetricsLogger:
    """Typed metric channels + a structured row stream.

    ``jsonl_path`` — optional JSONL sink (one JSON object per line).
    ``ring`` — in-memory row capacity (oldest rows evicted).
    ``flush_every`` — rows buffered between file writes.

    Usable as a context manager; ``close()`` flushes the sink.
    """

    def __init__(self, jsonl_path: Optional[str] = None, *,
                 ring: int = 1024, flush_every: int = 16):
        self.jsonl_path = jsonl_path
        self.ring: deque = deque(maxlen=ring)
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, float] = {}
        self._hists: Dict[str, List[float]] = {}
        self._hist_cap = 4096
        self._flush_every = max(1, flush_every)
        self._buf: List[str] = []
        self._file = open(jsonl_path, "w") if jsonl_path else None
        self._seq = 0

    # ------------------------------------------------------------ #
    # typed channels

    def count(self, name: str, inc: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(inc)

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def histogram(self, name: str, value: float) -> None:
        h = self._hists.setdefault(name, [])
        if len(h) < self._hist_cap:      # bounded reservoir
            h.append(float(value))

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time view of every typed channel."""
        return {"counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {k: _summary(v)
                               for k, v in self._hists.items() if v}}

    # ------------------------------------------------------------ #
    # structured rows

    def log_row(self, subsystem: str, **fields: Any) -> Dict[str, Any]:
        """Emit one structured row; returns the stamped dict.

        Raises ``ValueError`` on an unknown subsystem or a missing
        required key (ROW_SCHEMAS) — a malformed producer should fail
        loudly at the write, not in a downstream reader.
        """
        if subsystem not in ROW_SCHEMAS:
            raise ValueError(
                f"unknown telemetry subsystem {subsystem!r}; known: "
                f"{sorted(ROW_SCHEMAS)}")
        row = {"schema_version": SCHEMA_VERSION, "subsystem": subsystem,
               "seq": self._seq}
        self._seq += 1
        row.update(fields)
        missing = ROW_SCHEMAS[subsystem] - row.keys()
        if missing:
            raise ValueError(
                f"{subsystem} row missing required keys {sorted(missing)}")
        self.ring.append(row)
        if self._file is not None:
            self._buf.append(json.dumps(_jsonify(row)))
            if len(self._buf) >= self._flush_every:
                self.flush()
        return row

    def rows(self, subsystem: Optional[str] = None
             ) -> Iterator[Dict[str, Any]]:
        for row in self.ring:
            if subsystem is None or row["subsystem"] == subsystem:
                yield row

    # ------------------------------------------------------------ #

    def flush(self) -> None:
        if self._file is not None and self._buf:
            self._file.write("\n".join(self._buf) + "\n")
            self._file.flush()
            self._buf = []

    def close(self) -> None:
        self.flush()
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def validate_jsonl(path: str) -> List[Dict[str, Any]]:
    """Load and validate a metrics JSONL file.

    Every line must parse as a JSON object carrying ``schema_version``,
    a known ``subsystem``, and that subsystem's full required key set —
    the contract ci.yml's ``--metrics-out`` smoke enforces.  Returns the
    rows; raises ``ValueError`` with the offending line number otherwise.
    """
    rows: List[Dict[str, Any]] = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i}: unparseable JSONL: {e}")
            if not isinstance(row, dict):
                raise ValueError(f"{path}:{i}: row is not an object")
            sub = row.get("subsystem")
            if sub not in ROW_SCHEMAS:
                raise ValueError(
                    f"{path}:{i}: unknown subsystem {sub!r}")
            if row.get("schema_version") != SCHEMA_VERSION:
                raise ValueError(
                    f"{path}:{i}: schema_version "
                    f"{row.get('schema_version')!r} != {SCHEMA_VERSION}")
            missing = ROW_SCHEMAS[sub] - row.keys()
            if missing:
                raise ValueError(
                    f"{path}:{i}: {sub} row missing {sorted(missing)}")
            rows.append(row)
    return rows
