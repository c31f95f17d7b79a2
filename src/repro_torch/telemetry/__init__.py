"""Runtime telemetry: structured metrics rows, span tracing, and
device-side gradient statistics (PyTorch port of ``repro/telemetry``).

Three layers, composable and individually optional:

* :mod:`repro_torch.telemetry.metrics` — :class:`MetricsLogger`: typed
  counter/gauge/histogram channels plus schema-versioned structured
  rows (JSONL sink + in-memory ring buffer);
* :mod:`repro_torch.telemetry.spans` — ``span``, the hook the round and
  the reducers open their spans with (``hier.*``, ``comm.*``: profiler
  annotations, or recorded in an installed tracer, else one flag check),
  and :class:`SpanTracer`: host-side span timers with device fencing,
  Chrome-trace export on the profiler's clock (Perfetto-viewable);
* :mod:`repro_torch.telemetry.gradstats` — device-side statistics inside
  the round behind ``make_hier_round(..., telemetry=)``: per-level
  parameter divergence, gradient-norm variance, EF residual mass,
  codec compression error (on a mesh of ranks, the whole grid's).

The rows' first consumer is ``repro_torch.autotune.CostAwarePlan.observe``
(``launch/train.py --autotune``).
"""
from repro_torch.telemetry.gradstats import (TelemetryConfig, codec_error,
                                             ef_mass, group_divergence,
                                             level_stats,
                                             make_grad_observer,
                                             resolve_telemetry)
from repro_torch.telemetry.metrics import (ROW_SCHEMAS, SCHEMA_VERSION,
                                           MetricsLogger, validate_jsonl)
from repro_torch.telemetry.spans import SpanTracer

__all__ = [
    "MetricsLogger", "SpanTracer", "TelemetryConfig", "ROW_SCHEMAS",
    "SCHEMA_VERSION", "validate_jsonl", "resolve_telemetry",
    "group_divergence", "codec_error", "ef_mass", "level_stats",
    "make_grad_observer",
]
