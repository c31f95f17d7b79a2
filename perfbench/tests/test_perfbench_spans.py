"""The readers of the program's own spans (``round_step_ms``,
``round_local_fire_ms``, ``round_global_fire_ms``, ``global_codec_ms``,
``round_device_ops``) on a hand-built trace with known spans, launches
and device operations; and nothing where the spans or the trace are
missing."""
from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

import perfbench_tiny as tiny
from perfbench.bench import trace as tr
from perfbench.bench.spec import Spec

SPEC = Spec(tiny.REPO)
READERS = ("round_step_ms", "round_local_fire_ms", "round_global_fire_ms",
           "global_codec_ms", "round_device_ops")


def ann(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def launch(corr, ts, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": 2.0, "args": {"correlation": corr}}


def op(corr, ts, dur, cat="kernel", name="void k<1>(float*)"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


SPANS = [ann("hier.round", 10.0, 890.0),
         ann("hier.step", 20.0, 100.0), ann("hier.step", 200.0, 100.0),
         ann("hier.fire.local", 130.0, 60.0), ann("comm.mean", 140.0, 40.0),
         ann("hier.fire.global", 400.0, 200.0),
         ann("comm.compress", 410.0, 40.0), ann("comm.mean", 460.0, 40.0),
         ann("comm.finalize", 510.0, 40.0)]
WORK = [
    # step 1: two kernels back to back and a copy, 95 us busy
    launch(1, 30.0), op(1, 40.0, 60.0), launch(2, 50.0), op(2, 100.0, 30.0),
    launch(9, 60.0, "cudaMemcpyAsync"),
    op(9, 130.0, 5.0, "gpu_memcpy", "Memcpy DtoD"),
    # step 2: 70 us
    launch(3, 210.0), op(3, 220.0, 70.0),
    # the local fire's mean: 10 us
    launch(4, 150.0), op(4, 160.0, 10.0),
    # the global fire: compress 40, mean 20 (adjacent), finalize 15
    launch(5, 420.0), op(5, 430.0, 40.0), launch(6, 470.0),
    op(6, 470.0, 20.0), launch(7, 520.0), op(7, 530.0, 15.0),
    # launched in the window after the round
    launch(8, 950.0), op(8, 960.0, 20.0)]
WINDOW = ann("perfbench.window", 0.0, 1000.0)


def ctx_of(events, tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    full = tr.load(str(path))
    return SimpleNamespace(trace=tr.launched(full, 0.0, 1000.0),
                           trace_window=(0.0, 1000.0))


def test_every_cell_reports_the_span_metrics():
    for cell in SPEC.cells():
        names = [m["name"] for m in SPEC.metrics(cell, trace=True)]
        assert set(READERS) <= set(names), cell


@pytest.mark.parametrize("name,want", [
    ("round_step_ms", (95.0 + 70.0) / 2 / 1e3),
    ("round_local_fire_ms", 10.0 / 1e3),
    ("round_global_fire_ms", 75.0 / 1e3),
    ("global_codec_ms", 55.0 / 1e3),
    ("round_device_ops", 8)])
def test_span_reader_on_a_known_trace(name, want, tmp_path):
    ctx = ctx_of([WINDOW] + SPANS + WORK, tmp_path)
    got = SPEC.reader(name).read(ctx)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_span_reader_gives_nothing_without_spans(name, tmp_path):
    # the parent's trace: the window and its work, no program span
    assert SPEC.reader(name).read(ctx_of([WINDOW] + WORK, tmp_path)) is None
    assert SPEC.reader(name).read(SimpleNamespace(trace=None)) is None


def test_codec_stages_outside_a_global_fire_are_not_its(tmp_path):
    # a local fire's codec stages, and a global fire without any, read 0
    events = [WINDOW, ann("hier.round", 10.0, 890.0),
              ann("hier.fire.local", 130.0, 60.0),
              ann("comm.compress", 135.0, 20.0),
              ann("hier.fire.global", 400.0, 200.0),
              ann("comm.mean", 460.0, 40.0)] + WORK
    ctx = ctx_of(events, tmp_path)
    assert SPEC.reader("global_codec_ms").read(ctx) == 0.0
    assert SPEC.reader("round_global_fire_ms").read(ctx) \
        == pytest.approx(75.0 / 1e3)
