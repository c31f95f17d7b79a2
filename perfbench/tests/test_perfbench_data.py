"""The harness is driven by data: in a copy of the benchmark, a new
configuration, traffic mix, per-layer metric and cell are added as new
files and entries only, and the harness lists them, runs the new cell and
reads the new metric from a canned trace, with no existing file edited."""
from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import perfbench_tiny as tiny
from perfbench.bench import harness
from perfbench.bench import trace as tr
from perfbench.bench.spec import Spec

READER = '''"""Device time of the elementwise kernels over the traced rounds, in
ms (a new reader: it names its own kernels)."""
from perfbench.bench import trace


def read(ctx):
    if ctx.trace is None:
        return None
    us = trace.device_time_us(ctx.trace, lambda n: "elementwise" in n)
    return None if us is None else us / 1e3
'''


def digest(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def canned_trace(path: Path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "perfbench.window",
           "ts": 0.0, "dur": 100.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 10.0,
           "dur": 40.0},
          {"ph": "X", "cat": "kernel", "name": "void elementwise_kernel<1>",
           "ts": 20.0, "dur": 10.0},
          {"ph": "X", "cat": "kernel", "name": "void elementwise_kernel<2>",
           "ts": 25.0, "dur": 15.0},
          {"ph": "X", "cat": "kernel", "name": "topk_digit(long long*)",
           "ts": 60.0, "dur": 20.0}]
    path.write_text(json.dumps({"traceEvents": ev}))


def test_new_cell_metric_config_and_mix_are_files(tmp_path):
    root = tmp_path / "copy"
    root.mkdir()
    shutil.copytree(tiny.REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(tiny.REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    before = digest(root)

    # new files only
    cfg = dict(tiny.RESNET, name="resnet-new", width=8,
               init=json.loads((root / "perfbench/configs/"
                                "resnet18-cifar10.json").read_text())["init"])
    (root / "perfbench/configs/resnet-new.json").write_text(json.dumps(cfg))
    (root / "perfbench/traffic/new-mix.json").write_text(json.dumps(
        dict(tiny.TOPK, batch_per_learner=2)))
    (root / "perfbench/metrics/elementwise_ms.py").write_text(READER)
    (root / "perfbench/limits/new-cell.json").write_text(json.dumps(
        {"limits": tiny.LIMITS}))
    # new entries only, in the one file a benchmark PR may extend
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "resnet-new", "source": "test",
                             "file": "perfbench/configs/resnet-new.json",
                             "reduced": ["width"], "why": "test"})
    bench["workloads"].append({"name": "new-cell", "config": "resnet-new",
                               "traffic": "new-mix", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "elementwise_ms", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "kernels/csrc",
                               "moves": "train_samples_per_s",
                               "workloads": ["new-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digest(root)
    changed = [f for f in before if f != "BENCHMARK.json"
               and after[f] != before[f]]
    assert not changed

    spec = Spec(root)
    assert "new-cell" in spec.cells()
    names = [m["name"] for m in spec.metrics("new-cell", trace=True)]
    assert "elementwise_ms" in names and "wkv6_fwd_roofline" not in names
    assert "elementwise_ms" not in [m["name"] for m in spec.metrics(
        "resnet18-p16-topk", trace=True)]

    canned_trace(tmp_path / "trace.json")
    t = tr.load(str(tmp_path / "trace.json"))
    ctx = SimpleNamespace(trace=t, trace_window=(0.0, 100.0))
    assert spec.reader("elementwise_ms").read(ctx) == 25.0 / 1e3
    idle = spec.reader("device_idle_share").read(ctx)
    assert abs(idle - 100.0 * (1 - 40.0 / 100.0)) < 1e-9
    gaps = dict(tr.idle_gaps(t, 0.0, 100.0))
    assert abs(sum(gaps.values()) - 60e-6) < 1e-12
    assert abs(gaps["aten::add"] - 20e-6) < 1e-12     # 40..60 us
    assert abs(gaps["(no host operation)"] - 40e-6) < 1e-12
    # a reader with nothing to read gives nothing
    assert spec.reader("elementwise_ms").read(
        SimpleNamespace(trace=None)) is None

    # the new cell runs end to end on the CPU, found by its name only
    out = harness.run("new-cell", 31, 0.2, False, spec=spec, device="cpu")
    assert out["line"]["correct"], out["checks"]
    assert set(out["line"]["metrics"]) == {"train_samples_per_s",
                                           "setup_s"}


def test_device_operations_follow_their_launch(tmp_path):
    # the device's clock runs 30 us behind the host's: a kernel launched
    # inside the annotation lands after it, and one launched before it
    # lands inside; each belongs where it was launched
    ev = [{"ph": "X", "cat": "user_annotation", "name": "fire",
           "ts": 100.0, "dur": 50.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 90.0, "dur": 2.0, "args": {"correlation": 7}},
          {"ph": "X", "cat": "kernel", "name": "before", "ts": 120.0,
           "dur": 10.0, "args": {"correlation": 7}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 110.0, "dur": 2.0, "args": {"correlation": 8}},
          {"ph": "X", "cat": "kernel", "name": "inside", "ts": 140.0,
           "dur": 25.0, "args": {"correlation": 8}}]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": ev}))
    t = tr.load(str(tmp_path / "t.json"))
    got = tr.launched(t, 100.0, 150.0)
    assert [e.name for e in got.device] == ["inside"]
    assert tr.busy_us(got.device) == 25.0
