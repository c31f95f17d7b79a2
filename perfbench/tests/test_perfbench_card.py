"""On the card (skips elsewhere): each cell's control, the reference
computed with TF32 on, comes out not correct against the cell's limits,
and so does the program with its top-k residual left out; the program's
sound run comes out correct.  All at the cell's own size.

  python -m pytest -q perfbench/tests/test_perfbench_card.py
"""
from __future__ import annotations

import pytest
import torch

import perfbench_tiny as tiny
from perfbench.bench import check, faults, harness
from perfbench.bench.spec import Spec

SPEC = Spec(tiny.REPO)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the control runs on the card")
    return "cuda"


@pytest.mark.parametrize("cell", SPEC.cells())
def test_control_fails_and_program_passes(card, cell):
    w = SPEC.cell(cell)
    cfg, traffic = SPEC.config(w["config"]), SPEC.traffic(w["traffic"])
    adapter = SPEC.model(cfg["model"])
    specs = adapter.param_specs(cfg)
    harness.set_precision(cfg["precision"])
    from repro_torch.kernels import _build
    _build.build_all(cfg.get("kernels", []) + traffic.get("kernels", []))
    limits = SPEC.limits(cell)
    seed = 2 ** 31 + 4099
    prog, mine, feed = harness.program_readings(cfg, traffic, adapter,
                                                specs, seed, card)
    del prog
    harness.free(card)
    ref = harness.reference_readings(cfg, traffic, adapter, specs, seed,
                                     feed, card)
    ok, checks = check.judge(check.numbers(mine, ref), limits)
    assert ok, checks
    ctl = harness.reference_readings(cfg, traffic, adapter, specs, seed,
                                     feed, card, tf32=True)
    ok, checks = check.judge(check.numbers(ctl, ref), limits)
    assert not ok, checks
    with faults.dropped_residual():
        prog, bad, _ = harness.program_readings(cfg, traffic, adapter,
                                                specs, seed, card)
    del prog
    harness.free(card)
    ok, checks = check.judge(check.numbers(bad, ref), limits)
    assert not ok, checks
