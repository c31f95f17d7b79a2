"""A run with the timed path broken underneath comes out not correct:
the harness's whole run on the CPU (the look for a card skipped), once
for each fault a training cell can have."""
from __future__ import annotations

import pytest

import perfbench_tiny as tiny
from perfbench.bench import faults, harness
from perfbench.bench.spec import Spec


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def run(root, cell, **kw):
    return harness.run(cell, 4242, 0.2, False, spec=Spec(root),
                       device="cpu", **kw)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
@pytest.mark.parametrize("fault", sorted(faults.WRAPS))
def test_wrapped_round_fault_is_not_correct(root, cell, fault):
    out = run(root, cell, wrap_round=faults.WRAPS[fault])
    assert not out["line"]["correct"], out["checks"]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_exchange_left_out_is_not_correct(root, cell):
    with faults.no_exchange():
        out = run(root, cell)
    assert not out["line"]["correct"], out["checks"]
    out = run(root, cell)
    assert out["line"]["correct"], out["checks"]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
@pytest.mark.parametrize("fault,number", [("dropped_residual", "ef_gap"),
                                          ("stale_ref", "ref_gap")])
def test_top_k_error_feedback_fault_is_not_correct(root, cell, fault,
                                                   number):
    with faults.PATCHES[fault]():
        out = run(root, cell)
    assert not out["line"]["correct"], out["checks"]
    c = out["checks"][number]
    assert c["value"] > 10 * c["limit"], out["checks"]


def test_non_finite_window_is_counted_failed(root):
    def nan_loss(rnd):
        def f(state, batch):
            state, m = rnd(state, batch)
            return state, dict(m, loss=m["loss"] * float("nan"))
        return f
    out = run(root, "tiny-resnet-topk", wrap_round=nan_loss)
    assert not out["line"]["correct"]
    assert out["line"]["failed"] == out["line"]["attempted"] > 0
