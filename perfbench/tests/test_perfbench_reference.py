"""The plain reference against the port's round, on the CPU at tiny
sizes, through the harness's own run (the port's kernels take their plain
versions on CPU tensors); and the import walls: nothing the harness
reaches imports JAX or the JAX package, and the reference imports
nothing of the port either."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

import perfbench_tiny as tiny
from perfbench.bench import harness
from perfbench.bench.spec import Spec

PB = tiny.REPO / "perfbench"
SRC = tiny.REPO / "src"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_reference_holds_the_port_round(root, cell):
    out = harness.run(cell, 2 ** 31 + 977, 0.2, False, spec=Spec(root),
                      device="cpu")
    nums = out["numbers"]
    assert out["line"]["correct"], out["checks"]
    # fp32 on one CPU: both sides agree to rounding
    assert nums["loss_gap"]["value"] < 1e-5
    assert nums["grad_gap"]["value"] < 1e-5
    assert nums["change_median"]["value"] < 1e-5
    assert nums["ef_gap"]["value"] < 1e-4
    assert nums["ref_gap"]["value"] < 1e-4
    assert out["line"]["attempted"] > 0 and out["line"]["failed"] == 0


def _module_file(name: str):
    """The file of a module of perfbench or repro_torch, else None."""
    parts = name.split(".")
    base = tiny.REPO if parts[0] == "perfbench" else SRC
    if parts[0] not in ("perfbench", "repro_torch"):
        return None
    p = base.joinpath(*parts)
    for cand in (p.with_suffix(".py"), p / "__init__.py"):
        if cand.exists():
            return cand
    return None


def _imports(path: Path):
    """Top-level imported module names of a file (every import
    statement, inside functions too), relative ones resolved."""
    tree = ast.parse(path.read_text())
    pkg = ".".join(path.relative_to(
        tiny.REPO if path.is_relative_to(PB) else SRC).with_suffix(
        "").parts[:-1])
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg.split(".")[:len(pkg.split(".")) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            yield mod
            for a in node.names:
                yield f"{mod}.{a.name}"


def _walk(starts):
    """Every module name reached from ``starts`` through perfbench and
    repro_torch files."""
    seen, todo, names = set(), list(starts), set()
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        for name in _imports(f):
            names.add(name)
            nxt = _module_file(name)
            if nxt is not None:
                todo.append(nxt)
    return names


def _top(names):
    return {n.split(".")[0] for n in names}


def test_harness_reaches_no_jax():
    starts = [PB / "run.py", PB / "calibrate.py"] + sorted(
        p for d in ("bench", "models", "metrics", "reference")
        for p in (PB / d).glob("*.py"))
    found = _top(_walk(starts)) & {"jax", "jaxlib", "flax", "repro"}
    assert not found, found
    # the port is reached: the walk follows it
    assert "repro_torch" in _top(_walk(starts))


def test_reference_imports_nothing_of_the_port():
    starts = sorted((PB / "reference").glob("*.py"))
    tops = _top(_walk(starts))
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, \
        tops
    assert tops <= {"__future__", "torch", "math", "dataclasses", "typing",
                    "perfbench"}, tops


def test_top_level_names_compare_whole():
    # "repro_torch" begins with "repro" and is not the JAX package
    assert "repro" not in _top(["repro_torch.core.hier_avg"])
    assert "repro" in _top(["repro.core"])
