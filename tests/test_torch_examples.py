"""The port's examples (``repro_torch/examples``) on the CPU: each runs to
the end and passes its own asserts, ``topology_demo`` prints the
reference script's tables line for line, ``train_lm`` counts the
reference's parameters and writes its checkpoint format, and every
example refuses the card's default without CUDA.  Each runs in this
process on one thread."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.examples import (quickstart, serve_batch,  # noqa: E402
                                  topology_demo, train_lm)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_topology_demo_equals_reference(capsys, monkeypatch):
    monkeypatch.delenv("REPRO_CALIBRATION", raising=False)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("REPRO_CALIBRATION", None)
    ref = subprocess.run([sys.executable, "examples/topology_demo.py"],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert ref.returncode == 0, ref.stderr[-2000:]
    topology_demo.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    want = ref.stdout.splitlines()
    assert len(got) == len(want) > 40
    for a, b in zip(got, want):
        assert a == b


def test_quickstart_runs(one_thread, capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "OK: loss decreased under hierarchical averaging." in out


@pytest.mark.parametrize("preset", sorted(train_lm.PRESETS))
def test_train_lm_counts_the_references_params(preset):
    from repro.configs.base import ArchConfig, ParallelLayout
    from repro.models import build as ref_build
    from repro.models.common import count_params as ref_count
    from repro_torch.core.simulator import init_template
    from repro_torch.models import build
    from repro_torch.models.common import count_params
    cfg = train_lm.preset_config(preset)
    ref_cfg = ArchConfig(name=f"lm-{preset}", family="dense",
                         source="examples/train_lm.py",
                         layout=ParallelLayout(1, 1, 1, 1),
                         **train_lm.PRESETS[preset])
    want = ref_count(jax.eval_shape(ref_build(ref_cfg).init,
                                    jax.random.PRNGKey(0)))
    got = count_params(init_template(build(cfg, device="cpu").init_train,
                                     "cpu"))
    assert got == want


def test_train_lm_runs(one_thread, tmp_path, capsys):
    """16 steps (2 rounds) at 32 tokens a sequence (the example's own
    asserts: finite eval losses, the last below the first); its
    checkpoint loads through the reference's reader."""
    from repro.checkpoint import load_checkpoint as ref_load
    ckpt = str(tmp_path / "ckpt")
    train_lm.main(["--steps", "16", "--seq", "32", "--device", "cpu",
                   "--ckpt", ckpt])
    out = capsys.readouterr().out
    assert out.startswith("model: 10.0M params")
    arrays = ref_load(ckpt)
    assert "embed" in arrays and np.all(np.isfinite(arrays["embed"]))


def test_serve_batch_runs(one_thread, capsys):
    serve_batch.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 6 text requests" in out
    assert "paged: served 6 requests" in out
    assert "dense engine: " in out and "prefill chunk calls" in out


@pytest.mark.parametrize("example", [quickstart, train_lm, serve_batch,
                                     topology_demo])
def test_examples_refuse_without_cuda(example):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(SystemExit, match="--device cpu"):
        example.main([])
