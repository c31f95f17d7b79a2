"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and importing them builds nothing."""
import os
import pkgutil
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\.|from\s+repro\.|"
    r"import\s+repro\s*$|from\s+repro\s+import)", re.M)


def _port_sources():
    for dirpath, _, files in os.walk(SRC):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _modules():
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch
        return sorted(m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch."))
    finally:
        sys.path.pop(0)


def test_importing_every_module_leaves_jax_out():
    mods = _modules()
    for m in ("kernels.flash_decode", "kernels.topk_compress",
              "kernels.qint8_pack", "kernels.batched_qr", "tree",
              "core.topology", "core.plan", "core.hier_avg",
              "core.baselines", "core.simulator", "comm.reducer",
              "comm.sparse", "comm.quant", "comm.lowrank", "comm.bucket",
              "optim.optimizers", "optim.schedules", "optim.clip",
              "data.synthetic", "models.resnet", "kernels.rwkv6_wkv",
              "kernels.flash_attention", "models.rwkv6", "models.stubs",
              "data.loader", "launch.train", "models.moe",
              "models.attention", "models.common", "models.transformer",
              "parallel.sharding", "parallel.collectives", "launch.mesh",
              "testing", "checkpoint.checkpoint", "data.loader",
              "autotune", "autotune.calibrate", "autotune.probe",
              "autotune.search", "autotune.controller",
              "launch.analytic", "models.mamba", "models.hybrid",
              "models.encdec"):
        assert f"repro_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build.BUILD_LOG\n"
        "print('ok', len(sys.argv))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_does_not_import_jax_or_repro(path):
    assert os.path.exists(path), path
    with open(path) as f:
        text = f.read()
    hit = FORBIDDEN.search(text)
    assert hit is None, f"{path}: {hit.group(0)!r}"


def test_every_kernel_source_is_built_by_the_chip_smoke():
    """Each csrc/*.cu has a wrapper module and is in chip_smoke.SOURCES,
    which phase 2 builds (one nvcc each, all at once)."""
    import ast
    csrc = os.path.join(SRC, "kernels", "csrc")
    found = sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))
    for name in ("flash_decode", "topk_compress", "qint8_pack",
                 "batched_qr", "rwkv6_wkv", "flash_attention"):
        assert name in found, name
        assert os.path.exists(os.path.join(SRC, "kernels", f"{name}.py"))
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    sources = [ast.literal_eval(node.value) for node in tree.body
               if isinstance(node, ast.Assign)
               and any(getattr(t, "id", None) == "SOURCES"
                       for t in node.targets)]
    assert sources and sorted(sources[0]) == found
