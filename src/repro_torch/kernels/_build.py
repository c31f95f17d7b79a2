"""Build the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
plain-C shared library (no PyTorch headers, so a build takes seconds) and
loaded with ``ctypes``.  The library lands in ``kernels/build/`` (listed in
``.gitignore``) under a name keyed by a hash of the source and the flags,
so an edited source is rebuilt and an unchanged one is reused.  Nothing
here runs at import: the CPU tests import every module without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# per-process record of what was built: name -> (seconds, nvcc log)
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's "
        "CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives for the current source."""
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its keyed build exists; returns
    the library path.  Raises with nvcc's output if the build fails."""
    return build_all([name])[name]


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every ``csrc/<name>.cu`` of ``names`` that has no keyed
    build yet, one nvcc process per source, all started together; returns
    each library's path.  Raises with nvcc's output if a build fails."""
    paths = {name: library_path(name) for name in names}
    jobs = {name: (CSRC / f"{name}.cu", out) for name, out in paths.items()
            if not out.exists()}
    BUILD_LOG.update(_compile(jobs, "csrc/{}.cu"))
    return paths


def build_variants(sources: Dict[str, str], out_dir: Path, stem: str
                   ) -> Dict[str, ctypes.CDLL]:
    """Compile edited copies of a source: each name's text is written to
    ``out_dir/<stem>_<name>.cu`` and built, all in parallel, with the
    kernels' flags (nvcc's log in ``BUILD_LOG["<stem>_<name>"]``); returns
    each name's loaded library.  For the study scripts that time variants
    of a kernel (``scripts/*_variants.py``)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in sources.items():
        cu = out_dir / f"{stem}_{name}.cu"
        cu.write_text(text)
        jobs[name] = (cu, out_dir / f"lib{stem}_{name}.so")
    BUILD_LOG.update({f"{stem}_{name}": log for name, log in
                      _compile(jobs, "variant {}").items()})
    return {name: ctypes.CDLL(str(out)) for name, (_, out) in jobs.items()}


def _compile(jobs: Dict[str, Tuple[Path, Path]], what: str
             ) -> Dict[str, Tuple[float, str]]:
    """Run nvcc on each job's (source, library) at once; returns name ->
    (seconds, nvcc log).  Each library is written under a private name
    and renamed into place, so concurrent processes never load a
    half-written one.  Raises with nvcc's output if a build fails."""
    started = {}
    logs = {}
    try:
        for name, (src, out) in jobs.items():
            out.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            started[name] = (tmp, time.perf_counter(), proc)
        for name, (tmp, t0, proc) in started.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {what.format(name)} (exit "
                    f"{proc.returncode}):\n{log}")
            os.replace(tmp, jobs[name][1])
            logs[name] = (time.perf_counter() - t0, log)
    finally:
        for tmp, _, proc in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return logs


def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))
