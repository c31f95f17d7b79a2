"""Exact per-row magnitude top-k: the wrapper of the hand-written Hopper
kernel ``csrc/topk_compress.cu``.

The kernel replaces the Pallas TPU kernel
``repro/kernels/topk_compress.py::topk_compress``; the source's header says
what bounds it (bytes of x) and what its design does about that.  The
wrapper checks device, type, shape and contiguity, allocates the outputs
and the zeroed scratch, launches on PyTorch's current stream and raises if
a launch was refused.  It takes CUDA tensors only:
``kernels/ops.py::topk_compress`` routes CPU tensors to the plain version
in ``kernels/ref.py``.

``topk_compress.launches`` counts accepted calls (and nothing else), so a
run can show that its global reductions went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("topk_compress")
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.topk_compress_scratch_ints.argtypes = [ci, cll]
    lib.topk_compress_scratch_ints.restype = cll
    lib.topk_compress_launch.argtypes = [
        vp, vp, vp, vp,                  # x, vals, idx, scratch
        ci, ci, cll, ci,                 # dtype, rows, n, k
        ci, vp]                          # device index, stream
    lib.topk_compress_launch.restype = ci
    return lib


def topk_compress(x: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [rows, n] fp32/bf16 -> (values [rows, k] in x's dtype, indices
    [rows, k] int32 ascending per row); ties at the k-th magnitude go to
    the lowest indices."""
    if not x.is_cuda:
        raise ValueError("topk_compress kernel takes CUDA tensors only; "
                         "use kernels.ops.topk_compress for CPU tensors")
    if x.dim() != 2:
        raise ValueError(f"x must be [rows, n], got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("topk_compress kernel takes a contiguous x")
    rows, n = x.shape
    k = int(k)
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n, got k={k}, n={n}")
    if not 1 <= rows <= 65535 or n >= 2 ** 31:
        raise ValueError(f"rows {rows} must be in [1, 65535] and n {n} "
                         f"below 2**31")
    lib = _lib()
    vals = torch.empty((rows, k), dtype=x.dtype, device=x.device)
    idx = torch.empty((rows, k), dtype=torch.int32, device=x.device)
    scratch = torch.zeros(lib.topk_compress_scratch_ints(rows, n),
                          dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.topk_compress_launch(
        x.data_ptr(), vals.data_ptr(), idx.data_ptr(), scratch.data_ptr(),
        _DTYPE_CODE[x.dtype], rows, n, k, x.device.index, stream)
    if err != 0:
        raise RuntimeError(f"topk_compress launch failed: cudaError {err} "
                           f"(rows {rows}, n {n}, k {k})")
    topk_compress.launches += 1
    return vals, idx


topk_compress.launches = 0
