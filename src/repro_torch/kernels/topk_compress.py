"""Exact per-row magnitude top-k: the wrapper of the hand-written Hopper
kernel ``csrc/topk_compress.cu``.

The kernel replaces the Pallas TPU kernel
``repro/kernels/topk_compress.py::topk_compress``; the source's header says
what bounds it (bytes of x), how many times it reads x and how many
launches a call makes.  One call serves many segments (the leaves or
buckets of a fire): :func:`topk_compress_many`.  The wrapper checks device,
type, shape and contiguity, allocates the outputs and the scratch, lets the
library plan the call on the host, uploads the segment table through
pinned memory, launches on PyTorch's current stream and raises if a launch
was refused.  It takes CUDA tensors only: ``kernels/ops.py`` routes CPU
tensors to the plain version in ``kernels/ref.py``.

``topk_compress.launches`` counts the segments served by the kernel (and
nothing else), so a run can show that its global reductions went through
it; ``topk_compress.calls`` counts the grouped calls.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the segment table's int64 fields (csrc/topk_compress.cu, F_*): the caller
# sets x, vals, idx, rows, n, k and cap (-1: the kernel's default)
_SEG_FIELDS = 16
_F_CAP = 13


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entry points' argument types on a build of the source."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.topk_compress_plan.argtypes = [vp, ci, vp]   # table, nseg, totals
    lib.topk_compress_plan.restype = ctypes.c_longlong
    lib.topk_compress_run.argtypes = [
        vp, vp, ci, vp,                  # device table, totals, nseg, scratch
        ci, ci, vp]                      # dtype, device index, stream
    lib.topk_compress_run.restype = ci
    lib.topk_compress_totals.argtypes = []
    lib.topk_compress_totals.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return declare(_build.load("topk_compress"))


def _check(xs: Sequence[torch.Tensor], ks: Sequence[int]) -> None:
    if len(xs) != len(ks) or not xs:
        raise ValueError(f"need one k per x and at least one x, got "
                         f"{len(xs)} and {len(ks)}")
    if not all(x.is_cuda for x in xs):
        raise ValueError("topk_compress kernel takes CUDA tensors only; "
                         "use kernels.ops.topk_compress for CPU tensors")
    if len({x.device for x in xs}) != 1:
        raise ValueError("topk_compress inputs lie on different devices")
    if len({x.dtype for x in xs}) != 1 or xs[0].dtype not in _DTYPE_CODE:
        raise ValueError(f"all x must share one dtype of {list(_DTYPE_CODE)}, "
                         f"got {sorted({str(x.dtype) for x in xs})}")
    for x, k in zip(xs, ks):
        if x.dim() != 2:
            raise ValueError(f"x must be [rows, n], got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError("topk_compress kernel takes a contiguous x")
        rows, n = x.shape
        if not 1 <= k <= n:
            raise ValueError(f"need 1 <= k <= n, got k={k}, n={n}")
        if not 1 <= rows <= 65535 or n >= 2 ** 31:
            raise ValueError(f"rows {rows} must be in [1, 65535] and n {n} "
                             f"below 2**31")


def topk_compress_many(xs: Sequence[torch.Tensor], ks: Sequence[int], *,
                       candidate_cap: Optional[int] = None
                       ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each x [rows, n] fp32/bf16 (all of one dtype) with its k -> (values
    [rows, k] in x's dtype, indices [rows, k] int32 ascending per row), in
    one call; ties at the k-th magnitude go to the lowest indices.

    ``candidate_cap`` overrides the kernel's candidate buffer per large row
    (n >> CAP_SHIFT keys); 0 forces every large row down the path that
    re-reads x instead (for tests)."""
    xs, ks = list(xs), [int(k) for k in ks]
    _check(xs, ks)
    lib = _lib()
    dev = xs[0].device
    outs = [(torch.empty((x.shape[0], k), dtype=x.dtype, device=dev),
             torch.empty((x.shape[0], k), dtype=torch.int32, device=dev))
            for x, k in zip(xs, ks)]
    cap = -1 if candidate_cap is None else int(candidate_cap)
    table = torch.zeros((len(xs), _SEG_FIELDS), dtype=torch.int64)
    table[:, :6] = torch.tensor(
        [[x.data_ptr(), v.data_ptr(), i.data_ptr(), x.shape[0], x.shape[1],
          k] for x, k, (v, i) in zip(xs, ks, outs)], dtype=torch.int64)
    table[:, _F_CAP] = cap
    table = table.pin_memory()
    totals = torch.zeros(lib.topk_compress_totals(), dtype=torch.int64)
    nbytes = lib.topk_compress_plan(table.data_ptr(), len(xs),
                                    totals.data_ptr())
    if nbytes < 0:
        raise ValueError("topk_compress: the call's grid is too large")
    dev_table = torch.empty_like(table, device=dev)
    dev_table.copy_(table, non_blocking=True)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.topk_compress_run(
        dev_table.data_ptr(), totals.data_ptr(), len(xs), scratch.data_ptr(),
        _DTYPE_CODE[xs[0].dtype], dev.index, stream)
    if err != 0:
        raise RuntimeError(f"topk_compress launch failed: cudaError {err} "
                           f"({len(xs)} segments)")
    topk_compress.launches += len(xs)
    topk_compress.calls += 1
    return outs


def topk_compress(x: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [rows, n] fp32/bf16 -> (values [rows, k] in x's dtype, indices
    [rows, k] int32 ascending per row); ties at the k-th magnitude go to
    the lowest indices.  A one-segment :func:`topk_compress_many`."""
    return topk_compress_many([x], [k])[0]


topk_compress.launches = 0
topk_compress.calls = 0
