"""Paged flash-decode attention: the wrapper of the hand-written Hopper
kernel ``csrc/flash_decode.cu``.

The kernel replaces the Pallas TPU kernel
``repro/kernels/flash_decode.py::_decode_kernel``; the source's header says
what bounds it (bytes of visible K/V) and what its design does about that.
The wrapper checks device, types, shapes and contiguity, allocates the
output, launches on PyTorch's current stream and raises if the launch was
refused.  It takes CUDA tensors only: ``kernels/ops.py::flash_decode``
routes CPU tensors to the plain version in ``kernels/ref.py``.

The kernel is split-K: the visible keys of each (sequence, kv head) are
cut into splits of ``split_keys`` keys, one CTA each, whose fp32 partials
a second kernel combines.  :func:`split_plan` picks the split size and the
number of splits from shapes alone (no host synchronize, so the call can
be captured in a CUDA graph); it is plain Python and imports without
``nvcc``.  ``kernels/ref.py::flash_decode_split_plain`` is the same
decomposition in PyTorch.

``flash_decode.launches`` counts accepted calls (the split kernel and its
combine together, once), and nothing else, so a run can show that its
decode steps went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)
# keys per split, rounded down to whole pages (at least one); chosen by the
# sweep in chip_smoke.py's phase 3 at the serving shape (PERF.md)
SPLIT_KEYS = 256


def split_plan(maxp: int, page: int, window: int,
               split_keys: Optional[int] = None) -> Tuple[int, int]:
    """(split_keys, n_splits) for a block table of ``maxp`` pages of
    ``page`` keys: splits of ``split_keys`` keys (a multiple of the page;
    default SPLIT_KEYS in whole pages) counted from the first visible key,
    and enough of them to cover the most keys a sequence can see,
    min(window or inf, maxp * page)."""
    if split_keys is None:
        split_keys = page * max(1, SPLIT_KEYS // page)
    elif split_keys <= 0 or split_keys % page:
        raise ValueError(f"split_keys {split_keys} is not a positive "
                         f"multiple of the page size {page}")
    span = maxp * page
    if window > 0:
        span = min(span, window)
    return split_keys, max(1, -(-span // split_keys))


def visible_span(length: int, maxp: int, page: int,
                 window: int) -> Tuple[int, int]:
    """The keys [lo, hi) that a query at ``length`` sees (lo >= hi: none)."""
    lo = length - window if 0 < window < length else 0
    return lo, min(length, maxp * page)


def busy_splits(lengths: Sequence[int], maxp: int, page: int, window: int,
                split_keys: int) -> List[int]:
    """Non-empty splits per sequence: each is one busy CTA per kv head."""
    spans = (visible_span(n, maxp, page, window) for n in lengths)
    return [max(0, -(-(hi - lo) // split_keys)) for lo, hi in spans]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return declare(_build.load("flash_decode"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signature of a build of ``csrc/flash_decode.cu`` (or of
    an edited copy of it) on ``lib``; returns ``lib``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_decode_launch.argtypes = [
        vp, vp, vp, vp, vp, vp,          # q, k_pages, v_pages, tables, lengths, out
        vp, vp,                          # scratch: partial acc, partial (m, l)
        ci, ci,                          # q dtype, pool dtype
        ci, ci, ci, ci,                  # B, Hkv, G, D
        ci, ci, ci, ci,                  # P, page, maxp, window
        ctypes.c_float, ci, ci,          # scale, split_keys, n_splits
        ci, vp]                          # device index, stream
    lib.flash_decode_launch.restype = ci
    return lib


def flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, block_tables: torch.Tensor,
                 lengths: torch.Tensor, *, window: int = 0,
                 scale: Optional[float] = None,
                 split_keys: Optional[int] = None) -> torch.Tensor:
    """q [B, Hq, D] fp32/bf16; k_pages/v_pages [Hkv, P, page, D] fp32/bf16;
    block_tables [B, max_pages] int32; lengths [B] int32 incl. the query.
    ``split_keys`` (a multiple of the page) overrides split_plan's split
    size.  Returns [B, Hq, D] in q's dtype."""
    tensors = (q, k_pages, v_pages, block_tables, lengths)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("flash_decode kernel takes CUDA tensors only; "
                         "use kernels.ops.flash_decode for CPU tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("flash_decode inputs lie on different devices")
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"bad ranks: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}")
    b, hq, d = q.shape
    hkv, n_pages, page, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages differ in shape or dtype")
    if dk != d or d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} (pool {dk}) not in {HEAD_DIMS}")
    if hq % hkv:
        raise ValueError(f"Hq {hq} not a multiple of Hkv {hkv}")
    if q.dtype not in _DTYPE_CODE or k_pages.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtypes q {q.dtype}, pool "
                         f"{k_pages.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_tables and lengths must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError(f"bad table/length shapes "
                         f"{tuple(block_tables.shape)}, {tuple(lengths.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode kernel takes contiguous tensors")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("the pool must be 16-byte aligned (16-byte loads)")
    g = hq // hkv
    maxp = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    split_keys, n_splits = split_plan(maxp, page, int(window), split_keys)
    out = torch.empty_like(q)
    if b == 0:
        return out
    part_acc = torch.empty((b, hkv, n_splits, g, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, hkv, n_splits, g, 2), dtype=torch.float32,
                          device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_decode_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(),
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype],
        b, hkv, g, d, n_pages, page, maxp, int(window),
        float(scale), split_keys, n_splits, q.device.index, stream)
    if err != 0:
        # 1 (cudaErrorInvalidValue) also refuses a group G * D > 4096
        raise RuntimeError(f"flash_decode launch failed: cudaError {err} "
                           f"(G {g}, D {d}, {n_splits} splits of "
                           f"{split_keys} keys)")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
