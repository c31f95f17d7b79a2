"""Fused per-block int8 quantize + pack and its inverse: the wrappers of
the hand-written Hopper kernels ``csrc/qint8_pack.cu``.

The kernels replace the Pallas TPU kernels
``repro/kernels/qint8_pack.py::qint8_pack`` and ``::qint8_unpack``; the
source's header says what bounds them (bytes) and what their design does
about that.  Each wrapper checks device, type, shape and contiguity,
allocates the output, launches on PyTorch's current stream and raises if
the launch was refused.  They take CUDA tensors only:
``kernels/ops.py::qint8_pack`` / ``qint8_unpack`` route CPU tensors to the
plain versions in ``kernels/ref.py``.

``qint8_pack.launches`` and ``qint8_unpack.launches`` count accepted
calls (and nothing else), so a run can show that its qint8 reductions
went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import QINT8_SCALE_BYTES

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("qint8_pack")
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.qint8_pack_launch.argtypes = [vp, vp, ci, cll, cll, ci, ci, vp]
    lib.qint8_pack_launch.restype = ci
    lib.qint8_unpack_launch.argtypes = [vp, vp, cll, cll, ci, ci, vp]
    lib.qint8_unpack_launch.restype = ci
    return lib


def _check_block(block: int) -> int:
    block = int(block)
    if block < 1:
        raise ValueError(f"qint8 block must be >= 1, got {block}")
    return block


def qint8_pack(x: torch.Tensor, block: int) -> torch.Tensor:
    """x [rows, n] fp32/bf16 -> int8 wire [rows, ceil(n / block),
    block + 4]: per block the int8 payload, then its fp32 scale's bytes."""
    if not x.is_cuda:
        raise ValueError("qint8_pack kernel takes CUDA tensors only; use "
                         "kernels.ops.qint8_pack for CPU tensors")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be a non-empty [rows, n], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("qint8_pack kernel takes a contiguous x")
    block = _check_block(block)
    rows, n = x.shape
    nb = -(-n // block)
    wire = torch.empty((rows, nb, block + QINT8_SCALE_BYTES),
                       dtype=torch.int8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().qint8_pack_launch(x.data_ptr(), wire.data_ptr(),
                                   _DTYPE_CODE[x.dtype], rows, n, block,
                                   x.device.index, stream)
    if err != 0:
        raise RuntimeError(f"qint8_pack launch failed: cudaError {err} "
                           f"(rows {rows}, n {n}, block {block})")
    qint8_pack.launches += 1
    return wire


def qint8_unpack(wire: torch.Tensor, n: int) -> torch.Tensor:
    """int8 wire [rows, nb, block + 4] -> fp32 [rows, n], the exact
    inverse of :func:`qint8_pack` (``nb`` must be ``ceil(n / block)``)."""
    if not wire.is_cuda:
        raise ValueError("qint8_unpack kernel takes CUDA tensors only; use "
                         "kernels.ops.qint8_unpack for CPU tensors")
    if wire.dim() != 3 or wire.dtype != torch.int8:
        raise ValueError(f"wire must be int8 [rows, nb, block + 4], got "
                         f"{wire.dtype} {tuple(wire.shape)}")
    if not wire.is_contiguous() or wire.data_ptr() % 4:
        raise ValueError("qint8_unpack kernel takes a contiguous wire "
                         "starting on a 4-byte boundary")
    rows, nb, width = wire.shape
    block = _check_block(width - QINT8_SCALE_BYTES)
    n = int(n)
    if rows < 1 or n < 1 or -(-n // block) != nb:
        raise ValueError(f"wire {tuple(wire.shape)} does not hold n={n} "
                         f"columns in blocks of {block}")
    out = torch.empty((rows, n), dtype=torch.float32, device=wire.device)
    stream = torch.cuda.current_stream(wire.device).cuda_stream
    err = _lib().qint8_unpack_launch(wire.data_ptr(), out.data_ptr(), rows,
                                     n, block, wire.device.index, stream)
    if err != 0:
        raise RuntimeError(f"qint8_unpack launch failed: cudaError {err} "
                           f"(rows {rows}, n {n}, block {block})")
    qint8_unpack.launches += 1
    return out


qint8_pack.launches = 0
qint8_unpack.launches = 0
