"""Batched thin-QR Q factor (CGS2): the wrapper of the hand-written Hopper
kernel ``csrc/batched_qr.cu``.

The kernel replaces the Pallas TPU kernel
``repro/kernels/batched_qr.py::batched_qr``; the source's header says what
bounds it (launch latency at the trainer's shapes) and what its design
does.  The wrapper checks device, shape and contiguity, allocates the
output, launches on PyTorch's current stream and raises if the launch was
refused.  It takes CUDA tensors only: ``kernels/ops.py::batched_qr``
routes CPU tensors to the plain version in ``kernels/ref.py``.

``batched_qr.launches`` counts accepted calls (and nothing else).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_RANK = 32


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("batched_qr")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.batched_qr_launch.argtypes = [vp, vp, ci, ci, ci, ci, vp]
    lib.batched_qr_launch.restype = ci
    return lib


def batched_qr(p: torch.Tensor) -> torch.Tensor:
    """[..., a, r] -> Q [..., a, r] in p's dtype (computed in fp32), with
    a >= r and r <= 32; a rank-deficient column comes back zero."""
    if not p.is_cuda:
        raise ValueError("batched_qr kernel takes CUDA tensors only; use "
                         "kernels.ops.batched_qr for CPU tensors")
    if p.dim() < 2:
        raise ValueError(f"p must be [..., a, r], got {tuple(p.shape)}")
    *lead, a, r = p.shape
    if a < r:
        raise ValueError(
            f"batched_qr needs a tall panel (a >= r), got {tuple(p.shape)}")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"batched_qr kernel takes 1 <= r <= {MAX_RANK}, "
                         f"got r={r}")
    batch = 1
    for d in lead:
        batch *= d
    if batch < 1 or batch >= 2 ** 31 or a * r >= 2 ** 31:
        raise ValueError(f"unsupported panel batch {tuple(p.shape)}")
    x = p.float().contiguous()
    q = torch.empty_like(x)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    err = _lib().batched_qr_launch(x.data_ptr(), q.data_ptr(), batch, a, r,
                                   p.device.index, stream)
    if err != 0:
        raise RuntimeError(f"batched_qr launch failed: cudaError {err} "
                           f"(batch {batch}, a {a}, r {r})")
    batched_qr.launches += 1
    return q.to(p.dtype)


batched_qr.launches = 0
