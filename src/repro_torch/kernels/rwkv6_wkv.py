"""The RWKV-6 WKV recurrence, forward and backward: the wrappers of the
hand-written Hopper kernels in ``csrc/rwkv6_wkv.cu``.

The kernels replace the Pallas TPU kernel
``repro/kernels/rwkv6_wkv.py::rwkv6_wkv`` (forward only; the backward is
new); the source's header says what bounds them (both are bound by
issuing their fp32 operations) and what the designs do about that: the
forward spreads a (b, h)'s state over 8 x 4 tiles of one CTA, sums y's
row-group partials in a fixed order once per stage, computes the
bonus term once per step and stages its inputs by asynchronous copies;
the backward splits a (b, h)'s state rows over a thread-block cluster and
recomputes its states on chip from the forward's checkpoints, with no
scratch in device memory (``kernels/ref.py::
rwkv6_wkv_forward_blocked_plain`` and ``rwkv6_wkv_backward_blocked_plain``
run their schedules in plain PyTorch).  Each wrapper checks device,
types, shapes, contiguity and 16-byte alignment (for the kernels' vector
loads and copies), allocates its outputs, launches on PyTorch's current
stream and raises if the launch was refused.  They take CUDA tensors
only: ``kernels/ops.py::rwkv6_wkv`` routes CPU tensors to the plain
versions in ``kernels/ref.py``, through the same autograd Functions.

``rwkv6_wkv_forward.launches`` and ``rwkv6_wkv_backward.launches`` count
accepted launches (and nothing else), so a run can show that its layers
went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import WKV_CHUNK

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entry points' argument types on a build of the source."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_forward_launch.argtypes = [
        vp, vp, vp, vp, vp, vp,          # r, k, v, w, u, s0
        vp, vp, vp,                      # y, sT, ckpt
        ci, ci, ci, ci, ci,              # dtype, B, S, H, D
        ci, vp]                          # device index, stream
    lib.wkv6_forward_launch.restype = ci
    lib.wkv6_backward_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp,  # r, k, v, w, u, ckpt, dy, dsT
        vp, vp, vp, vp, vp, vp,          # dr, dk, dv, dw, du, ds0
        ci, ci, ci, ci, ci,              # dtype, B, S, H, D
        ci, vp]                          # device index, stream
    lib.wkv6_backward_launch.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return declare(_build.load("rwkv6_wkv"))


def _check(seq, u, states, what: str) -> Tuple[int, int, int, int]:
    tensors = (*seq, u, *states)
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{what} kernel takes CUDA tensors only; use "
                         f"kernels.ops.rwkv6_wkv for CPU tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what} inputs lie on different devices")
    r = seq[0]
    if r.dim() != 4:
        raise ValueError(f"r must be [B, S, H, D], got {tuple(r.shape)}")
    b, s, h, d = r.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d} not in {HEAD_DIMS}")
    if r.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {r.dtype}")
    if any(t.shape != r.shape or t.dtype != r.dtype for t in seq):
        raise ValueError("r, k, v, w (and dy) must share shape and dtype")
    if u.shape != (b, h, d) or u.dtype != torch.float32:
        raise ValueError(f"u must be fp32 [B, H, D] = {(b, h, d)}, got "
                         f"{u.dtype} {tuple(u.shape)}")
    if any(t.dtype != torch.float32 for t in states):
        raise ValueError("states must be fp32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} kernel takes contiguous tensors")
    if s == 0 or b * h == 0:
        raise ValueError(f"empty input {tuple(r.shape)}")
    return b, s, h, d


def rwkv6_wkv_forward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """r/k/v/w [B, S, H, D] fp32/bf16 (one type); u fp32 [B, H, D]; s0
    fp32 [B, H, D, D].  One launch of a CTA of D^2 / 32 threads per
    (b, h), its inputs staged by 16-byte asynchronous copies.  Returns
    (y [B, S, H, D] in r's type, sT fp32 [B, H, D, D], the checkpoints
    fp32 [B, H, ceil(S / 64), D, D]: the state before every 64th step,
    bit for bit the first port's, as is sT)."""
    b, s, h, d = _check((r, k, v, w), u, (s0,), "rwkv6_wkv_forward")
    if s0.shape != (b, h, d, d):
        raise ValueError(f"s0 must be {(b, h, d, d)}, got {tuple(s0.shape)}")
    if any(t.data_ptr() % 16 for t in (r, k, v, w, u, s0)):
        raise ValueError("rwkv6_wkv_forward kernel takes tensors aligned "
                         "to 16 bytes")
    nc = -(-s // WKV_CHUNK)
    y = torch.empty_like(r)
    sT = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    ckpt = torch.empty((b, h, nc, d, d), dtype=torch.float32,
                       device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _lib().wkv6_forward_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr(),
        ckpt.data_ptr(), _DTYPE_CODE[r.dtype], b, s, h, d, r.device.index,
        stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_wkv_forward launch failed: cudaError "
                           f"{err} (B {b}, S {s}, H {h}, D {d})")
    rwkv6_wkv_forward.launches += 1
    return y, sT, ckpt


def rwkv6_wkv_backward(r, k, v, w, u, ckpt, dy, dsT):
    """The gradients of (y, sT) given the forward's inputs, its
    checkpoints and dy, dsT, in one launch of a cluster of D / 16 CTAs
    per (b, h) that needs no scratch.  Returns (dr, dk, dv, dw in r's
    type, du fp32 [B, H, D] per batch row, ds0 fp32 [B, H, D, D])."""
    b, s, h, d = _check((r, k, v, w, dy), u, (ckpt, dsT),
                        "rwkv6_wkv_backward")
    nc = -(-s // WKV_CHUNK)
    if ckpt.shape != (b, h, nc, d, d) or dsT.shape != (b, h, d, d):
        raise ValueError(f"bad ckpt {tuple(ckpt.shape)} or dsT "
                         f"{tuple(dsT.shape)}")
    if any(t.data_ptr() % 16 for t in (r, k, v, w, dy, ckpt, dsT)):
        raise ValueError("rwkv6_wkv_backward kernel takes tensors aligned "
                         "to 16 bytes")
    grads = [torch.empty_like(r) for _ in range(4)]
    du = torch.empty((b, h, d), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _lib().wkv6_backward_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), ckpt.data_ptr(), dy.data_ptr(), dsT.data_ptr(),
        *(g.data_ptr() for g in grads), du.data_ptr(), ds0.data_ptr(),
        _DTYPE_CODE[r.dtype], b, s, h, d,
        r.device.index, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_wkv_backward launch failed: cudaError "
                           f"{err} (B {b}, S {s}, H {h}, D {d})")
    rwkv6_wkv_backward.launches += 1
    return (*grads, du, ds0)


rwkv6_wkv_forward.launches = 0
rwkv6_wkv_backward.launches = 0
