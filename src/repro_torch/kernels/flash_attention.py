"""Causal / sliding-window GQA flash attention, forward and backward: the
wrappers of the hand-written Hopper kernels in ``csrc/flash_attention.cu``.

The kernels replace the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` (forward only; the
backward is new) and run on the tensor cores, as exact as fp32
arithmetic (``kernels/ref.py::flash_attention_split_plain`` emulates
their arithmetic on the CPU); the source's header says what bounds them
(operations) and what the design does about that.  Each wrapper checks
device, types, shapes, contiguity and alignment, allocates its outputs
and scratch, launches on PyTorch's current stream and raises if a launch
was refused.  They take
CUDA tensors and ``causal=True`` only: ``kernels/ops.py::flash_attention``
routes CPU tensors to the plain versions in ``kernels/ref.py``, through
the same autograd Functions.

``flash_attention_fwd.launches`` counts accepted forward launches and
``flash_attention_backward.launches`` accepted backward calls (each three
launches: rowsum(dO O), dK/dV, dQ), and nothing else, so a run can show
that its layers went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return declare(_build.load("flash_attention"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of a build of ``csrc/flash_attention.cu`` (or
    of an edited copy of it) on ``lib``; returns ``lib``."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.attn_forward_launch.argtypes = [
        vp, vp, vp, vp, vp,              # q, k, v, o, lse
        ci, ci, ci, ci, ci, ci, ci, ci,  # dtype, B, S, T, Hq, Hkv, D, window
        cf, ci, vp]                      # scale, device index, stream
    lib.attn_forward_launch.restype = ci
    lib.attn_backward_launch.argtypes = [
        vp, vp, vp, vp, vp, vp,          # q, k, v, o, lse, dout
        vp, vp, vp, vp,                  # delta (scratch), dq, dk, dv
        ci, ci, ci, ci, ci, ci, ci, ci,  # dtype, B, S, T, Hq, Hkv, D, window
        cf, ci, vp]                      # scale, device index, stream
    lib.attn_backward_launch.restype = ci
    return lib


def _check(q, k, v, rest, causal: bool, window: int, what: str
           ) -> Tuple[int, int, int, int, int, int]:
    tensors = (q, k, v, *rest)
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{what} kernel takes CUDA tensors only; use "
                         f"kernels.ops.flash_attention for CPU tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what} inputs lie on different devices")
    if not causal:
        raise ValueError(f"{what} kernel is causal only (the models' "
                         f"training path); use the plain version")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"bad ranks: q {tuple(q.shape)}, k {tuple(k.shape)}")
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if k.shape != (b, t, hkv, d) or v.shape != k.shape:
        raise ValueError(f"k/v must be [B, T, Hkv, D] matching q, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if hq % hkv:
        raise ValueError(f"Hq {hq} not a multiple of Hkv {hkv}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype in fp32/bf16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{what} kernel takes contiguous tensors")
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError(f"{what} kernel copies 16-byte chunks: every "
                         f"tensor must start 16-byte aligned")
    if window < 0 or b * s * t == 0 or b > 65535 or hq > 65535:
        raise ValueError(f"bad window {window} or shape {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    return b, s, t, hq, hkv, d


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: float = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, S, Hq, D], k/v [B, T, Hkv, D], one type (fp32/bf16).
    Returns (out [B, S, Hq, D] in q's type, lse fp32 [B, Hq, S])."""
    b, s, t, hq, hkv, d = _check(q, k, v, (), causal, window,
                                 "flash_attention_fwd")
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().attn_forward_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _DTYPE_CODE[q.dtype], b, s, t, hq, hkv, d,
        int(window), float(scale), q.device.index, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError "
                           f"{err} (D {d}, Hq {hq}, Hkv {hkv})")
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int = 0, scale: float = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The gradients (dq, dk, dv), in q's type, of the forward's output
    given its inputs, its output ``o``, its ``lse`` and the output's
    gradient ``do``."""
    b, s, t, hq, hkv, d = _check(q, k, v, (o, lse, do), causal, window,
                                 "flash_attention_backward")
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError("o and do must match q in shape and dtype")
    if lse.shape != (b, hq, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 {(b, hq, s)}")
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().attn_backward_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype], b, s, t, hq,
        hkv, d, int(window), float(scale), q.device.index, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_backward launch failed: "
                           f"cudaError {err} (D {d}, Hq {hq}, Hkv {hkv})")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_fwd.launches = 0
flash_attention_backward.launches = 0
