"""Dispatch for the port's kernels (counterpart of
``repro/kernels/ops.py``).

``impl``:
  * "auto"   — the CUDA kernel for CUDA tensors, the plain version
               (kernels/ref.py) for CPU tensors
  * "kernel" — the CUDA kernel; raises on CPU tensors
  * "plain"  — the plain PyTorch version on any device; taken only when
               asked for (tests, and chip_smoke.py's comparisons)

A CUDA tensor never falls back to the plain version: the kernel launches
or the call raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref as kref

IMPLS = ("auto", "kernel", "plain")


def _resolve(impl: str, t: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if impl == "auto":
        return "kernel" if t.is_cuda else "plain"
    return impl


def flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, block_tables: torch.Tensor,
                 lengths: torch.Tensor, *, window: int = 0,
                 scale: Optional[float] = None,
                 impl: str = "auto") -> torch.Tensor:
    """Paged decode attention (the serving hot path).

    q [B, Hq, D], one query token per sequence; k_pages/v_pages
    [Hkv, P, page, D], the paged pool; block_tables [B, max_pages] int32;
    lengths [B] int32, valid tokens per sequence incl. the query.  The
    kernel's launch count is ``kernels.flash_decode.flash_decode.launches``.
    """
    if _resolve(impl, q) == "plain":
        return kref.flash_decode_plain(q, k_pages, v_pages, block_tables,
                                       lengths, window=window, scale=scale)
    from repro_torch.kernels.flash_decode import flash_decode as fd
    return fd(q, k_pages, v_pages, block_tables, lengths, window=window,
              scale=scale)


def topk_compress(x: torch.Tensor, k: int, *, impl: str = "auto"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact per-row magnitude top-k (the sparse reducer's compress step).

    x [rows, n] fp32/bf16 -> (values [rows, k] in x's dtype, indices
    [rows, k] int32, ascending per row); ties at the k-th magnitude go to
    the lowest indices.  The kernel's launch count is
    ``kernels.topk_compress.topk_compress.launches``.
    """
    if _resolve(impl, x) == "plain":
        return kref.topk_compress_plain(x, k)
    from repro_torch.kernels.topk_compress import topk_compress as tk
    return tk(x, k)


def qint8_pack(x: torch.Tensor, block: int, *,
               impl: str = "auto") -> torch.Tensor:
    """Fused per-block int8 quantize + pack (the qint8 codec's compress).

    x [rows, n] fp32/bf16 -> int8 wire [rows, ceil(n / block), block + 4]:
    per block the payload, then the fp32 scale's four bytes.  Bit-identical
    across impls.  The kernel's launch count is
    ``kernels.qint8_pack.qint8_pack.launches``.
    """
    if _resolve(impl, x) == "plain":
        return kref.qint8_pack_plain(x, block)
    from repro_torch.kernels.qint8_pack import qint8_pack as qp
    return qp(x, block)


def qint8_unpack(wire: torch.Tensor, n: int, *,
                 impl: str = "auto") -> torch.Tensor:
    """Inverse of :func:`qint8_pack`: int8 [rows, nb, block + 4] -> fp32
    [rows, n].  The kernel's launch count is
    ``kernels.qint8_pack.qint8_unpack.launches``."""
    if _resolve(impl, wire) == "plain":
        return kref.qint8_unpack_plain(wire, n)
    from repro_torch.kernels.qint8_pack import qint8_unpack as qu
    return qu(wire, n)


def batched_qr(p: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """CGS2 thin-QR Q factor of tall panels: [..., a, r] -> [..., a, r]
    (PowerSGD's orthonormalization); a rank-deficient column comes back
    as zeros.  The kernel's launch count is
    ``kernels.batched_qr.batched_qr.launches``."""
    if _resolve(impl, p) == "plain":
        return kref.batched_qr_plain(p)
    from repro_torch.kernels.batched_qr import batched_qr as bqr
    return bqr(p)
