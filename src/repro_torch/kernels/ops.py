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

from typing import List, Optional, Sequence, Tuple

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


def topk_compress_many(xs: Sequence[torch.Tensor], ks: Sequence[int], *,
                       impl: str = "auto"
                       ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """:func:`topk_compress` of each (x, k), in one kernel call for CUDA
    tensors (all of one dtype).  The plain version calls
    :func:`topk_compress` on each in turn.  The kernel counts a launch per
    segment in ``kernels.topk_compress.topk_compress.launches`` and the
    grouped calls in ``.calls``."""
    xs, ks = list(xs), [int(k) for k in ks]
    if len(xs) != len(ks):
        raise ValueError(f"need one k per x, got {len(xs)} and {len(ks)}")
    if not xs:
        return []
    if _resolve(impl, xs[0]) == "plain":
        return [topk_compress(x, k, impl="plain") for x, k in zip(xs, ks)]
    from repro_torch.kernels.topk_compress import topk_compress_many as tkm
    return tkm(xs, ks)


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


def batched_qr_many(ps: Sequence[torch.Tensor], *, impl: str = "auto"
                    ) -> List[torch.Tensor]:
    """:func:`batched_qr` of each p, in one kernel call for CUDA tensors.
    The plain version calls :func:`batched_qr` on each in turn.  The
    kernel counts a launch per segment in
    ``kernels.batched_qr.batched_qr.launches`` and the grouped calls in
    ``.calls``; a panel's Q is the same bits alone or in a group."""
    ps = list(ps)
    if not ps:
        return []
    if _resolve(impl, ps[0]) == "plain":
        return [batched_qr(p, impl="plain") for p in ps]
    from repro_torch.kernels.batched_qr import batched_qr_many as bqm
    return bqm(ps)


# --------------------------------------------------------------------- #
# differentiable kernels: attention and WKV6, forward and backward
#
# Each is a pair of autograd Functions: the forward, whose backward calls
# the second (the backward kernel).  Both have a ``vmap`` rule that moves
# the vmapped dim to the front and folds it into the batch dim, so the
# trainer's ``vmap(grad(loss))`` over learners launches one kernel for
# all learners.  The backward is a Function of its own, not a raw call,
# because under ``grad`` the tensors that reach ``backward`` are batched
# wrappers without storage: only a Function's vmap rule unwraps them.
# Residual outputs (log-sum-exp, state checkpoints) are not
# differentiable.  Under ``plain`` both run the plain versions of
# kernels/ref.py through the same Functions and rules.


def _fold(info, in_dims, args):
    """Move each tensor's vmapped dim to the front (broadcasting
    unbatched ones) and fold it into the next dim."""
    n = info.batch_size
    out = []
    for a, d in zip(args, in_dims):
        if isinstance(a, torch.Tensor):
            a = a.expand(n, *a.shape) if d is None else a.movedim(d, 0)
            a = a.reshape((n * a.shape[1],) + tuple(a.shape[2:]))
        out.append(a)
    return out


def _unfold(n, outs):
    return tuple(o.reshape((n, o.shape[0] // n) + tuple(o.shape[1:]))
                 for o in outs)


class _AttentionBackward(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, o, lse, do, causal, window, scale, impl):
        if impl == "plain":
            return kref.flash_attention_backward_plain(
                q, k, v, o, lse, do, causal=causal, window=window,
                scale=scale)
        from repro_torch.kernels.flash_attention import \
            flash_attention_backward
        return flash_attention_backward(
            q.contiguous(), k.contiguous(), v.contiguous(), o.contiguous(),
            lse.contiguous(), do.contiguous(), causal=causal,
            window=window, scale=scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        outs = _AttentionBackward.apply(*_fold(info, in_dims, args))
        return _unfold(info.batch_size, outs), (0, 0, 0)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, causal, window, scale, impl):
        if impl == "plain":
            return kref.flash_attention_plain(q, k, v, causal=causal,
                                              window=window, scale=scale)
        from repro_torch.kernels.flash_attention import flash_attention_fwd
        return flash_attention_fwd(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window, scale=scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, scale, impl = inputs
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, scale, impl)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _AttentionBackward.apply(q, k, v, o, lse, do,
                                              *ctx.args)
        return dq, dk, dv, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, *args):
        outs = _Attention.apply(*_fold(info, in_dims, args))
        return _unfold(info.batch_size, outs), (0, 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    impl: str = "auto") -> torch.Tensor:
    """Causal / sliding-window GQA attention, differentiable.

    q [B, S, Hq, D]; k/v [B, T, Hkv, D] -> [B, S, Hq, D] in q's type,
    with the semantics of the reference's ``flash_attention_ref``.  The
    kernels' launch counts are ``kernels.flash_attention.
    flash_attention_fwd.launches`` and ``.flash_attention_backward.
    launches``; the kernel takes ``causal=True`` only.
    """
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    out, _ = _Attention.apply(q, k, v, bool(causal), int(window),
                              float(scale), _resolve(impl, q))
    return out


class _WKVBackward(torch.autograd.Function):
    @staticmethod
    def forward(r, k, v, w, u, ckpt, dy, dsT, impl):
        if impl == "plain":
            return kref.rwkv6_wkv_backward_plain(r, k, v, w, u, ckpt, dy,
                                                 dsT)
        from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv_backward
        return rwkv6_wkv_backward(*(x.contiguous() for x in
                                    (r, k, v, w, u, ckpt, dy, dsT)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        outs = _WKVBackward.apply(*_fold(info, in_dims, args))
        return _unfold(info.batch_size, outs), (0,) * 6


class _WKV(torch.autograd.Function):
    @staticmethod
    def forward(r, k, v, w, u, s0, impl):
        if impl == "plain":
            return kref.rwkv6_wkv_forward_plain(r, k, v, w, u, s0)
        from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv_forward
        return rwkv6_wkv_forward(*(x.contiguous() for x in
                                   (r, k, v, w, u, s0)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        r, k, v, w, u, s0, impl = inputs
        ckpt = output[2]
        ctx.mark_non_differentiable(ckpt)
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        ctx.impl = impl

    @staticmethod
    def backward(ctx, dy, dsT, _dckpt):
        grads = _WKVBackward.apply(*ctx.saved_tensors, dy, dsT, ctx.impl)
        return (*grads, None)

    @staticmethod
    def vmap(info, in_dims, *args):
        outs = _WKV.apply(*_fold(info, in_dims, args))
        return _unfold(info.batch_size, outs), (0, 0, 0)


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
              impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """The RWKV-6 WKV recurrence, differentiable in every input.

    r/k/v/w [B, S, H, D]; u [H, D]; state [B, H, D, D] (indexed [j, i])
    -> (y [B, S, H, D] in r's type, final state fp32), with the semantics
    of the reference's ``rwkv6_wkv_ref``.  Inputs of mixed types are
    promoted to fp32 first (the oracle computes in fp32).  ``u`` goes to
    the kernel broadcast per batch row, so under the trainer's vmap each
    learner keeps its own; its gradient is summed over the batch by the
    broadcast's own backward.  The kernels' launch counts are
    ``kernels.rwkv6_wkv.rwkv6_wkv_forward.launches`` and
    ``.rwkv6_wkv_backward.launches``.
    """
    dtype = r.dtype
    if not k.dtype == v.dtype == w.dtype == dtype:
        r, k, v, w = (x.float() for x in (r, k, v, w))
    b, _, h, d = r.shape
    ub = u.float().expand(b, h, d)
    y, st, _ = _WKV.apply(r, k, v, w, ub, state.float(),
                          _resolve(impl, r))
    return y.to(dtype), st
