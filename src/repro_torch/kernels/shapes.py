"""Shape functions of the port's kernels: what each CUDA twin allocates,
computing nothing (the counterpart of a Pallas kernel's ``out_shape``).

``kernels/ops.py`` takes these in place of a launch wherever a card would
launch the kernel and the tensors are fake (``FakeTensorMode``, the dry
run's trace, ``launch/dryrun.py``): the outputs as ``torch.empty`` of the
twin's shapes and types, and the twin's own scratch where the wrapper
allocates it through PyTorch.  So a fake trace holds the twin's memory,
not the plain version's: the plain attention materialises [B, H, S, T]
scores, the plain WKV a state a step, and the twins neither.  Top-k's
scratch is sized by its library's plan, which a fake trace cannot ask:
the shape function leaves it out.

The attention and WKV shape functions also add the kernel's FLOPs to
``FLOPS`` (the dry run's count, beside ``FlopCounterMode``'s, which sees
only the allocations), from the formulas of ``chip_smoke.py``'s bounds:
4 D (forward) and 10 D (backward) per visible (query, key) pair and
query head; 4 D^2 (forward) and 10 D^2 (backward) per step and head.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

# the kernels' FLOPs the fake trace has reached since the dry run zeroed it
FLOPS = [0.0]


def visible_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal attention over ``s`` positions sees,
    each query at most ``window`` keys (0: no window)."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _empty(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=like.device)


def flash_decode(q, k_pages, v_pages, block_tables, lengths, *, window=0,
                 scale=None) -> torch.Tensor:
    from repro_torch.kernels.flash_decode import split_plan
    b, hq, d = q.shape
    hkv, _, page, _ = k_pages.shape
    _, n_splits = split_plan(block_tables.shape[1], page, int(window), None)
    out = torch.empty_like(q)
    g = hq // hkv
    # the split kernel's partials, freed when the call returns
    _empty((b, hkv, n_splits, g, d), torch.float32, q)
    _empty((b, hkv, n_splits, g, 2), torch.float32, q)
    return out


def topk_compress_many(xs: Sequence[torch.Tensor], ks: Sequence[int]
                       ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    return [(_empty((x.shape[0], k), x.dtype, x),
             _empty((x.shape[0], k), torch.int32, x))
            for x, k in zip(xs, ks)]


def qint8_pack(x: torch.Tensor, block: int) -> torch.Tensor:
    from repro_torch.kernels.ref import QINT8_SCALE_BYTES
    rows, n = x.shape
    return _empty((rows, -(-n // block), block + QINT8_SCALE_BYTES),
                  torch.int8, x)


def qint8_unpack(wire: torch.Tensor, n: int) -> torch.Tensor:
    return _empty((wire.shape[0], int(n)), torch.float32, wire)


def batched_qr_many(ps: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    # one fp32 buffer for every panel, cast back where p is not fp32
    out = _empty((sum(p.numel() for p in ps),), torch.float32, ps[0])
    qs = out.split([p.numel() for p in ps])
    return [q.view(p.shape) if p.dtype == torch.float32
            else q.view(p.shape).to(p.dtype) for q, p in zip(qs, ps)]


def flash_attention_fwd(q, k, v, window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, hq, d = q.shape
    FLOPS[0] += 4 * d * hq * b * visible_pairs(s, window)
    return torch.empty_like(q), _empty((b, hq, s), torch.float32, q)


def flash_attention_backward(q, k, v, o, lse, do, window: int = 0):
    b, s, hq, d = q.shape
    FLOPS[0] += 10 * d * hq * b * visible_pairs(s, window)
    _empty((b, hq, s), torch.float32, q)            # rowsum(dO O)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def rwkv6_wkv_forward(r, k, v, w, u, s0):
    from repro_torch.kernels.ref import WKV_CHUNK
    b, s, h, d = r.shape
    FLOPS[0] += 4 * d * d * s * b * h
    return (torch.empty_like(r), _empty((b, h, d, d), torch.float32, r),
            _empty((b, h, -(-s // WKV_CHUNK), d, d), torch.float32, r))


def rwkv6_wkv_backward(r, k, v, w, u, ckpt, dy, dsT):
    b, s, h, d = r.shape
    FLOPS[0] += 10 * d * d * s * b * h
    return (*(torch.empty_like(r) for _ in range(4)),
            _empty((b, h, d), torch.float32, r),
            _empty((b, h, d, d), torch.float32, r))
