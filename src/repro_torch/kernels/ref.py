"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``).

These are the semantics of record on the port's side: the CPU tests hold
them against the reference's oracles, ``kernels/ops.py`` runs them for
CPU tensors, and ``chip_smoke.py`` holds each CUDA kernel against them on
the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1.0e30


def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor
                 ) -> torch.Tensor:
    """Materialize a paged pool as a dense per-sequence cache.

    pages [Hkv, P, page, D]; block_tables [B, max_pages] int32 ->
    dense [B, max_pages * page, Hkv, D].  Entry ``j`` of the dense view is
    cache position ``j``: a block table lists its pages in position order.
    """
    hkv, _, page, d = pages.shape
    b, maxp = block_tables.shape
    g = pages[:, block_tables.long()]              # [Hkv, B, maxp, page, D]
    return g.permute(1, 2, 3, 0, 4).reshape(b, maxp * page, hkv, d)


def flash_decode_plain(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, *, window: int = 0,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Paged decode attention through a dense gather.

    q [B, Hq, D]; k_pages/v_pages [Hkv, P, page, D]; block_tables
    [B, max_pages] int32; lengths [B] int32, valid cache tokens per
    sequence INCLUDING the query (which sits at position lengths-1).

    Key j is visible iff j < lengths[b] and (window == 0 or
    lengths[b]-1 - j < window).  Sequences with lengths == 0 give zeros.
    Returns [B, Hq, D] in q's dtype.
    """
    b, hq, d = q.shape
    hkv = k_pages.shape[0]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    k = gather_pages(k_pages, block_tables).float()    # [B, T, Hkv, D]
    v = gather_pages(v_pages, block_tables).float()
    t = k.shape[1]
    qg = q.reshape(b, hkv, g, d).float()
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k) * scale
    lens = lengths.long()[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    valid = kpos < lens
    if window:
        valid &= (lens - 1 - kpos) < window
    scores = torch.where(valid[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v)
    # all-masked rows (inactive slots) output zeros, not a uniform mix
    any_valid = valid.any(dim=1)[:, None, None, None]
    out = torch.where(any_valid, out, torch.zeros_like(out))
    return out.reshape(b, hq, d).to(q.dtype)


def topk_compress_plain(x: torch.Tensor, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row magnitude top-k (the sparse reducer's compress step).

    x [rows, n] -> (values [rows, k] in x's dtype, indices [rows, k] int32,
    ascending per row).  A stable descending sort of |x| in fp32 keeps the
    first k, so ties at the k-th magnitude go to the lowest indices, as in
    the reference's ``lax.top_k`` oracle; ``torch.topk`` leaves the tie
    order unspecified and is not used.  Values are gathered from x, bits
    and all (subnormals and -0.0 kept).
    """
    order = torch.sort(x.float().abs(), dim=-1, descending=True,
                       stable=True).indices
    idx = torch.sort(order[:, :k], dim=-1).values
    return torch.gather(x, 1, idx), idx.to(torch.int32)
