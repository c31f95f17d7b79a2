"""GQA and MLA attention (PyTorch port of ``repro/models/attention.py``).

Ported: the training attention (``full_attention``, which dispatches to
``kernels.ops.flash_attention`` under the reference's condition, and
``gqa_attention``), the masked attention core, GQA projections, the
paged cache (``init_paged_kv``, ``paged_slot_coords``,
``gqa_decode_paged``, ``gqa_prefill_paged_chunk``), and MLA for training
(``mla_params``, ``mla_attention``), which attends with its own products
in the reference and so in the port.  The dense-cache decode and MLA's
caches and decode come with serving (ROADMAP Queue 1 item 6).  Products
take the promoted type of their operands, as the reference's do.

GQA projections are leaves named as the reference's: attributes of the
serving path's :class:`GQA` module, or keys of the training path's dict
(:func:`gqa_params`).  The reference returns a new pool from every step
(JAX donates the old one); the port writes into the per-layer pool in
place with ``index_put_`` and returns the same tensors.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.common import (apply_rope, dense_init, mm,
                                       rmsnorm, rmsnorm_init)

NEG_INF = -1.0e30

Pages = Dict[str, torch.Tensor]


# ===================================================================== #
# shared masked attention core
# ===================================================================== #

def _gqa_scores_attend(q, k, v, mask, scale):
    """q [B,S,Hq,D], k/v [B,T,Hkv,D], mask [B,1,S,T] bool -> [B,S,Hq,D].

    Scores are taken in the inputs' type and then cast to fp32;
    probabilities go back to v's type, in the reference's order."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    q = q.reshape(b, s, hkv, g, d)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float() * scale
    scores = torch.where(mask[:, :, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, hq, d)


def causal_mask(s: int, t: int, window: int = 0, q_offset: int = 0, *,
                device=None) -> torch.Tensor:
    """[s, t] bool mask; query i (global pos q_offset+i) sees key j iff
    j <= pos and (window == 0 or pos - j < window)."""
    qpos = torch.arange(s, device=device)[:, None] + q_offset
    kpos = torch.arange(t, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= (qpos - kpos) < window
    return m


def masked_attention(q, k, v, *, window: int = 0, q_offset: int = 0,
                     scale: Optional[float] = None):
    """Causal attention through the masked core: the path the reference's
    ``full_attention`` takes in its paged prefill, where ``q_offset`` is
    traced.  Query i (position q_offset + i) sees key j iff j <= pos and
    (window == 0 or pos - j < window)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, s = q.shape[:2]
    t = k.shape[1]
    m = causal_mask(s, t, window, q_offset, device=q.device)[None, None]
    return _gqa_scores_attend(q, k, v, m.expand(b, 1, s, t), scale)


def _pick_q_chunk(t: int) -> int:
    """Bound the per-chunk score tensor to ~4M elements per (b, head)."""
    return max(64, min(1024, (1 << 22) // max(t, 1)))


def full_attention(q, k, v, *, causal: bool = True, window: int = 0,
                   q_offset: int = 0, extra_mask=None,
                   scale: Optional[float] = None, impl: str = "auto"):
    """Dispatchable attention.  Causal, without ``extra_mask`` and at a
    static ``q_offset`` of 0 (the reference's condition for its Pallas
    kernel) it is ``kernels.ops.flash_attention`` under ``impl``
    ("auto": the CUDA kernels for CUDA tensors, forward and backward); at
    another offset, the masked core.  Non-causal and extra-masked
    attention (the encoder-decoder's cross-attention) are not ported
    yet: ROADMAP Queue 1 item 9."""
    if not causal or extra_mask is not None:
        raise NotImplementedError("non-causal or extra-masked attention is "
                                  "not ported yet: ROADMAP Queue 1 item 9")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if isinstance(q_offset, int) and q_offset == 0:
        return kops.flash_attention(q, k, v, causal=True, window=window,
                                    scale=float(scale), impl=impl)
    return masked_attention(q, k, v, window=window, q_offset=q_offset,
                            scale=scale)


# ===================================================================== #
# GQA
# ===================================================================== #

def gqa_params(d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
               dtype=torch.float32, *, device,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """The reference's GQA leaves ``wq, wk, wv, wo``, each
    ``[d_in, d_out]``."""
    kw = dict(device=device, generator=generator)
    return {"wq": dense_init(d_model, n_heads * head_dim, dtype, **kw),
            "wk": dense_init(d_model, n_kv_heads * head_dim, dtype, **kw),
            "wv": dense_init(d_model, n_kv_heads * head_dim, dtype, **kw),
            "wo": dense_init(n_heads * head_dim, d_model, dtype, **kw)}


class GQA(nn.Module):
    """Projections named as the reference's leaves, ``[d_in, d_out]``."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, dtype=torch.float32, *, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for name, w in gqa_params(d_model, n_heads, n_kv_heads, head_dim,
                                  dtype, device=device,
                                  generator=generator).items():
            setattr(self, name, nn.Parameter(w))


def gqa_init(d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
             dtype=torch.float32, *, device,
             generator: Optional[torch.Generator] = None) -> GQA:
    return GQA(d_model, n_heads, n_kv_heads, head_dim, dtype, device=device,
               generator=generator)


def _w(p, name: str) -> torch.Tensor:
    """Leaf ``name`` of a module's attributes or of a dict of leaves."""
    return p[name] if isinstance(p, Mapping) else getattr(p, name)


def _project_qkv(p, x, n_heads, n_kv_heads, head_dim):
    b, s, _ = x.shape
    q = mm(x, _w(p, "wq")).reshape(b, s, n_heads, head_dim)
    k = mm(x, _w(p, "wk")).reshape(b, s, n_kv_heads, head_dim)
    v = mm(x, _w(p, "wv")).reshape(b, s, n_kv_heads, head_dim)
    return q, k, v


def gqa_attention(p: Mapping[str, torch.Tensor], x, cos, sin, *,
                  n_heads: int, n_kv_heads: int, head_dim: int,
                  causal: bool = True, window: int = 0,
                  impl: str = "auto") -> torch.Tensor:
    """Train/prefill full-sequence path.  cos/sin [B, S, head_dim // 2]."""
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    if cos is not None:
        q = apply_rope(q, cos[:, :, None], sin[:, :, None])
        k = apply_rope(k, cos[:, :, None], sin[:, :, None])
    out = full_attention(q, k, v, causal=causal, window=window, impl=impl)
    return mm(out.reshape(x.shape[0], x.shape[1], n_heads * head_dim),
              _w(p, "wo"))


# --------------------------- paged cache ------------------------------ #
#
# K/V live in a global pool of fixed-size pages, [Hkv, P, page, D] per
# layer (head-major so the decode kernel streams one (page, D) tile per
# kv head); each sequence owns an ordered block table of page ids.  Page 0
# is the null page: unallocated table entries point at it and inactive
# slots' writes land there.

def init_paged_kv(n_pages: int, page_size: int, n_kv_heads: int,
                  head_dim: int, dtype=torch.bfloat16, *, device) -> Pages:
    shape = (n_kv_heads, n_pages, page_size, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_slot_coords(block_tables, lengths, active, page_size: int):
    """(page_ids [B], offsets [B]) where each slot's NEXT token is written;
    inactive slots are redirected to the null page 0."""
    idx = (lengths // page_size).long()
    page_ids = torch.gather(block_tables, 1, idx[:, None])[:, 0]
    page_ids = torch.where(active, page_ids, torch.zeros_like(page_ids))
    return page_ids, lengths % page_size


def _write_pages(pages: Pages, page_ids, offs, k, v) -> None:
    """Scatter k/v [..., Hkv, D] into (page_ids, offs) [...] of the pool,
    in place.  The pool viewed as [P, page, Hkv, D] takes the values
    without a transpose.  Duplicate coordinates (inactive slots, all on
    the null page) leave an arbitrary one of their values: page 0 is never
    visible."""
    idx = (page_ids.long(), offs.long())
    for name, val in (("k", k), ("v", v)):
        pool = pages[name]
        pool.permute(1, 2, 0, 3).index_put_(idx, val.to(pool.dtype))


def gqa_decode_paged(p: GQA, x, pages: Pages, block_tables, lengths,
                     active, cos, sin, *, n_heads: int, n_kv_heads: int,
                     head_dim: int, window: int = 0, impl: str = "auto"
                     ) -> Tuple[torch.Tensor, Pages]:
    """One-token decode against a paged pool (per-slot positions).

    x [B,1,d]; block_tables [B, max_pages] int32; lengths [B] int32 —
    tokens cached so far per slot (the new token is written at position
    ``lengths`` and the attend covers ``lengths + active`` tokens);
    active [B] bool.  ``impl`` routes the attend through
    kernels/ops.py::flash_decode.
    """
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    if cos is not None:
        q = apply_rope(q, cos[:, :, None], sin[:, :, None])
        k = apply_rope(k, cos[:, :, None], sin[:, :, None])
    page = pages["k"].shape[2]
    page_ids, offs = paged_slot_coords(block_tables, lengths, active, page)
    _write_pages(pages, page_ids, offs, k[:, 0], v[:, 0])
    att_len = lengths + active.to(lengths.dtype)
    out = kops.flash_decode(q[:, 0].contiguous(), pages["k"], pages["v"],
                            block_tables, att_len, window=window, impl=impl)
    out = out.reshape(b, 1, n_heads * head_dim).to(x.dtype) @ p.wo
    return out, pages


def gqa_prefill_paged_chunk(p: GQA, x, pages: Pages, block_tables, base,
                            cos, sin, *, n_heads: int, n_kv_heads: int,
                            head_dim: int, window: int = 0
                            ) -> Tuple[torch.Tensor, Pages]:
    """One prompt chunk of a paged prefill.

    x [B,C,d]: chunk tokens at positions base..base+C-1.  K/V are written
    into the chunk's pages, then the chunk queries attend every cached
    position through the gathered pool: the WHOLE table (maxp * page
    positions, null-page entries included, masked by causality).  The
    padded tail of the final chunk writes garbage past the true length,
    masked out of every later attend and overwritten by decode.
    """
    b, c, _ = x.shape
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    if cos is not None:
        q = apply_rope(q, cos[:, :, None], sin[:, :, None])
        k = apply_rope(k, cos[:, :, None], sin[:, :, None])
    page = pages["k"].shape[2]
    pos = base + torch.arange(c, device=x.device)              # [C]
    tbl = block_tables.expand(b, block_tables.shape[1])
    page_ids = tbl[:, pos // page]                               # [B,C]
    offs = (pos % page)[None].expand(b, c)
    _write_pages(pages, page_ids, offs, k, v)
    kd = kref.gather_pages(pages["k"], tbl).to(q.dtype)          # [B,T,Hkv,D]
    vd = kref.gather_pages(pages["v"], tbl).to(q.dtype)
    # the reference's base is traced here, so it never takes the kernel
    out = masked_attention(q, kd, vd, window=window, q_offset=base)
    out = out.reshape(b, c, n_heads * head_dim) @ p.wo
    return out, pages


# ===================================================================== #
# MLA (Multi-head Latent Attention, DeepSeek-V2), training
# ===================================================================== #

def mla_params(d_model: int, n_heads: int, kv_lora: int, qk_nope: int,
               qk_rope: int, v_dim: int, dtype=torch.float32, *, device,
               generator: Optional[torch.Generator] = None) -> Dict:
    """The reference's MLA leaves, each ``[d_in, d_out]``, and the latent
    norm's ``kv_norm.scale``."""
    kw = dict(device=device, generator=generator)
    return {
        "wq": dense_init(d_model, n_heads * (qk_nope + qk_rope), dtype,
                         **kw),
        "w_dkv": dense_init(d_model, kv_lora, dtype, **kw),
        "w_kr": dense_init(d_model, qk_rope, dtype, **kw),
        "kv_norm": {"scale": rmsnorm_init(kv_lora, dtype, device=device)},
        "w_uk": dense_init(kv_lora, n_heads * qk_nope, dtype, **kw),
        "w_uv": dense_init(kv_lora, n_heads * v_dim, dtype, **kw),
        "wo": dense_init(n_heads * v_dim, d_model, dtype, **kw),
    }


def _mla_q(p, x, n_heads, qk_nope, qk_rope, cos, sin):
    b, s, _ = x.shape
    q = mm(x, p["wq"]).reshape(b, s, n_heads, qk_nope + qk_rope)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    q_rope = apply_rope(q_rope, cos[:, :, None], sin[:, :, None])
    return q_nope, q_rope


def _mla_latents(p, x, cos, sin, eps):
    ckv = rmsnorm(p["kv_norm"]["scale"], mm(x, p["w_dkv"]), eps)
    kr = apply_rope(mm(x, p["w_kr"])[:, :, None, :], cos[:, :, None],
                    sin[:, :, None])[:, :, 0]
    return ckv, kr


def mla_attention(p, x, cos, sin, *, n_heads: int, kv_lora: int,
                  qk_nope: int, qk_rope: int, v_dim: int,
                  eps: float = 1e-5) -> torch.Tensor:
    """Train/prefill: decompress the latents into per-head K/V (the
    reference's standard path).  x [B,S,d]; cos/sin [B,S,qk_rope // 2].
    Scores are the sum of the no-rope and rope products in the inputs'
    type, then fp32.  Long sequences attend in query chunks of
    :func:`_pick_q_chunk`, as the reference's do (there under
    ``jax.checkpoint``, which bounds memory only)."""
    b, s, _ = x.shape
    q_nope, q_rope = _mla_q(p, x, n_heads, qk_nope, qk_rope, cos, sin)
    ckv, kr = _mla_latents(p, x, cos, sin, eps)
    k_nope = mm(ckv, p["w_uk"]).reshape(b, s, n_heads, qk_nope)
    v = mm(ckv, p["w_uv"]).reshape(b, s, n_heads, v_dim)
    # the reference's 1 / sqrt(n) in fp32, rounded twice as there
    scale = float(1.0 / torch.tensor(float(qk_nope + qk_rope)).sqrt())

    def attend_block(qn, qr, offset):
        """qn [b, qc, H, nope]; offset: the first query's position."""
        qc = qn.shape[1]
        mask = causal_mask(qc, s, 0, q_offset=offset, device=x.device)
        scores = (torch.einsum("bshd,bthd->bhst", qn, k_nope)
                  + torch.einsum("bshd,btd->bhst", qr, kr)).float()
        scores = torch.where(mask, scores * scale,
                             torch.full_like(scores, NEG_INF))
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bhst,bthd->bshd", probs, v)

    q_chunk = _pick_q_chunk(s)
    if s >= 2 * q_chunk and s % q_chunk == 0:
        out = torch.cat([attend_block(q_nope[:, i:i + q_chunk],
                                      q_rope[:, i:i + q_chunk], i)
                         for i in range(0, s, q_chunk)], dim=1)
    else:
        out = attend_block(q_nope, q_rope, 0)
    return mm(out.reshape(b, s, n_heads * v_dim), p["wo"])
