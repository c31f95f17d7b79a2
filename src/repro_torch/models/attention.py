"""GQA and MLA attention (PyTorch port of ``repro/models/attention.py``).

Ported: the training attention (``full_attention``, which dispatches to
``kernels.ops.flash_attention`` under the reference's condition, and
``gqa_attention``; non-causal and extra-masked attention and the
encoder-decoder's ``cross_attention`` through the masked core, as in the
reference), the masked attention core, GQA projections, the
dense serving cache (``init_kv_cache``, ``prefill_kv_cache``,
``gqa_decode``, full or rolling), the paged cache (``init_paged_kv``,
``paged_slot_coords``, ``gqa_decode_paged``, ``gqa_prefill_paged_chunk``),
and MLA for training (``mla_params``, ``mla_attention``) and serving
(``init_mla_cache``, ``mla_prefill_cache``, ``mla_decode``, and the
latent pages: ``init_paged_mla``, ``mla_decode_paged``,
``mla_prefill_paged_chunk``), which attends with its own products in the
reference and so in the port.  Products take the promoted type of their
operands, as the reference's do.

Parameters are read by the reference's leaf names, ``p["wq"]``, from the
training path's dicts (:func:`gqa_params`) or the serving path's modules
(``models/transformer.py::Leaves``), which index the same way.  The reference returns a new cache or pool from
every step (JAX donates the old one); the port writes into the per-layer
tensors in place and returns the same tensors.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.common import (apply_rope, dense_init, einsum, mm,
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
    another offset, the masked core.  Non-causal attention (the
    encoder's) and ``extra_mask`` [B,1,S,T] bool (the cross-attention's
    frame mask, anded with the causal one where ``causal``) go through
    the masked core over an all-true or given mask, as in the reference,
    whose Pallas kernel is causal only."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if causal and extra_mask is None:
        if isinstance(q_offset, int) and q_offset == 0:
            return kops.flash_attention(q, k, v, causal=True, window=window,
                                        scale=float(scale), impl=impl)
        return masked_attention(q, k, v, window=window, q_offset=q_offset,
                                scale=scale)
    b, s = q.shape[:2]
    t = k.shape[1]
    if causal:
        m = causal_mask(s, t, window, q_offset, device=q.device)
    else:
        m = torch.ones((s, t), dtype=torch.bool, device=q.device)
    m = m[None, None].expand(b, 1, s, t)
    if extra_mask is not None:
        m = m & extra_mask
    return _gqa_scores_attend(q, k, v, m, scale)


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


def _project_qkv(p, x, n_heads, n_kv_heads, head_dim):
    b, s, _ = x.shape
    q = mm(x, p["wq"]).reshape(b, s, n_heads, head_dim)
    k = mm(x, p["wk"]).reshape(b, s, n_kv_heads, head_dim)
    v = mm(x, p["wv"]).reshape(b, s, n_kv_heads, head_dim)
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
              p["wo"])


def cross_attention(p: Mapping[str, torch.Tensor], x, enc_k, enc_v,
                    enc_mask, *, n_heads: int, n_kv_heads: int,
                    head_dim: int) -> torch.Tensor:
    """Decoder cross-attention: x [B,S,d] queries against the encoder's
    precomputed enc_k/enc_v [B,Te,Hkv,D]; ``enc_mask`` [B,Te] bool (None:
    every frame) hides padded frames.  No RoPE, no causality."""
    b, s, _ = x.shape
    q = mm(x, p["wq"]).reshape(b, s, n_heads, head_dim)
    m = None
    if enc_mask is not None:
        m = enc_mask[:, None, None, :].expand(b, 1, s, enc_k.shape[1])
    out = full_attention(q, enc_k, enc_v, causal=False, extra_mask=m)
    return mm(out.reshape(b, s, n_heads * head_dim), p["wo"])


# --------------------------- dense cache ------------------------------ #
#
# One layer's cache is {"k", "v": [B, length, Hkv, D], "pos": tokens
# written so far (a Python int)}: length is max_len, or the window for a
# rolling cache, which writes at pos % window.  The reference's
# dynamic_update_slice clamps a start past the end to the last slot; the
# port clamps the same way, so a wave that decodes past max_len gives the
# reference's tokens.

def init_kv_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, rolling: bool = False,
                  window: int = 0, *, device) -> Dict:
    length = window if rolling else max_len
    shape = (batch, length, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": 0}


def gqa_decode(p, x, cache: Dict, cos, sin, *, n_heads: int,
               n_kv_heads: int, head_dim: int, rolling: bool = False
               ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode against a dense cache.  x [B,1,d]; cos/sin
    [B,1,head_dim//2] at the current position.  Slot i holds a real
    token iff i <= pos, or i < min(pos + 1, length) once a rolling buffer
    may have wrapped; the attend is the masked core, as the reference's
    (no window: the reference's dense decode has none)."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    if cos is not None:
        q = apply_rope(q, cos[:, :, None], sin[:, :, None])
        k = apply_rope(k, cos[:, :, None], sin[:, :, None])
    pos = cache["pos"]
    length = cache["k"].shape[1]
    slot = pos % length if rolling else min(pos, length - 1)
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    out = masked_attention(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                           q_offset=min(pos, length - 1))
    out = mm(out.reshape(b, 1, n_heads * head_dim), p["wo"])
    return out, dict(cache, pos=pos + 1)


def prefill_kv_cache(p, x, cos, sin, *, n_heads: int, n_kv_heads: int,
                     head_dim: int, max_len: int, dtype=torch.bfloat16,
                     rolling: bool = False, window: int = 0) -> Dict:
    """The prompt's roped K/V laid into a fresh cache (a rolling one keeps
    the last ``window`` and counts only those, as the reference does)."""
    b, s, _ = x.shape
    _, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    if cos is not None:
        k = apply_rope(k, cos[:, :, None], sin[:, :, None])
    cache = init_kv_cache(b, max_len, n_kv_heads, head_dim, dtype,
                          rolling=rolling, window=window, device=x.device)
    if rolling:
        keep = min(s, window)
        k, v = k[:, s - keep:], v[:, s - keep:]
    n = k.shape[1]
    cache["k"][:, :n] = k.to(dtype)
    cache["v"][:, :n] = v.to(dtype)
    cache["pos"] = n
    return cache


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


def gqa_decode_paged(p, x, pages: Pages, block_tables, lengths,
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
    out = mm(out.reshape(b, 1, n_heads * head_dim).to(x.dtype), p["wo"])
    return out, pages


def gqa_prefill_paged_chunk(p, x, pages: Pages, block_tables, base,
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
    out = mm(out.reshape(b, c, n_heads * head_dim), p["wo"])
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
    scale = _mla_scale(qk_nope, qk_rope)

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


# --------------------------- MLA caches -------------------------------- #
#
# The latent cache holds no head axis: ckv [B, T, kv_lora] and the shared
# rope key [B, T, qk_rope], and the decode attends in latent space (the
# absorbed formulation: w_uk folded into the query, w_uv into the
# output), never materializing per-head K/V.

def _mla_scale(qk_nope: int, qk_rope: int) -> float:
    """The reference's 1 / sqrt(n) in fp32, rounded twice as there."""
    return float(1.0 / torch.tensor(float(qk_nope + qk_rope)).sqrt())


def init_mla_cache(batch: int, max_len: int, kv_lora: int, qk_rope: int,
                   dtype=torch.bfloat16, *, device) -> Dict:
    return {"ckv": torch.zeros((batch, max_len, kv_lora), dtype=dtype,
                               device=device),
            "k_rope": torch.zeros((batch, max_len, qk_rope), dtype=dtype,
                                  device=device),
            "pos": 0}


def mla_prefill_cache(p, x, cos, sin, *, max_len: int, eps: float,
                      dtype=torch.bfloat16) -> Dict:
    b, s, _ = x.shape
    ckv, kr = _mla_latents(p, x, cos, sin, eps)
    cache = init_mla_cache(b, max_len, ckv.shape[-1], kr.shape[-1], dtype,
                           device=x.device)
    cache["ckv"][:, :s] = ckv.to(dtype)
    cache["k_rope"][:, :s] = kr.to(dtype)
    cache["pos"] = s
    return cache


def mla_decode(p, x, cache: Dict, cos, sin, *, n_heads: int, kv_lora: int,
               qk_nope: int, qk_rope: int, v_dim: int, eps: float = 1e-5
               ) -> Tuple[torch.Tensor, Dict]:
    """Absorbed one-token decode: scores and context in latent space, per
    step O(T * kv_lora * H).  Position ``pos`` is written first (clamped
    to the last slot, as the reference's update), then keys 0..pos are
    attended."""
    b = x.shape[0]
    q_nope, q_rope = _mla_q(p, x, n_heads, qk_nope, qk_rope, cos, sin)
    ckv_new, kr_new = _mla_latents(p, x, cos, sin, eps)        # [B,1,*]
    pos = cache["pos"]
    ckv, krc = cache["ckv"], cache["k_rope"]
    slot = min(pos, ckv.shape[1] - 1)
    ckv[:, slot] = ckv_new[:, 0].to(ckv.dtype)
    krc[:, slot] = kr_new[:, 0].to(krc.dtype)
    t = ckv.shape[1]
    w_uk = p["w_uk"].reshape(kv_lora, n_heads, qk_nope)
    q_lat = einsum("bhd,lhd->bhl", q_nope[:, 0], w_uk)
    scores = (torch.einsum("bhl,btl->bht", q_lat, ckv.to(q_lat.dtype))
              + torch.einsum("bhd,btd->bht", q_rope[:, 0],
                             krc.to(q_rope.dtype))).float()
    valid = (torch.arange(t, device=x.device) <= pos)[None, None]
    scores = torch.where(valid, scores * _mla_scale(qk_nope, qk_rope),
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(ckv.dtype)
    ctx = torch.einsum("bht,btl->bhl", probs, ckv)              # [B,H,lora]
    w_uv = p["w_uv"].reshape(kv_lora, n_heads, v_dim)
    out = einsum("bhl,lhv->bhv", ctx.to(x.dtype), w_uv)
    out = mm(out.reshape(b, 1, n_heads * v_dim), p["wo"])
    return out, dict(cache, pos=pos + 1)


# --------------------------- paged MLA --------------------------------- #
#
# Latent pages have no head axis: the pool is [P, page, kv_lora] and the
# shared rope key [P, page, qk_rope], the same block-table indirection as
# the GQA pool at a fraction of its bytes.  The decode step and the chunk
# prefill both attend in latent space.

def init_paged_mla(n_pages: int, page_size: int, kv_lora: int,
                   qk_rope: int, dtype=torch.bfloat16, *, device) -> Pages:
    return {"ckv": torch.zeros((n_pages, page_size, kv_lora), dtype=dtype,
                               device=device),
            "kr": torch.zeros((n_pages, page_size, qk_rope), dtype=dtype,
                              device=device)}


def _gather_latent(pages: torch.Tensor, block_tables) -> torch.Tensor:
    """pages [P, page, R], tables [B, maxp] -> dense [B, maxp * page, R]."""
    b, maxp = block_tables.shape
    return pages[block_tables.long()].reshape(b, maxp * pages.shape[1],
                                              pages.shape[2])


def _mla_absorbed_attend(p, q_nope, q_rope, ckv_d, kr_d, mask, *,
                         n_heads, kv_lora, qk_nope, qk_rope, v_dim):
    """Absorbed-latent attention for S queries: q_nope [B,S,H,nope],
    q_rope [B,S,H,rope]; ckv_d [B,T,lora], kr_d [B,T,rope]; mask [B,S,T]
    bool.  Rows with no valid key (inactive slots) output zeros.
    Returns [B, S, H * v_dim]."""
    b, s = q_nope.shape[:2]
    w_uk = p["w_uk"].reshape(kv_lora, n_heads, qk_nope)
    q_lat = einsum("bshd,lhd->bshl", q_nope, w_uk)
    scores = (torch.einsum("bshl,btl->bhst", q_lat, ckv_d.to(q_lat.dtype))
              + torch.einsum("bshd,btd->bhst", q_rope,
                             kr_d.to(q_rope.dtype))).float()
    scores = torch.where(mask[:, None],
                         scores * _mla_scale(qk_nope, qk_rope),
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(ckv_d.dtype)
    ctx = torch.einsum("bhst,btl->bshl", probs, ckv_d)
    ctx = torch.where(mask.any(-1)[:, :, None, None], ctx,
                      torch.zeros_like(ctx))
    w_uv = p["w_uv"].reshape(kv_lora, n_heads, v_dim)
    out = einsum("bshl,lhv->bshv", ctx.to(q_nope.dtype), w_uv)
    return out.reshape(b, s, n_heads * v_dim)


def _write_latents(pages: Pages, page_ids, offs, ckv, kr) -> None:
    """Scatter ckv/kr [..., R] into (page_ids, offs) [...] in place, as
    :func:`_write_pages` does for K/V (page 0 takes inactive writes)."""
    idx = (page_ids.long(), offs.long())
    pages["ckv"].index_put_(idx, ckv.to(pages["ckv"].dtype))
    pages["kr"].index_put_(idx, kr.to(pages["kr"].dtype))


def mla_decode_paged(p, x, pages: Pages, block_tables, lengths, active,
                     cos, sin, *, n_heads: int, kv_lora: int, qk_nope: int,
                     qk_rope: int, v_dim: int, eps: float = 1e-5
                     ) -> Tuple[torch.Tensor, Pages]:
    """Absorbed one-token decode against latent pages (per-slot
    lengths; see :func:`gqa_decode_paged`)."""
    q_nope, q_rope = _mla_q(p, x, n_heads, qk_nope, qk_rope, cos, sin)
    ckv_new, kr_new = _mla_latents(p, x, cos, sin, eps)        # [B,1,*]
    page = pages["ckv"].shape[1]
    page_ids, offs = paged_slot_coords(block_tables, lengths, active, page)
    _write_latents(pages, page_ids, offs, ckv_new[:, 0], kr_new[:, 0])
    ckv_d = _gather_latent(pages["ckv"], block_tables)
    kr_d = _gather_latent(pages["kr"], block_tables)
    att_len = lengths + active.to(lengths.dtype)
    mask = (torch.arange(ckv_d.shape[1], device=x.device)[None]
            < att_len[:, None])[:, None]
    out = _mla_absorbed_attend(p, q_nope, q_rope, ckv_d, kr_d, mask,
                               n_heads=n_heads, kv_lora=kv_lora,
                               qk_nope=qk_nope, qk_rope=qk_rope,
                               v_dim=v_dim)
    return mm(out.to(x.dtype), p["wo"]), pages


def mla_prefill_paged_chunk(p, x, pages: Pages, block_tables, base, cos,
                            sin, *, n_heads: int, kv_lora: int,
                            qk_nope: int, qk_rope: int, v_dim: int,
                            eps: float = 1e-5) -> Tuple[torch.Tensor, Pages]:
    """One prompt chunk of a paged MLA prefill (see
    :func:`gqa_prefill_paged_chunk`)."""
    b, c, _ = x.shape
    q_nope, q_rope = _mla_q(p, x, n_heads, qk_nope, qk_rope, cos, sin)
    ckv_new, kr_new = _mla_latents(p, x, cos, sin, eps)        # [B,C,*]
    page = pages["ckv"].shape[1]
    pos = base + torch.arange(c, device=x.device)              # [C]
    tbl = block_tables.expand(b, block_tables.shape[1])
    page_ids = tbl[:, pos // page]                               # [B,C]
    offs = (pos % page)[None].expand(b, c)
    _write_latents(pages, page_ids, offs, ckv_new, kr_new)
    ckv_d = _gather_latent(pages["ckv"], tbl)
    kr_d = _gather_latent(pages["kr"], tbl)
    kpos = torch.arange(ckv_d.shape[1], device=x.device)[None, None]
    mask = (kpos <= pos[None, :, None]).expand(b, c, ckv_d.shape[1])
    out = _mla_absorbed_attend(p, q_nope, q_rope, ckv_d, kr_d, mask,
                               n_heads=n_heads, kv_lora=kv_lora,
                               qk_nope=qk_nope, qk_rope=qk_rope,
                               v_dim=v_dim)
    return mm(out.to(x.dtype), p["wo"]), pages
