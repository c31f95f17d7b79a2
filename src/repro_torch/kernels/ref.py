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


def flash_decode_split_plain(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor,
                             block_tables: torch.Tensor,
                             lengths: torch.Tensor, *, window: int = 0,
                             scale: Optional[float] = None,
                             split_keys: int) -> torch.Tensor:
    """:func:`flash_decode_plain` by the CUDA kernel's decomposition.

    The visible keys [lo, hi) of each sequence, lo = max(0, len - window),
    hi = min(len, max_pages * page), are cut into splits of ``split_keys``
    keys counted from lo.  Each split gives fp32 partials (m = its max
    score, l = sum e^(s - m), acc = sum e^(s - m) v), m = -1e30 and l = 0
    where it is empty; the splits are folded in order, M = max m_s, out =
    sum e^(m_s - M) acc_s / sum e^(m_s - M) l_s, zeros where no key is
    visible.  Same arguments as :func:`flash_decode_plain`.
    """
    b, hq, d = q.shape
    hkv, _, page, _ = k_pages.shape
    g = hq // hkv
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    k = gather_pages(k_pages, block_tables).float()    # [B, T, Hkv, D]
    v = gather_pages(v_pages, block_tables).float()
    t = k.shape[1]
    qg = q.reshape(b, hkv, g, d).float()
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k) * scale
    lens = lengths.long()[:, None]
    lo = (lens - window).clamp_min(0) if window else torch.zeros_like(lens)
    hi = lens.clamp_max(t)
    span = min(window, t) if window else t
    kpos = torch.arange(t, device=q.device)[None, :]
    ms, ls, accs = [], [], []
    for s in range(max(1, -(-span // split_keys))):
        s0 = lo + s * split_keys
        inside = ((kpos >= s0) & (kpos < torch.minimum(s0 + split_keys, hi))
                  )[:, None, None]                     # [B, 1, 1, T]
        sc = torch.where(inside, scores, torch.full_like(scores, NEG_INF))
        m = sc.amax(dim=-1)                            # [B, Hkv, G]
        p = torch.where(inside, torch.exp(sc - m[..., None]),
                        torch.zeros_like(sc))
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgt,btkd->bkgd", p, v))
    big_m = torch.stack(ms).amax(dim=0)
    num = torch.zeros_like(accs[0])
    den = torch.zeros_like(ls[0])
    for m, l, acc in zip(ms, ls, accs):
        w = torch.exp(m - big_m)
        num = num + w[..., None] * acc
        den = den + w * l
    seen = den[..., None] > 0
    out = torch.where(seen, num / torch.where(seen, den[..., None], 1.0),
                      torch.zeros_like(num))
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


# the CUDA kernel's decomposition (csrc/topk_compress.cu)
TOPK_DIGITS = (11, 11, 9)  # key bits 30..20, 19..9, 8..0 (DIGIT1..3)
TOPK_SMALL_N = 8192        # rows up to this take one CTA (SMALL_N)
TOPK_CHUNK = 16384         # elements per chunk of the compaction (CHUNK)
TOPK_CAP_SHIFT = 4         # candidates per large row: n >> TOPK_CAP_SHIFT


def topk_keys(x: torch.Tensor) -> torch.Tensor:
    """The kernel's keys: the fp32 bits of |x| (bf16 widened), as int64;
    their order is the magnitude order."""
    return x.float().view(torch.int32).to(torch.int64) & 0x7FFFFFFF


def topk_radix_select(x: torch.Tensor, k: int, *, cap: Optional[int] = None,
                      small_n: int = TOPK_SMALL_N,
                      digits: Tuple[int, ...] = TOPK_DIGITS):
    """The k-th largest key t of each row of x [rows, n], fixed digit by
    digit from the top as the kernel does: per digit, a histogram of the
    keys that match the digits fixed so far, walked from the top bin to
    the one that holds the left-th largest.  A large row (n > small_n)
    takes its last digit over the keys of digit 1's bin (the candidates
    pass B collects) when there are at most ``cap`` of them (default
    n >> TOPK_CAP_SHIFT), else over the row again.

    Returns per row (t, fill = k - #(key > t), keys in digit 1's bin, 0 for
    a small row, and whether the candidates were used), as lists."""
    rows, n = x.shape
    keys = topk_keys(x)
    cap = n >> TOPK_CAP_SHIFT if cap is None else min(int(cap), n)
    large = n > small_n
    ts, fills, c1s, used = [], [], [], []
    for r in range(rows):
        source, left, prefix, above = keys[r], int(k), 0, 31
        c1, use = 0, False
        for p, bits in enumerate(digits):
            shift = above - bits
            pool = source[(source >> above) == prefix]
            hist = torch.bincount((pool >> shift) & ((1 << bits) - 1),
                                  minlength=1 << bits)
            from_top = hist.flip(0).cumsum(0)
            j = int(torch.searchsorted(from_top, left))
            d = (1 << bits) - 1 - j
            left -= int(from_top[j] - hist[d])
            prefix, above = (prefix << bits) | d, shift
            if p == 0 and large:
                c1 = int(hist[d])
                use = c1 <= cap
            if p == 1 and use:
                source = pool                  # the candidates
        ts.append(prefix)
        fills.append(left)
        c1s.append(c1)
        used.append(use)
    return ts, fills, c1s, used


def topk_compress_radix_plain(x: torch.Tensor, k: int, *,
                              cap: Optional[int] = None,
                              small_n: int = TOPK_SMALL_N,
                              chunk: int = TOPK_CHUNK,
                              digits: Tuple[int, ...] = TOPK_DIGITS
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`topk_compress_plain` by the CUDA kernel's decomposition.

    t and fill come from :func:`topk_radix_select`.  A large row is then
    compacted chunk by chunk in index order, each chunk of ``chunk``
    elements given the row's counts of keys above t (gt) and equal to it
    (eq) in the chunks before it: its kept elements start at slot
    gt_before + min(fill, eq_before), and a tie is kept while its rank
    among the row's ties is below fill, so only the chunk where the taken
    ties end takes part of its ties.  A small row is one chunk.  Same
    arguments and outputs as :func:`topk_compress_plain`; ``cap``,
    ``small_n``, ``chunk`` and ``digits`` are the kernel's constants, which
    a test may change (a ``cap`` of 0 takes the path without candidates).
    """
    rows, n = x.shape
    ts, fills, _, _ = topk_radix_select(x, k, cap=cap, small_n=small_n,
                                        digits=digits)
    keys = topk_keys(x)
    step = n if n <= small_n else chunk
    vals = x.new_empty((rows, k))
    idx = torch.empty((rows, k), dtype=torch.int64, device=x.device)
    for r in range(rows):
        t, fill = ts[r], fills[r]
        gt_before = eq_before = 0
        for lo in range(0, n, step):
            kc = keys[r, lo:lo + step]
            gt, eq = kc > t, kc == t
            rank = eq_before + torch.cumsum(eq, 0) - eq.long()
            pos = torch.nonzero(gt | (eq & (rank < fill))).flatten()
            slot = gt_before + min(fill, eq_before) + torch.arange(
                len(pos), device=x.device)
            vals[r, slot] = x[r, lo + pos]
            idx[r, slot] = lo + pos
            gt_before += int(gt.sum())
            eq_before += int(eq.sum())
    return vals, idx.to(torch.int32)


# --------------------------------------------------------------------- #
# qint8: fused quantize + pack, and its inverse

QINT8_SCALE_BYTES = 4      # one fp32 scale per block, as int8[4]
QINT8_SCALE_FLOOR = 1e-12
# 1/127 rounded to fp32.  The reference divides by 127 in its source, and
# under jit XLA folds that division by a constant into a multiply by the
# constant's fp32 reciprocal (0.00787401572): that product, not the
# quotient, is the scale the reference puts on the wire; for some inputs
# the two differ in the last bit.
QINT8_INV_127 = 0.007874015718698502


def qint8_quantize_plain(x: torch.Tensor, block: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[rows, n] -> (q int8 [rows, nb, block], scale fp32 [rows, nb, 1]).

    Per block of ``block`` consecutive elements (the final partial block
    zero-padded): ``scale = max(max|x| * fp32(1/127), 1e-12)`` in fp32
    (what the reference's ``max|x| / 127`` computes under jit),
    ``q = clip(round(x / scale), -127, 127)`` with round half to even
    (``torch.round``, as ``jnp.round``).
    """
    rows, n = x.shape
    nb = -(-n // block)
    xb = x.float()
    if nb * block != n:
        xb = torch.nn.functional.pad(xb, (0, nb * block - n))
    xb = xb.reshape(rows, nb, block)
    scale = torch.amax(torch.abs(xb), dim=-1, keepdim=True) * QINT8_INV_127
    scale = torch.clamp(scale, min=QINT8_SCALE_FLOOR)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale


def qint8_dequantize_plain(q: torch.Tensor, scale: torch.Tensor,
                           n: int) -> torch.Tensor:
    """Inverse of :func:`qint8_quantize_plain`: ``q * scale`` in fp32 ->
    [rows, n] (padding stripped)."""
    return (q.float() * scale).reshape(q.shape[0], -1)[:, :n]


def qint8_pack_plain(x: torch.Tensor, block: int) -> torch.Tensor:
    """Fused quantize+pack: ``[rows, n] -> int8 [rows, nb, block + 4]``,
    each block's payload followed by its fp32 scale's four bytes,
    little-endian (``view(torch.int8)``, as JAX's bitcast).  Step for step
    ``repro/kernels/ref.py::qint8_pack_ref``."""
    q, scale = qint8_quantize_plain(x, block)
    return torch.cat([q, scale.view(torch.int8)], dim=-1)


def qint8_unpack_plain(wire: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`qint8_pack_plain`: ``int8 [rows, nb, block + 4]
    -> fp32 [rows, n]``, ``q * scale`` in fp32, padding stripped."""
    block = wire.shape[-1] - QINT8_SCALE_BYTES
    scale = wire[..., block:].clone(memory_format=torch.contiguous_format
                                     ).view(torch.float32)
    return qint8_dequantize_plain(wire[..., :block], scale, n)


# --------------------------------------------------------------------- #
# batched thin QR (CGS2)

QR_EPS = 1e-30             # rank-deficiency floor on a squared column norm


def batched_qr_plain(p: torch.Tensor, passes: int = 2) -> torch.Tensor:
    """Thin-QR Q factor of tall panels: ``[..., a, r] -> Q [..., a, r]``.

    Classical Gram-Schmidt with reorthogonalization (CGS2), the recurrence
    of the Pallas body ``repro/kernels/batched_qr.py::_qr_kernel`` in
    batched torch ops, in fp32: per column, ``passes`` projection passes
    against the columns already filled (two; ``passes=1`` is plain CGS,
    kept only as a control that loses orthogonality on ill-conditioned
    panels), then ``v * rsqrt(|v|^2)``, or an exact zero column when
    ``|v|^2 <= 1e-30``.  Column signs follow the input panel's.  This is
    not ``torch.linalg.qr``: that routine is Householder, like the
    reference's oracle, and completes a rank-deficient panel with some
    orthonormal direction where this gives zeros.
    """
    *lead, a, r = p.shape
    if a < r:
        raise ValueError(
            f"batched_qr needs a tall panel (a >= r), got {tuple(p.shape)}")
    x = p.reshape(-1, a, r).float()
    q = torch.zeros_like(x)
    for j in range(r):
        v = x[:, :, j:j + 1]                                 # [B, a, 1]
        for _ in range(passes):
            c = torch.sum(q * v, dim=1, keepdim=True)        # [B, 1, r]
            v = v - torch.sum(q * c, dim=2, keepdim=True)
        nrm2 = torch.sum(v * v, dim=1, keepdim=True)         # [B, 1, 1]
        inv = torch.where(nrm2 > QR_EPS, torch.rsqrt(nrm2),
                          torch.zeros_like(nrm2))
        q[:, :, j:j + 1] = v * inv
    return q.reshape(p.shape).to(p.dtype)


def qr_rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x) on fp32, correctly rounded, as the QR kernel forms it
    (``__frsqrt_rn``).  The fp64 value rounded to fp32 is within one fp32
    ulp of the answer; the midpoints m beside it decide, by the sign of
    m^2 x - 1, computed exactly: m^2 is exact in fp64 (25-bit m), split
    into a 26-bit and a 27-bit part whose products with x (24 bits) are
    exact, and hx - 1 is exact by Sterbenz's lemma (hx near 1).  Zero and
    non-finite inputs keep the fp64 value's rounding."""
    xd = x.double()
    y = (1.0 / torch.sqrt(xd)).float()
    zero = torch.zeros_like(y)
    lo = torch.nextafter(y, zero)
    hi = torch.nextafter(y, torch.full_like(y, torch.inf))

    def above_one(m):                           # sign of m^2 x - 1
        m2 = m * m
        c = 134217729.0 * m2                    # 2^27 + 1: Veltkamp split
        h = c - (c - m2)
        return (h * xd - 1.0) + (m2 - h) * xd

    yd = y.double()
    out = torch.where(above_one((yd + hi.double()) / 2) < 0, hi, y)
    out = torch.where(above_one((lo.double() + yd) / 2) > 0, lo, out)
    ok = torch.isfinite(x) & (x > 0) & torch.isfinite(y) & (y > 0)
    return torch.where(ok, out, y)


def batched_qr_blocked_plain(p: torch.Tensor, plan=None) -> torch.Tensor:
    """:func:`batched_qr_plain` in the CUDA kernel's own schedule and
    arithmetic (``csrc/batched_qr.cu``), for the tests and the on-card
    checks: every fp32 operation of the kernel, each ``fmaf`` rounded once
    (:func:`fmaf`), so that the kernel's Q should equal it to the bit.

    ``plan`` is the panel's ``kernels.batched_qr.PanelPlan`` (default
    ``panel_plan(a, r)``, the kernel's): its CTAs hold the row ranges of
    ``row_ranges``, and a CTA's thread t owns units t, t + threads, ... of
    ``unit`` rows.  A thread's partial of each sum is an fmaf chain over
    its rows in order from zero; the partials are summed over the warp's
    32 lanes by halves (a butterfly), then the warp sums over (CTA, warp)
    by halves.  A projection subtracts an fmaf chain over the earlier
    columns from zero; the norm's inverse is :func:`qr_rsqrt` (correctly
    rounded), or zero at or below ``QR_EPS``.  Same arguments and returns as the plain
    version."""
    from repro_torch.kernels.batched_qr import panel_plan
    *lead, a, r = p.shape
    if plan is None:
        plan = panel_plan(a, r)
    x = p.reshape(-1, a, r).float()
    b = x.shape[0]
    n, nthr = plan.ctas, plan.threads
    owned = [plan.thread_rows(lo, hi) for lo, hi in plan.row_ranges(a)]
    k_max = max(1, max(len(rows) for cta in owned for rows in cta))
    idx = torch.full((n, nthr, k_max), -1, dtype=torch.long)
    for c, cta in enumerate(owned):
        for t, rows in enumerate(cta):
            idx[c, t, :len(rows)] = torch.tensor(rows, dtype=torch.long)
    idx = idx.to(x.device)
    mask = idx >= 0                                    # [n, T, K]
    xs = x[:, idx.clamp(min=0), :]                     # [B, n, T, K, r]
    xs = torch.where(mask[None, ..., None], xs, torch.zeros_like(xs))
    cols = [xs[..., j] for j in range(r)]              # [B, n, T, K] each
    warps = nthr // 32

    def total(part):                                   # [B, n, T, ...]
        rest = part.shape[3:]
        s = _halving_sum(part.reshape(b, n, warps, 32, *rest), 3)
        return _halving_sum(s.reshape(b, n * warps, *rest), 1)

    def chain(u, v):                                   # [B, n, T]
        acc = torch.zeros(u.shape[:3], dtype=torch.float32, device=x.device)
        for k in range(k_max):
            acc = torch.where(mask[..., k], fmaf(u[..., k], v[..., k], acc),
                              acc)
        return acc

    for j in range(r):
        v = cols[j]
        for _ in range(2 if j else 0):
            c = total(torch.stack([chain(cols[k], v) for k in range(j)], -1))
            s = torch.zeros_like(v)
            for k in range(j):
                s = fmaf(cols[k], c[:, k, None, None, None].expand_as(v), s)
            v = v - s
        nrm = total(chain(v, v))                       # [B]
        inv = torch.where(nrm > QR_EPS, qr_rsqrt(nrm), torch.zeros_like(nrm))
        cols[j] = v * inv[:, None, None, None]
    q = torch.zeros_like(x)
    q[:, idx[mask], :] = torch.stack(cols, -1)[:, mask, :]
    return q.reshape(p.shape).to(p.dtype)


# --------------------------------------------------------------------- #
# causal / sliding-window GQA attention, forward and backward


def _attn_scores(q, k, *, causal: bool, window: int, scale: float):
    """fp32 scores [B, Hkv, G, S, T], masked to NEG_INF, and the grouped
    fp32 query [B, S, Hkv, G, D]."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, d).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(t, device=q.device)[None, :]
        m = kpos <= qpos
        if window:
            m &= (qpos - kpos) < window
        scores = torch.where(m, scores, torch.full_like(scores, NEG_INF))
    return scores, qg


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention with the semantics of the reference's
    ``flash_attention_ref``: q [B, S, Hq, D], k/v [B, T, Hkv, D] with
    Hq % Hkv == 0, query head h attending kv head h // (Hq / Hkv); under
    ``causal`` key j is visible to query i iff j <= i and (window == 0 or
    i - j < window), masked scores are -1e30 (``window`` applies only
    with ``causal``, as in the oracle).  Returns (out [B, S, Hq, D] in q's
    type, the fp32 log-sum-exp of each row's scores [B, Hq, S]: the
    residual the backward recomputes the probabilities from)."""
    b, s, hq, d = q.shape
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    scores, _ = _attn_scores(q, k, causal=causal, window=window,
                             scale=scale)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    lse = torch.logsumexp(scores, dim=-1).reshape(b, hq, s)
    return out.reshape(b, s, hq, d).to(q.dtype), lse


def flash_attention_backward_plain(q, k, v, o, lse, do, *,
                                   causal: bool = True, window: int = 0,
                                   scale: Optional[float] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Gradients of :func:`flash_attention_plain`'s output, in fp32:

        P = exp(S - lse);  dV = P^T dO;  dP = dO V^T;
        dS = P * (dP - rowsum(dO * O));  dQ = scale dS K;
        dK = scale dS^T Q

    with dK and dV summed over the Hq / Hkv query heads of each kv head.
    ``o`` and ``lse`` are the forward's outputs.  Returns (dq, dk, dv) in
    the types of q, k and v."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    scores, qg = _attn_scores(q, k, causal=causal, window=window,
                              scale=scale)
    p = torch.exp(scores - lse.reshape(b, hkv, g, s)[..., None])
    dog = do.reshape(b, s, hkv, g, d).float()
    rows = (dog * o.reshape(b, s, hkv, g, d).float()).sum(-1)  # [b,s,k,g]
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v.float())
    ds = p * (dp - rows.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float()) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg) * scale
    return (dq.reshape(b, s, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# --------------------------------------------------------------------- #
# the CUDA attention kernels' arithmetic, emulated

ATTN_ROW_PAD = 64          # query rows of the dK/dV kernel's padded blocks
# fp32 operands on the tensor cores: "tf32x3" (big + small TF32 parts,
# big.big + big.small + small.big: the kernels' scheme) or "tf32" (one
# TF32 part: a control the fp32 limit must reject)
FP32_SCHEMES = ("tf32x3", "tf32")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 explicit mantissa bits), ties
    away from zero, as ``cvt.rna.tf32.f32``: add half an ulp of TF32 to
    the bits and clear the 13 low ones.  Zeros, signed zeros and
    subnormals keep their sign; finite inputs only."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """x -> (big, small): big = tf32(x), small = tf32(x - big); x - big
    is exact in fp32, so big + small is x to about 2^-22 |x|."""
    x = x.float()
    big = tf32_round(x)
    return big, tf32_round(x - big)


def split_bf16(x: torch.Tensor):
    """x -> (hi, mid, lo): three bf16 values (as fp32), each the bf16
    rounding (nearest even) of what the earlier ones leave; they give x
    to about 2^-24 |x| (2^-27 where no exponent is lost)."""
    rest = x.float()
    out = []
    for _ in range(3):
        part = rest.to(torch.bfloat16).float()
        out.append(part)
        rest = rest - part
    return out


def _operand_terms(kind: str):
    """(split of the A operand, split of the B operand, the chunk of k one
    mma sums, the term pairs (i, j) of A part i times B part j, in the
    order the kernel issues them: smallest first)."""
    if kind == "bf16":          # A and B bf16 values: one exact product
        return (lambda x: [x.float()]), (lambda x: [x.float()]), 16, \
            [(0, 0)]
    if kind == "bf16p":         # A fp32 in three bf16 parts, B bf16
        return split_bf16, (lambda x: [x.float()]), 16, \
            [(2, 0), (1, 0), (0, 0)]
    if kind == "tf32x3":
        return split_tf32, split_tf32, 8, [(1, 0), (0, 1), (0, 0)]
    if kind == "tf32":
        return (lambda x: [tf32_round(x)]), (lambda x: [tf32_round(x)]), \
            8, [(0, 0)]
    raise ValueError(f"unknown operand scheme {kind!r}")


def split_matmul(a: torch.Tensor, b: torch.Tensor, kind: str, *,
                 init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``init + a @ b`` (a [..., M, K], b [..., K, N]) in the kernels'
    order: K in chunks of one mma's depth; in each chunk the split
    operands' term products summed into a zeroed fp32 fragment, smallest
    term first, which is then added to the running sum in fp32, chunk
    after chunk.  A K that is not a multiple of the chunk is padded with
    zeros, as the kernels' tiles are.  Not bit for bit: the kernels chain
    a chunk's terms in one tensor-core accumulator, whose additions
    truncate, where this sums them in fp32 with round to nearest (the
    kernels agree with it to within 1e-6 of max|output| on the card,
    PERF.md)."""
    split_a, split_b, chunk, terms = _operand_terms(kind)
    kk = a.shape[-1]
    pad = -kk % chunk
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    pa, pb = split_a(a), split_b(b)
    out = init
    for c0 in range(0, kk + pad, chunk):
        c1 = c0 + chunk
        part = None
        for i, j in terms:
            t = pa[i][..., c0:c1] @ pb[j][..., c0:c1, :]
            part = t if part is None else part + t
        out = part if out is None else out + part
    return out


def _attn_operands(dtype, fp32_scheme: str):
    """(scheme of the products of two inputs, of an fp32 matrix -- P or
    dS -- and an input) for inputs of ``dtype``."""
    if dtype == torch.bfloat16:
        return "bf16", "bf16p"
    if fp32_scheme not in FP32_SCHEMES:
        raise ValueError(f"fp32_scheme {fp32_scheme!r} not in "
                         f"{FP32_SCHEMES}")
    return fp32_scheme, fp32_scheme


def attn_tiles(dtype, d: int) -> Tuple[int, int]:
    """(query rows, keys) of a forward tile of ``csrc/flash_attention.cu``
    (its ``Cfg``): fp32 8 warps of 16 rows and 32-key tiles at D 128
    (64 below), bf16 4 warps and 32 keys."""
    if dtype == torch.bfloat16:
        return 64, 32
    return 128, 32 if d == 128 else 64


def _attn_blocks(q0: int, rows: int, kb: int, t: int, window: int):
    """Key blocks of ``kb`` keys [lo, hi) that query rows [q0, q0 + rows)
    can see (the kernels' ``key_blocks``)."""
    hi = min(-(-t // kb), (q0 + rows - 1) // kb + 1)
    first = q0 - (window - 1)
    lo = first // kb if window > 0 and first > 0 else 0
    return lo, hi


def _grouped(q, k, v):
    """q [B, S, Hq, D] -> [B, Hkv, G, S, D]; k/v -> [B, Hkv, 1, T, D]."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4)
    return qg, k.permute(0, 2, 1, 3)[:, :, None], \
        v.permute(0, 2, 1, 3)[:, :, None]


def _visible(s: int, t: int, window: int, device):
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    vis = kpos <= qpos
    if window:
        vis &= (qpos - kpos) < window
    return vis


def flash_attention_split_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, window: int = 0,
                                scale: Optional[float] = None,
                                fp32_scheme: str = "tf32x3"
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The causal forward of ``csrc/flash_attention.cu`` in PyTorch:
    what :func:`flash_attention_plain` computes, by the kernel's tiling,
    operand splits and order of sums (:func:`split_matmul`).

    Per block of query rows, the key blocks it can see in order (tiles
    of :func:`attn_tiles`); S =
    Q K^T by :func:`split_matmul` (bf16 inputs: one exact product per 16
    dims; fp32 inputs: ``fp32_scheme`` per 8 dims), masked to -1e30, an
    fp32 online softmax (m, l) per row, and acc = alpha acc + P V with P
    in three bf16 parts (bf16 inputs) or by ``fp32_scheme``.  The
    output is acc / l (l == 0 guarded) in q's type, lse = m + log l.
    Used by the tests and chip_smoke.py, never on the main path."""
    b, s, hq, d = q.shape
    t = k.shape[1]
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    ab, pv = _attn_operands(q.dtype, fp32_scheme)
    qg, kt, vt = _grouped(q, k, v)
    scores = split_matmul(qg, kt.transpose(-1, -2), ab) * scale
    vis = _visible(s, t, window, q.device)
    scores = torch.where(vis, scores, torch.full_like(scores, NEG_INF))
    bq, bk = attn_tiles(q.dtype, d)
    outs, lses = [], []
    for q0 in range(0, s, bq):
        q1 = min(q0 + bq, s)
        rows = scores[..., q0:q1, :]
        m = torch.full(rows.shape[:-1] + (1,), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(rows.shape[:-1] + (d,), device=q.device)
        lo, hi = _attn_blocks(q0, bq, bk, t, window)
        for kb in range(lo, hi):
            k0, k1 = kb * bk, min(kb * bk + bk, t)
            sc = rows[..., k0:k1]
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            m = m_new
            acc = split_matmul(p, vt[..., k0:k1, :], pv, init=acc * alpha)
        empty = l == 0.0
        outs.append(acc / torch.where(empty, 1.0, l))
        lses.append(torch.where(empty, NEG_INF, m + torch.log(l))[..., 0])
    out = torch.cat(outs, dim=-2).permute(0, 3, 1, 2, 4)
    lse = torch.cat(lses, dim=-1).reshape(b, hq, s)
    return out.reshape(b, s, hq, d).to(q.dtype), lse


def flash_attention_split_backward_plain(q, k, v, o, lse, do, *,
                                         window: int = 0,
                                         scale: Optional[float] = None,
                                         fp32_scheme: str = "tf32x3"
                                         ) -> Tuple[torch.Tensor,
                                                    torch.Tensor,
                                                    torch.Tensor]:
    """The causal backward of ``csrc/flash_attention.cu`` in PyTorch, by
    its arithmetic: delta = rowsum(dO O) in fp32; S = Q K^T and dP =
    dO V^T per mma chunk as in the forward; P = exp(scale S - lse) where
    visible, else 0; dS = P (dP - delta); dQ = scale sum over the key
    blocks of dS K (the dQ kernel), dV = sum over the group's query heads
    and the query blocks of P^T dO and dK = scale (the same of dS^T Q)
    (the dK/dV kernel), each product with P or dS split as the forward
    splits P.  Query rows are padded to whole blocks, which weigh 0.
    Returns (dq, dk, dv) in the inputs' types."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    ab, pv = _attn_operands(q.dtype, fp32_scheme)
    qg, kt, vt = _grouped(q, k, v)
    dog = do.reshape(b, s, hkv, g, d).permute(0, 2, 3, 1, 4)
    og = o.reshape(b, s, hkv, g, d).permute(0, 2, 3, 1, 4)
    delta = (dog.float() * og.float()).sum(-1, keepdim=True)
    lse_g = lse.reshape(b, hkv, g, s)[..., None]
    sc = split_matmul(qg, kt.transpose(-1, -2), ab)
    dp = split_matmul(dog, vt.transpose(-1, -2), ab)
    vis = _visible(s, t, window, q.device)
    p = torch.where(vis, torch.exp(sc * scale - lse_g), torch.zeros_like(sc))
    ds = p * (dp - delta)
    dq = split_matmul(ds, kt, pv) * scale
    # dK/dV: the contraction runs over the group's heads, then the query
    # rows of each (padded) block, in the kernel's order
    pad = -s % ATTN_ROW_PAD

    def flat(x):       # [B, Hkv, G, S, N] -> [B, Hkv, N, G * S_padded]
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        return x.permute(0, 1, 4, 2, 3).reshape(b, hkv, x.shape[-1], -1)

    def rows(x):       # [B, Hkv, G, S, D] -> [B, Hkv, G * S_padded, D]
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
        return x.reshape(b, hkv, -1, d)

    dv = split_matmul(flat(p), rows(dog), pv)
    dk = split_matmul(flat(ds), rows(qg), pv) * scale
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


# --------------------------------------------------------------------- #
# RWKV-6 WKV recurrence, forward and backward

WKV_CHUNK = 64             # steps between the forward's state checkpoints


def _per_batch_u(u: torch.Tensor, b: int) -> torch.Tensor:
    """u [H, D] (the reference's) or [B, H, D] (per batch row, as the
    kernel takes it under the trainer's vmap) -> fp32 [B, H, D]."""
    return (u if u.dim() == 3 else u.expand(b, *u.shape)).float()


def rwkv6_wkv_forward_plain(r, k, v, w, u, state
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The time loop of the reference's ``rwkv6_wkv_ref`` in fp32:

        y_t[i]  = sum_j r_t[j] (S[j,i] + u[j] k_t[j] v_t[i])
        S'[j,i] = w_t[j] S[j,i] + k_t[j] v_t[i]

    r/k/v/w [B, S, H, D]; u [H, D] or [B, H, D]; state [B, H, D, D]
    (indexed [j, i]).  Returns (y [B, S, H, D] in r's type, the final
    state fp32, and the state at the start of every WKV_CHUNK steps, fp32
    [B, H, ceil(S / WKV_CHUNK), D, D]: the backward's checkpoints)."""
    b, s, h, d = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = _per_batch_u(u, b)[..., None]                      # [B,H,D,1]
    st = state.float()
    ys, ckpts = [], []
    for t in range(s):
        if t % WKV_CHUNK == 0:
            ckpts.append(st)
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]      # [B,H,D,D]
        ys.append(torch.einsum("bhj,bhji->bhi", rf[:, t], st + uf * kv))
        st = wf[:, t, :, :, None] * st + kv
    return torch.stack(ys, 1).to(r.dtype), st, torch.stack(ckpts, 2)


def rwkv6_wkv_plain(r, k, v, w, u, state
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, final state) of :func:`rwkv6_wkv_forward_plain`: the
    reference's ``rwkv6_wkv_ref``."""
    y, st, _ = rwkv6_wkv_forward_plain(r, k, v, w, u, state)
    return y, st


def rwkv6_wkv_backward_plain(r, k, v, w, u, ckpt, dy, dsT):
    """Gradients of (y, final state) by the explicit reverse recurrence.

    With G the adjoint of the state, from G = dsT, for t = S-1 ... 0 (the
    forward state S_t recomputed from the chunk's checkpoint, never from
    S_{t+1}, since w may be near 0):

        dr_t[j] = sum_i dy_t[i] (S_t[j,i] + u[j] k_t[j] v_t[i])
        du[j]  += r_t[j] k_t[j] sum_i dy_t[i] v_t[i]
        dk_t[j] = u[j] r_t[j] sum_i dy_t[i] v_t[i] + sum_i G[j,i] v_t[i]
        dv_t[i] = dy_t[i] sum_j r_t[j] u[j] k_t[j] + sum_j G[j,i] k_t[j]
        dw_t[j] = sum_i G[j,i] S_t[j,i]
        G[j,i]  = w_t[j] G[j,i] + r_t[j] dy_t[i]      (after the lines above)

    and the initial state's gradient is the last G.  ``ckpt`` is the
    forward's [B, H, NC, D, D].  Returns (dr, dk, dv, dw in the inputs'
    types, du fp32 [B, H, D] per batch row, ds0 fp32 [B, H, D, D])."""
    b, s, h, d = r.shape
    rf, kf, vf, wf, dyf = (x.float() for x in (r, k, v, w, dy))
    uf = _per_batch_u(u, b)
    grads = [torch.empty((b, s, h, d), device=r.device) for _ in range(4)]
    dr, dk, dv, dw = grads
    du = torch.zeros((b, h, d), device=r.device)
    g = dsT.float()
    for c in reversed(range(ckpt.shape[2])):
        t0, t1 = c * WKV_CHUNK, min(s, (c + 1) * WKV_CHUNK)
        st = ckpt[:, :, c].float()
        states = []
        for t in range(t0, t1):
            states.append(st)
            st = wf[:, t, :, :, None] * st + \
                kf[:, t, :, :, None] * vf[:, t, :, None, :]
        for t in reversed(range(t0, t1)):
            st = states[t - t0]
            r_t, k_t, v_t, w_t, dy_t = (x[:, t] for x in (rf, kf, vf, wf,
                                                          dyf))
            dyv = (dy_t * v_t).sum(-1, keepdim=True)          # [B,H,1]
            ruk = (r_t * uf * k_t).sum(-1, keepdim=True)
            dr[:, t] = torch.einsum("bhji,bhi->bhj", st, dy_t) \
                + uf * k_t * dyv
            du += r_t * k_t * dyv
            dk[:, t] = uf * r_t * dyv + torch.einsum("bhji,bhi->bhj", g, v_t)
            dv[:, t] = dy_t * ruk + torch.einsum("bhji,bhj->bhi", g, k_t)
            dw[:, t] = (g * st).sum(-1)
            g = w_t[..., None] * g + r_t[..., None] * dy_t[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du, g)


WKV_FWD_TR = 8             # state rows a thread of the forward kernel owns
WKV_FWD_TC = 4             # state columns it owns
WKV_FWD_STAGE = 16         # steps a stage of the forward's input ring holds


def _halving_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` (a power of two long) by halves: entry i with
    i + n / 2, then the same on the result; a butterfly's order over lane
    bits from the highest down."""
    while x.shape[dim] > 1:
        lo, hi = x.chunk(2, dim)
        x = lo + hi
    return x.squeeze(dim)


def fmaf(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c on fp32 tensors with one rounding, as CUDA's ``fmaf``.

    The product is exact in fp64; the fp64 sum is made round-to-odd (its
    error, by TwoSum, nudges an inexact even result one ulp towards the
    exact value), and a round-to-odd fp64 value rounds to fp32 as the exact
    value does, so the result is the correctly rounded fma."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bp = s - p
    err = (p - (s - bp)) + (cd - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def rwkv6_wkv_forward_blocked_plain(r, k, v, w, u, state, *,
                                    tile: Tuple[int, int] = (WKV_FWD_TR,
                                                             WKV_FWD_TC),
                                    stage: int = WKV_FWD_STAGE
                                    ) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """:func:`rwkv6_wkv_forward_plain` in the CUDA forward's own schedule
    and arithmetic (``csrc/rwkv6_wkv.cu``), for the tests and the on-card
    checks: every fp32 operation of the kernel, each ``fmaf`` rounded once
    (:func:`fmaf`), so that the kernel's outputs should equal it to the
    bit.

    The D x D state in ``tile`` = (rows, columns) tiles, one a thread (a
    whole number of warps), each entry updated as fmaf(w_j, S, k_j v_i).
    Per step, y's partial of each row group is an fmaf chain over the
    tile's rows in order (the first row a product); once per stage of
    ``stage`` steps, the row groups' partials are summed in order 0, 1,
    ..; q_t = r_t . (u k_t) once per step, an fmaf chain over 4
    consecutive j a lane, then summed over the D / 4 lanes by halves (a
    butterfly); y_t = fmaf(v_t, q_t, that sum).  The states differ from
    the plain forward's (which rounds w S and adds k v) by rounding only.
    Same arguments and returns as the plain forward."""
    b, s, h, d = r.shape
    tr, tc = tile
    if d % tr or d % tc or (d // tr) * (d // tc) % 32:
        raise ValueError(f"tile {tile} does not fill whole warps at head "
                         f"size {d}")
    if WKV_CHUNK % stage:
        raise ValueError(f"stage={stage} does not divide the checkpoint "
                         f"interval {WKV_CHUNK}")
    groups = d // tr
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = _per_batch_u(u, b)
    st = state.float()
    ys, ckpts = [], []
    for t0 in range(0, s, stage):
        steps = range(t0, min(t0 + stage, s))
        parts = []                                 # [B, H, groups, D] a step
        for t in steps:
            if t % WKV_CHUNK == 0:
                ckpts.append(st)
            rows = st.reshape(b, h, groups, tr, d)
            rt = rf[:, t].reshape(b, h, groups, tr, 1)
            acc = rt[..., 0, :] * rows[..., 0, :]
            for p in range(1, tr):
                acc = fmaf(rt[..., p, :], rows[..., p, :], acc)
            parts.append(acc)
            st = fmaf(wf[:, t, :, :, None], st,
                      kf[:, t, :, :, None] * vf[:, t, :, None, :])
        for t, part in zip(steps, parts):
            acc = part[:, :, 0]
            for g in range(1, groups):
                acc = acc + part[:, :, g]
            rl = rf[:, t].reshape(b, h, d // 4, 4)
            ukl = (uf * kf[:, t]).reshape(b, h, d // 4, 4)
            q = rl[..., 0] * ukl[..., 0]
            for e in range(1, 4):
                q = fmaf(rl[..., e], ukl[..., e], q)
            q = _halving_sum(q, 2)[..., None].expand(b, h, d)
            ys.append(fmaf(vf[:, t], q, acc))
    return torch.stack(ys, 1).to(r.dtype), st, torch.stack(ckpts, 2)


WKV_BWD_ROWS = 16          # state rows per CTA of the backward kernel
WKV_BWD_SUB = 8            # steps between its on-chip sub-checkpoints


def rwkv6_wkv_backward_blocked_plain(r, k, v, w, u, ckpt, dy, dsT, *,
                                     rows: int = WKV_BWD_ROWS,
                                     sub: int = WKV_BWD_SUB):
    """:func:`rwkv6_wkv_backward_plain` in the CUDA backward's own
    schedule (``csrc/rwkv6_wkv.cu``), for the tests and the on-card
    checks: the state's D rows in blocks of ``rows`` (one CTA each of a
    cluster of D / rows), each chunk walked forward from its checkpoint
    to a sub-checkpoint every ``sub`` steps, each sub-chunk's states
    recomputed from its sub-checkpoint and consumed in reverse; dy.v once
    per step; each block's dv partial (its rows' sum of G k, plus dy times
    its rows' r.u k) summed over the blocks in order 0, 1, ...  Same
    arguments and returns as the plain backward."""
    b, s, h, d = r.shape
    if d % rows:
        raise ValueError(f"head size {d} is not a multiple of rows={rows}")
    nb = d // rows
    rf, kf, vf, wf, dyf = (x.float() for x in (r, k, v, w, dy))
    blk = lambda x: x.reshape(*x.shape[:-1], nb, rows)  # noqa: E731
    uf = blk(_per_batch_u(u, b))                        # [B,H,nb,rows]
    rb, kb, wb = blk(rf), blk(kf), blk(wf)              # [B,S,H,nb,rows]
    dyv = (dyf * vf).sum(-1)                            # [B,S,H]
    ruk = (rb * uf[:, None] * kb).sum(-1)               # [B,S,H,nb]
    grads = [torch.empty((b, s, h, nb, rows), device=r.device)
             for _ in range(3)]
    dr, dk, dw = grads
    dv_parts = torch.empty((nb, b, s, h, d), device=r.device)
    du = torch.zeros((b, h, nb, rows), device=r.device)
    g = dsT.float().reshape(b, h, nb, rows, d)          # G, by block

    def step(st, t):                                    # S_t -> S_{t+1}
        return wb[:, t, ..., None] * st + \
            kb[:, t, ..., None] * vf[:, t, :, None, None, :]

    for c in reversed(range(ckpt.shape[2])):
        t0, t1 = c * WKV_CHUNK, min(s, (c + 1) * WKV_CHUNK)
        st = ckpt[:, :, c].float().reshape(b, h, nb, rows, d)
        subs = []
        for ta in range(t0, t1, sub):
            subs.append(st)
            for t in range(ta, min(ta + sub, t1)):
                st = step(st, t)
        for ta, st in reversed(list(zip(range(t0, t1, sub), subs))):
            states = []
            for t in range(ta, min(ta + sub, t1)):
                states.append(st)
                st = step(st, t)
            for t in reversed(range(ta, min(ta + sub, t1))):
                st = states[t - ta]
                r_t, k_t, w_t = rb[:, t], kb[:, t], wb[:, t]
                v_t, dy_t, dyv_t = vf[:, t], dyf[:, t], dyv[:, t]
                dvv = dyv_t[..., None, None]
                dr[:, t] = torch.einsum("bhnji,bhi->bhnj", st, dy_t) \
                    + uf * k_t * dvv
                du += r_t * k_t * dvv
                dk[:, t] = uf * r_t * dvv \
                    + torch.einsum("bhnji,bhi->bhnj", g, v_t)
                dw[:, t] = (g * st).sum(-1)
                dv_parts[:, :, t] = (
                    dy_t[:, :, None] * ruk[:, t, ..., None]
                    + torch.einsum("bhnji,bhnj->bhni", g, k_t)
                ).permute(2, 0, 1, 3)
                g = w_t[..., None] * g + r_t[..., None] * dy_t[:, :, None,
                                                                None, :]
    dv = dv_parts[0]
    for part in dv_parts[1:]:
        dv = dv + part
    flat = lambda x, like: x.reshape(b, s, h, d).to(like.dtype)  # noqa: E731
    return (flat(dr, r), flat(dk, k), dv.to(v.dtype), flat(dw, w),
            du.reshape(b, h, d), g.reshape(b, h, d, d))
