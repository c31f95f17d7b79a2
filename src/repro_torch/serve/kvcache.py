"""KV-cache accounting + the paged-cache block allocator (PyTorch port
of ``repro/serve/kvcache.py``; host-side Python, copied).

Cache construction itself lives with each model family
(ModelBundle.init_cache / init_paged_cache): full GQA cache, rolling
sliding-window buffer, compressed MLA latents, RWKV/Mamba constant-size
states.  These helpers size them for serving/dry-run planning, and
:class:`BlockAllocator` owns the page pool of the paged serving engine
(serve/engine.py PagedServeEngine): fixed-size pages, per-sequence block
tables, admission reservations gated by the same ``cache_bytes``
accounting, pages freed and reused the moment a sequence finishes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ArchConfig


def cache_bytes(cfg: ArchConfig, batch: int, max_len: int,
                *, rolling: bool = False, cache_dtype=torch.bfloat16) -> int:
    """Analytic per-replica cache size in bytes."""
    esize = cache_dtype.itemsize
    L = cfg.n_layers
    if cfg.family == "ssm":
        hd = cfg.resolved_head_dim
        per = cfg.ssm_heads * hd * hd * 4 + 2 * cfg.d_model * 4
        return batch * L * per
    if cfg.family == "hybrid":
        w = cfg.sliding_window
        kv = 2 * w * cfg.n_kv_heads * cfg.resolved_head_dim * esize
        di = cfg.d_model * cfg.ssm_expand
        ssm = di * cfg.ssm_state * 4 + 3 * di * 4
        return batch * L * (kv + ssm)
    if cfg.kv_lora_rank:
        per = max_len * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * esize
        return batch * L * per
    length = cfg.long_context_window if rolling else max_len
    per = 2 * length * cfg.n_kv_heads * cfg.resolved_head_dim * esize
    # encoder-decoder archs also hold a cross-attention K/V cache per
    # decoder layer (over the encoder sequence) — same per-position cost
    n_layers = L + (cfg.n_layers if cfg.is_encoder_decoder else 0)
    return batch * n_layers * per


def page_bytes(cfg: ArchConfig, page_size: int,
               *, cache_dtype=torch.bfloat16) -> int:
    """Bytes one pool page (``page_size`` cache positions, all layers)
    costs — ``cache_bytes`` at batch=1, max_len=page_size.  The unit the
    paged engine's admission accounting is denominated in."""
    return cache_bytes(cfg, 1, page_size, cache_dtype=cache_dtype)


def describe_cache(cfg: ArchConfig, batch: int, max_len: int,
                   *, rolling: bool = False) -> Dict[str, Any]:
    b = cache_bytes(cfg, batch, max_len, rolling=rolling)
    kind = ("ssm-state" if cfg.family == "ssm"
            else "hybrid(window+state)" if cfg.family == "hybrid"
            else "mla-latent" if cfg.kv_lora_rank
            else "rolling-window" if rolling else "full-kv")
    return {"kind": kind, "bytes": b, "gib": b / 2 ** 30,
            "bytes_per_seq": b // max(batch, 1)}


# ===================================================================== #
# paged pool allocator
# ===================================================================== #

def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` cache positions."""
    return -(-n_tokens // page_size)


@dataclasses.dataclass
class BlockAllocator:
    """Host-side free-list allocator for the paged KV pool.

    Page ids index the device-side pool arrays ([Hkv, P, page, D] per
    layer).  Page 0 is reserved as the **null page**: unallocated block-
    table entries point at it (so gathers always read a valid index) and
    masked-out writes from inactive slots land there — it is never handed
    to a sequence.

    Admission is two-phase so decode can grow tables on demand without
    ever deadlocking mid-sequence:

      * ``reserve(n)`` at admission claims capacity for the sequence's
        worst case (prompt + max_new tokens) without pinning physical
        pages; refuse admission when it fails.
      * ``take()`` converts one reservation unit into a physical page id
        as the sequence actually reaches it (prefill chunks, then decode
        crossing a page boundary).
      * ``release(pages, reserved)`` returns both the moment the
        sequence finishes — the freed pages are immediately reusable by
        the next admission.
    """

    n_pages: int                       # pool size INCLUDING the null page
    _free: List[int] = dataclasses.field(default_factory=list)
    _reserved: int = 0
    # high-water mark of physical pages handed out, for pool-sizing tests
    peak_in_use: int = 0

    def __post_init__(self):
        if self.n_pages < 2:
            raise ValueError(f"pool needs >= 2 pages (one is the null "
                             f"page), got {self.n_pages}")
        self._free = list(range(self.n_pages - 1, 0, -1))  # pop() -> low ids

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Physical pages currently handed out (telemetry gauge)."""
        return self.n_pages - 1 - len(self._free)

    @property
    def unreserved_pages(self) -> int:
        return len(self._free) - self._reserved

    def reserve(self, n: int) -> bool:
        """Claim capacity for ``n`` pages; False if it would oversubscribe."""
        if n > self.unreserved_pages:
            return False
        self._reserved += n
        return True

    def take(self) -> int:
        """Convert one reserved unit into a physical page id."""
        if self._reserved <= 0:
            raise RuntimeError("take() without a matching reserve()")
        if not self._free:
            raise RuntimeError("page pool exhausted despite reservation")
        self._reserved -= 1
        page = self._free.pop()
        in_use = self.n_pages - 1 - len(self._free)
        self.peak_in_use = max(self.peak_in_use, in_use)
        return page

    def release(self, pages: List[int], reserved_left: int = 0) -> None:
        """Return a finished sequence's pages + unused reservation."""
        for p in pages:
            if not 0 < p < self.n_pages:
                raise ValueError(f"bad page id {p}")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
        self._free.extend(pages)
        if reserved_left < 0 or reserved_left > self._reserved:
            raise ValueError(f"bad reservation release {reserved_left} "
                             f"(outstanding {self._reserved})")
        self._reserved -= reserved_left


def pool_pages(cfg: ArchConfig, page_size: int, *,
               budget_bytes: Optional[int] = None,
               slots: int = 0, max_len: int = 0,
               cache_dtype=torch.bfloat16) -> int:
    """Size the page pool (incl. the null page).

    With ``budget_bytes`` the pool is whatever the byte budget buys at
    ``page_bytes`` per page (the ``cache_bytes``-gated admission story);
    otherwise it defaults to every slot holding a full ``max_len``
    sequence (the dense-equivalent worst case).
    """
    if budget_bytes is not None:
        n = budget_bytes // max(1, page_bytes(cfg, page_size,
                                              cache_dtype=cache_dtype))
    else:
        n = slots * pages_for(max_len, page_size)
    return int(n) + 1              # + null page
