"""Decoder-LM assembly for the paged serving path (PyTorch port of
``repro/models/transformer.py``, dense GQA family).

The reference stacks layer parameters ``[L, ...]`` and scans over them;
the port keeps an ``nn.ModuleList`` of layers whose parameter names are
the reference's leaf paths (``layers.<i>.attn.wq`` for ``layers/attn/wq``
row ``i``), so ``repro_torch/convert.py`` carries weights across by
splitting the stacks.  The paged pool is a list of per-layer
``{"k", "v"}`` tensors, updated in place.

Ported: ``init``, ``init_paged_cache``, ``prefill_paged_chunk`` and
``decode_step_paged`` for dense GQA decoders (with or without a sliding
window).  Training, the dense-cache serving path and the other families
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import (GQA, Pages, gqa_decode_paged,
                                          gqa_prefill_paged_chunk,
                                          init_paged_kv)
from repro_torch.models.common import (dense_init, embed_init, rmsnorm,
                                       rmsnorm_init, rope_cos_sin)
from repro_torch.models.mlp import MLP, mlp_apply


def unsupported_reason(cfg: ArchConfig) -> Optional[str]:
    """Why the port cannot build ``cfg`` yet (None if it can)."""
    if cfg.family in ("ssm", "hybrid", "audio") or cfg.is_encoder_decoder:
        return (f"family '{cfg.family}' is not ported yet "
                f"(ROADMAP Queue 1: remaining model families)")
    if cfg.uses_moe:
        return "MoE layers are not ported yet (ROADMAP Queue 1: MoE)"
    if cfg.kv_lora_rank:
        return "MLA attention is not ported yet (ROADMAP Queue 1: MLA)"
    if cfg.mrope or cfg.family == "vlm":
        return ("M-RoPE and the VLM frontend are not ported yet "
                "(ROADMAP Queue 1: M-RoPE)")
    return None


# ===================================================================== #
# decoder layer (dense GQA)
# ===================================================================== #

class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, *, device):
        super().__init__()
        self.scale = nn.Parameter(rmsnorm_init(d, dtype, device=device))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype, *, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.ln1 = RMSNorm(cfg.d_model, dtype, device=device)
        self.attn = GQA(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.resolved_head_dim, dtype, **kw)
        self.ln2 = RMSNorm(cfg.d_model, dtype, device=device)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype, **kw)


class DecoderLM(nn.Module):
    """Parameters: ``embed`` [V, d], ``final_norm.scale``, ``lm_head``
    [d, V] (unless tied), ``layers`` (one :class:`DecoderLayer` each)."""

    def __init__(self, cfg: ArchConfig, dtype, *, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.embed = nn.Parameter(embed_init(cfg.padded_vocab, cfg.d_model,
                                             dtype, **kw))
        self.final_norm = RMSNorm(cfg.d_model, dtype, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(dense_init(
                cfg.d_model, cfg.padded_vocab, dtype, **kw))
        self.layers = nn.ModuleList(
            [DecoderLayer(cfg, dtype, **kw) for _ in range(cfg.n_layers)])


def _layer_ffn(p: DecoderLayer, x, cfg: ArchConfig):
    h = rmsnorm(p.ln2.scale, x, cfg.norm_eps)
    return x + mlp_apply(p.ffn, h, cfg.act)


def layer_decode_paged(p: DecoderLayer, x, pages: Pages, block_tables,
                       lengths, active, cos, sin, cfg: ArchConfig,
                       decode_impl: str):
    """One layer of the paged decode step (per-slot positions)."""
    h = rmsnorm(p.ln1.scale, x, cfg.norm_eps)
    a, pages = gqa_decode_paged(
        p.attn, h, pages, block_tables, lengths, active, cos, sin,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, window=cfg.sliding_window,
        impl=decode_impl)
    return _layer_ffn(p, x + a, cfg), pages


def layer_prefill_paged(p: DecoderLayer, x, pages: Pages, block_tables,
                        base, cos, sin, cfg: ArchConfig):
    """One layer of one paged-prefill chunk (positions base..base+C-1)."""
    h = rmsnorm(p.ln1.scale, x, cfg.norm_eps)
    a, pages = gqa_prefill_paged_chunk(
        p.attn, h, pages, block_tables, base, cos, sin,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, window=cfg.sliding_window)
    return _layer_ffn(p, x + a, cfg), pages


# ===================================================================== #
# bundle
# ===================================================================== #

@dataclasses.dataclass
class ModelBundle:
    """The paged-serving surface of the reference's ``ModelBundle``:

      init(generator=None)                 -> DecoderLM (the params)
      init_paged_cache(n_pages, page_size) -> [ {"k", "v"} ] per layer
      prefill_paged_chunk(params, tokens [B,C], pages, tables, base)
          -> (logits [B,C,V], pages)
      decode_step_paged(params, tokens [B], pages, tables, lengths,
          active) -> (logits [B,V], pages)
    """
    cfg: ArchConfig
    device: torch.device
    init: Callable
    init_paged_cache: Optional[Callable] = None
    prefill_paged_chunk: Optional[Callable] = None
    decode_step_paged: Optional[Callable] = None


def _unembed(params: DecoderLM, cfg: ArchConfig, x):
    if cfg.tie_embeddings:
        return x @ params.embed.T
    return x @ params.lm_head


def build_decoder_lm(cfg: ArchConfig, *, param_dtype=torch.float32,
                     cache_dtype=torch.bfloat16, decode_impl: str = "auto",
                     device="cuda",
                     generator: Optional[torch.Generator] = None
                     ) -> ModelBundle:
    """Dense GQA decoders.  ``decode_impl`` picks the paged decode
    attention (kernels/ops.py::flash_decode: "auto" / "kernel" /
    "plain"); it only affects ``decode_step_paged``.  The pool's dtype is
    ``cache_dtype`` (bf16 by default, even with fp32 params)."""
    reason = unsupported_reason(cfg)
    if reason:
        raise NotImplementedError(f"{cfg.name}: {reason}")
    device = torch.device(device)
    hd = cfg.resolved_head_dim

    def init(gen: Optional[torch.Generator] = None) -> DecoderLM:
        gen = gen if gen is not None else generator
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(0)
        return DecoderLM(cfg, param_dtype, device=device, generator=gen)

    def init_paged_cache(n_pages: int, page_size: int) -> List[Pages]:
        return [init_paged_kv(n_pages, page_size, cfg.n_kv_heads, hd,
                              cache_dtype, device=device)
                for _ in range(cfg.n_layers)]

    def prefill_paged_chunk(params: DecoderLM, tokens, pages: List[Pages],
                            block_tables, base: int):
        """One prompt chunk: tokens [B,C] at positions base..base+C-1.
        Returns (logits [B,C,V], pages)."""
        b, c = tokens.shape
        pos = base + torch.arange(c, device=tokens.device).expand(b, c)
        cos, sin = rope_cos_sin(pos.to(torch.int32), hd, cfg.rope_theta)
        x = params.embed[tokens.long()].to(param_dtype)
        for lp, lpg in zip(params.layers, pages):
            x, _ = layer_prefill_paged(lp, x, lpg, block_tables, base,
                                       cos, sin, cfg)
        h = rmsnorm(params.final_norm.scale, x, cfg.norm_eps)
        return _unembed(params, cfg, h), pages

    def decode_step_paged(params: DecoderLM, tokens, pages: List[Pages],
                          block_tables, lengths, active):
        """One decode step over the slot array: tokens [B], per-slot
        ``lengths`` [B] (cached tokens so far, the position each slot's
        token is written at), ``active`` [B] bool.  Returns
        (logits [B,V], pages)."""
        pos = lengths.to(torch.int32)[:, None]               # [B,1]
        cos, sin = rope_cos_sin(pos, hd, cfg.rope_theta)
        x = params.embed[tokens.long()][:, None].to(param_dtype)
        for lp, lpg in zip(params.layers, pages):
            x, _ = layer_decode_paged(lp, x, lpg, block_tables, lengths,
                                      active, cos, sin, cfg, decode_impl)
        h = rmsnorm(params.final_norm.scale, x[:, 0:1], cfg.norm_eps)
        return _unembed(params, cfg, h[:, 0]), pages

    return ModelBundle(cfg=cfg, device=device, init=init,
                       init_paged_cache=init_paged_cache,
                       prefill_paged_chunk=prefill_paged_chunk,
                       decode_step_paged=decode_step_paged)
