"""Decoder-LM assembly (PyTorch port of ``repro/models/transformer.py``):
the dense GQA decoders, for training and for paged serving, and the
RWKV-6 LM for training.

Training (``init_train``, ``forward``, ``loss_fn``) keeps the reference's
parameter tree: a dict with the reference's keys whose layer stack holds
stacked ``[L, ...]`` leaves, so ``repro_torch.tree.leaves`` gives the
leaves, shapes and order of ``jax.tree.leaves`` of the reference's
``init``; the stack is looped over where the reference scans.  Attention
and the WKV recurrence run through ``kernels/ops.py`` under ``impl``
("auto": the CUDA kernels for CUDA tensors, forward and backward).

Serving keeps an ``nn.ModuleList`` of layers (``init``) whose parameter
names are the reference's leaf paths (``layers.<i>.attn.wq`` for
``layers/attn/wq`` row ``i``), so ``repro_torch/convert.py`` carries
weights across by splitting the stacks; the paged pool is a list of
per-layer ``{"k", "v"}`` tensors, updated in place.  Ported:
``init_paged_cache``, ``prefill_paged_chunk`` and ``decode_step_paged``
for dense GQA decoders (with or without a sliding window).  The non-paged
prefill and decode (dense and RWKV), MoE, MLA, M-RoPE and the other
families raise ``NotImplementedError`` naming the ROADMAP item that
ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import rwkv6 as rwk
from repro_torch.models.attention import (GQA, Pages, gqa_attention,
                                          gqa_decode_paged, gqa_params,
                                          gqa_prefill_paged_chunk,
                                          init_paged_kv)
from repro_torch.models.common import (Params, dense_init, embed_init,
                                       rmsnorm, rmsnorm_init, rope_cos_sin,
                                       scan_layers, softmax_cross_entropy,
                                       stacked_init, text_positions)
from repro_torch.models.mlp import MLP, mlp_apply, mlp_params


def unsupported_reason(cfg: ArchConfig) -> Optional[str]:
    """Why the port cannot build ``cfg`` as a decoder LM yet (None if it
    can); the RWKV family is :func:`build_rwkv_lm`'s."""
    if cfg.family == "ssm":
        return ("family 'ssm' is the RWKV LM (build_rwkv_lm), which trains "
                "but does not serve yet (ROADMAP Queue 1 item 6)")
    if cfg.family in ("hybrid", "audio") or cfg.is_encoder_decoder:
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


# --------------------------- training ---------------------------------- #

def layer_params(cfg: ArchConfig, dtype, *, device,
                 generator: Optional[torch.Generator]) -> Params:
    """One dense GQA layer's leaves, keyed as the reference's."""
    kw = dict(device=device, generator=generator)
    return {
        "ln1": {"scale": rmsnorm_init(cfg.d_model, dtype, device=device)},
        "attn": gqa_params(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.resolved_head_dim, dtype, **kw),
        "ln2": {"scale": rmsnorm_init(cfg.d_model, dtype, device=device)},
        "ffn": mlp_params(cfg.d_model, cfg.d_ff, cfg.act, dtype, **kw),
    }


def layer_apply(p: Params, x, cos, sin, cfg: ArchConfig, window: int,
                impl: str):
    """One dense GQA layer, full sequence (training)."""
    h = rmsnorm(p["ln1"]["scale"], x, cfg.norm_eps)
    x = x + gqa_attention(p["attn"], h, cos, sin, n_heads=cfg.n_heads,
                          n_kv_heads=cfg.n_kv_heads,
                          head_dim=cfg.resolved_head_dim, window=window,
                          impl=impl)
    h = rmsnorm(p["ln2"]["scale"], x, cfg.norm_eps)
    return x + mlp_apply(p["ffn"], h, cfg.act)


# --------------------------- serving ----------------------------------- #

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
    """The ported surface of the reference's ``ModelBundle``:

      init(generator=None)       -> the serving params (DecoderLM); for
                                    RWKV the training tree
      init_train(generator=None) -> the training tree (stacked leaves)
      forward(params, embeds, positions) -> (hidden [B,S,d], aux loss)
      loss_fn(params, batch)     -> (loss, metrics)  [tokens, labels]
      prefill(params, batch), decode_step(params, tok, cache)
                                 -> raise until ROADMAP Queue 1 item 6
      init_paged_cache(n_pages, page_size) -> [ {"k", "v"} ] per layer
      prefill_paged_chunk(params, tokens [B,C], pages, tables, base)
          -> (logits [B,C,V], pages)
      decode_step_paged(params, tokens [B], pages, tables, lengths,
          active) -> (logits [B,V], pages)
    """
    cfg: ArchConfig
    device: torch.device
    init: Callable
    init_train: Optional[Callable] = None
    forward: Optional[Callable] = None
    loss_fn: Optional[Callable] = None
    prefill: Optional[Callable] = None
    decode_step: Optional[Callable] = None
    init_paged_cache: Optional[Callable] = None
    prefill_paged_chunk: Optional[Callable] = None
    decode_step_paged: Optional[Callable] = None


def _not_ported(what: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(f"{what} is not ported yet (ROADMAP "
                                  f"Queue 1 item 6)")
    return refuse


def _generator(gen, default, device) -> Optional[torch.Generator]:
    """The caller's generator, else the bundle's, else one seeded with 0;
    none on the meta device, where nothing is drawn (shapes only)."""
    if gen is not None:
        return gen
    if default is not None or device.type == "meta":
        return default
    return torch.Generator(device=device).manual_seed(0)


def _unembed(params: DecoderLM, cfg: ArchConfig, x):
    if cfg.tie_embeddings:
        return x @ params.embed.T
    return x @ params.lm_head


def build_decoder_lm(cfg: ArchConfig, *, param_dtype=torch.float32,
                     cache_dtype=torch.bfloat16, decode_impl: str = "auto",
                     impl: str = "auto", device="cuda",
                     generator: Optional[torch.Generator] = None
                     ) -> ModelBundle:
    """Dense GQA decoders.  ``impl`` picks the training attention
    (kernels/ops.py::flash_attention: "auto" / "kernel" / "plain");
    ``decode_impl`` the paged decode attention (kernels/ops.py::
    flash_decode), and only affects ``decode_step_paged``.  The pool's
    dtype is ``cache_dtype`` (bf16 by default, even with fp32 params)."""
    reason = unsupported_reason(cfg)
    if reason:
        raise NotImplementedError(f"{cfg.name}: {reason}")
    device = torch.device(device)
    hd = cfg.resolved_head_dim
    window = cfg.sliding_window

    def init(gen: Optional[torch.Generator] = None) -> DecoderLM:
        return DecoderLM(cfg, param_dtype, device=device,
                         generator=_generator(gen, generator, device))

    def init_train(gen: Optional[torch.Generator] = None) -> Params:
        kw = dict(device=device,
                  generator=_generator(gen, generator, device))
        p: Params = {
            "embed": embed_init(cfg.padded_vocab, cfg.d_model, param_dtype,
                                **kw),
            "final_norm": {"scale": rmsnorm_init(cfg.d_model, param_dtype,
                                                 device=device)},
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = dense_init(cfg.d_model, cfg.padded_vocab,
                                      param_dtype, **kw)
        p["layers"] = stacked_init(
            lambda: layer_params(cfg, param_dtype, **kw), cfg.n_layers)
        return p

    def forward(params: Params, embeds, positions):
        """embeds [B,S,d], positions [B,S] -> (hidden [B,S,d], aux)."""
        cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
        x = scan_layers(lambda x, lp: layer_apply(lp, x, cos, sin, cfg,
                                                  window, impl),
                        embeds.to(param_dtype), params["layers"])
        return (rmsnorm(params["final_norm"]["scale"], x, cfg.norm_eps),
                torch.zeros((), device=embeds.device))

    def loss_fn(params: Params, batch):
        tokens = batch["tokens"]
        h, _ = forward(params, params["embed"][tokens.long()],
                       text_positions(*tokens.shape, device=tokens.device))
        logits = h @ params["embed"].mT if cfg.tie_embeddings \
            else h @ params["lm_head"]
        loss, metrics = softmax_cross_entropy(logits, batch["labels"],
                                              batch.get("mask"))
        metrics["loss"] = loss
        return loss, metrics

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
                       init_train=init_train, forward=forward,
                       loss_fn=loss_fn,
                       prefill=_not_ported("the non-paged prefill"),
                       decode_step=_not_ported("the non-paged decode step"),
                       init_paged_cache=init_paged_cache,
                       prefill_paged_chunk=prefill_paged_chunk,
                       decode_step_paged=decode_step_paged)


# ===================================================================== #
# RWKV-6 LM
# ===================================================================== #

def build_rwkv_lm(cfg: ArchConfig, *, param_dtype=torch.float32,
                  impl: str = "auto", device="cuda",
                  generator: Optional[torch.Generator] = None
                  ) -> ModelBundle:
    """The RWKV-6 LM for training (``repro/models/transformer.py:513``).
    ``impl`` picks the WKV recurrence (kernels/ops.py::rwkv6_wkv).  Its
    prefill and decode step raise until ROADMAP Queue 1 item 6."""
    if cfg.family != "ssm":
        raise ValueError(f"{cfg.name}: build_rwkv_lm takes the 'ssm' family")
    device = torch.device(device)
    H, hd = cfg.ssm_heads, cfg.resolved_head_dim

    def init(gen: Optional[torch.Generator] = None) -> Params:
        kw = dict(device=device,
                  generator=_generator(gen, generator, device))
        return {
            "embed": embed_init(cfg.padded_vocab, cfg.d_model, param_dtype,
                                **kw),
            "layers": stacked_init(
                lambda: rwk.block_init(cfg.d_model, cfg.d_ff, H, hd,
                                       param_dtype, **kw), cfg.n_layers),
            "final_norm": {"scale": rmsnorm_init(cfg.d_model, param_dtype,
                                                 device=device)},
            "lm_head": dense_init(cfg.d_model, cfg.padded_vocab,
                                  param_dtype, **kw),
        }

    def forward(params: Params, embeds, positions=None):
        x = scan_layers(lambda x, lp: rwk.block_apply(
            lp, x, n_heads=H, head_dim=hd, eps=cfg.norm_eps, impl=impl),
            embeds.to(param_dtype), params["layers"])
        return (rmsnorm(params["final_norm"]["scale"], x, cfg.norm_eps),
                torch.zeros((), device=embeds.device))

    def loss_fn(params: Params, batch):
        h, _ = forward(params, params["embed"][batch["tokens"].long()])
        logits = h @ params["lm_head"]
        return softmax_cross_entropy(logits, batch["labels"],
                                     batch.get("mask"))

    return ModelBundle(cfg=cfg, device=device, init=init, init_train=init,
                       forward=forward, loss_fn=loss_fn,
                       prefill=_not_ported("the RWKV prefill"),
                       decode_step=_not_ported("the RWKV decode step"))
