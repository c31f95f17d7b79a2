"""Decoder-LM assembly (PyTorch port of ``repro/models/transformer.py``):
the dense, MoE, MLA and VLM decoders for training, the dense GQA decoders
for paged serving, and the RWKV-6 LM for training.

Training (``init_train``, ``forward``, ``loss_fn``) keeps the reference's
parameter tree: a dict with the reference's keys whose layer stacks hold
stacked ``[L, ...]`` leaves (``layers``, and ``layers_dense`` for the
dense layers before a MoE stack), so ``repro_torch.tree.leaves`` gives
the leaves, shapes and order of ``jax.tree.leaves`` of the reference's
``init``; the stacks are looped over where the reference scans.
Attention and the WKV recurrence run through ``kernels/ops.py`` under
``impl`` ("auto": the CUDA kernels for CUDA tensors, forward and
backward); MLA and the MoE dispatch are products, as in the reference.

``build_*(compute_dtype=, remat=)`` take the reference's options: the
activations' type (None: the parameters'), and recomputing each layer in
the backward (``models.common.scan_layers``).  As in the reference, a
compute type narrower than the parameters' is refused with ``TypeError``
when the model runs.

Serving keeps an ``nn.ModuleList`` of layers (``init``) whose parameter
names are the reference's leaf paths (``layers.<i>.attn.wq`` for
``layers/attn/wq`` row ``i``), so ``repro_torch/convert.py`` carries
weights across by splitting the stacks; the paged pool is a list of
per-layer ``{"k", "v"}`` tensors, updated in place.  Ported:
``init_paged_cache``, ``prefill_paged_chunk`` and ``decode_step_paged``
for dense GQA decoders (with or without a sliding window).  The non-paged
prefill and decode, the serving of MoE, MLA, VLM and RWKV models, and the
other families raise ``NotImplementedError`` naming the ROADMAP item that
ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import rwkv6 as rwk
from repro_torch.models.attention import (GQA, Pages, gqa_attention,
                                          gqa_decode_paged, gqa_params,
                                          gqa_prefill_paged_chunk,
                                          init_paged_kv, mla_attention,
                                          mla_params)
from repro_torch.models.common import (Params, dense_init, embed_init, mm,
                                       mrope_cos_sin, rmsnorm, rmsnorm_init,
                                       rope_cos_sin, scan_layers,
                                       softmax_cross_entropy, stacked_init,
                                       text_positions)
from repro_torch.models.mlp import MLP, mlp_apply, mlp_params
from repro_torch.models.moe import moe_apply, moe_params


def train_unsupported_reason(cfg: ArchConfig) -> Optional[str]:
    """Why the port cannot train ``cfg`` as a decoder LM (None if it can);
    the RWKV family is :func:`build_rwkv_lm`'s."""
    if cfg.family == "ssm":
        return "family 'ssm' is the RWKV LM (build_rwkv_lm)"
    if cfg.family in ("hybrid", "audio") or cfg.is_encoder_decoder:
        return (f"family '{cfg.family}' is not ported yet "
                f"(ROADMAP Queue 1: remaining model families)")
    return None


def serve_unsupported_reason(cfg: ArchConfig) -> Optional[str]:
    """Why the port cannot serve ``cfg`` (None if it can)."""
    if cfg.family == "ssm":
        return ("family 'ssm' is the RWKV LM (build_rwkv_lm), which trains "
                "but does not serve yet (ROADMAP Queue 1 item 6)")
    reason = train_unsupported_reason(cfg)
    if reason:
        return reason
    if cfg.uses_moe or cfg.kv_lora_rank or cfg.mrope or cfg.family == "vlm":
        return ("MoE, MLA and M-RoPE decoders train but do not serve yet "
                "(ROADMAP Queue 1 item 6)")
    return None


def _check_compute_dtype(param_dtype, compute_dtype):
    """The reference scans its layers with the carry in ``compute_dtype``;
    a narrower compute type than the parameters' promotes in the first
    layer, the carry comes out in another type than it went in, and
    ``lax.scan`` raises TypeError.  The port refuses the same pairs."""
    promoted = torch.promote_types(compute_dtype, param_dtype)
    if promoted != compute_dtype:
        raise TypeError(
            f"compute_dtype {compute_dtype} over {param_dtype} parameters: "
            f"the layers' carry goes in as {compute_dtype} and comes out as "
            f"{promoted}, which the reference refuses (its scan carry "
            f"changes type); bf16 training is param_dtype=torch.bfloat16")


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

def _attn_params(cfg: ArchConfig, dtype, **kw) -> Params:
    if cfg.kv_lora_rank:
        return mla_params(cfg.d_model, cfg.n_heads, cfg.kv_lora_rank,
                          cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                          cfg.v_head_dim, dtype, **kw)
    return gqa_params(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.resolved_head_dim, dtype, **kw)


def layer_params(cfg: ArchConfig, dtype, *, device,
                 generator: Optional[torch.Generator],
                 use_moe: bool = False) -> Params:
    """One decoder layer's leaves (GQA or MLA, dense or MoE FFN), keyed as
    the reference's."""
    kw = dict(device=device, generator=generator)
    p = {
        "ln1": {"scale": rmsnorm_init(cfg.d_model, dtype, device=device)},
        "attn": _attn_params(cfg, dtype, **kw),
        "ln2": {"scale": rmsnorm_init(cfg.d_model, dtype, device=device)},
    }
    if use_moe:
        p["ffn"] = moe_params(cfg.d_model, cfg.expert_d_ff or cfg.d_ff,
                              cfg.n_experts, cfg.n_shared_experts, cfg.act,
                              dtype, **kw)
    else:
        p["ffn"] = mlp_params(cfg.d_model, cfg.d_ff, cfg.act, dtype, **kw)
    return p


def layer_apply(p: Params, x, cos, sin, cfg: ArchConfig, use_moe: bool,
                window: int, impl: str):
    """One decoder layer, full sequence (training) -> (x, aux loss)."""
    h = rmsnorm(p["ln1"]["scale"], x, cfg.norm_eps)
    if cfg.kv_lora_rank:
        a = mla_attention(p["attn"], h, cos, sin, n_heads=cfg.n_heads,
                          kv_lora=cfg.kv_lora_rank,
                          qk_nope=cfg.qk_nope_head_dim,
                          qk_rope=cfg.qk_rope_head_dim,
                          v_dim=cfg.v_head_dim, eps=cfg.norm_eps)
    else:
        a = gqa_attention(p["attn"], h, cos, sin, n_heads=cfg.n_heads,
                          n_kv_heads=cfg.n_kv_heads,
                          head_dim=cfg.resolved_head_dim, window=window,
                          impl=impl)
    x = x + a
    h = rmsnorm(p["ln2"]["scale"], x, cfg.norm_eps)
    if use_moe:
        f, aux = moe_apply(p["ffn"], h, n_experts=cfg.n_experts,
                           top_k=cfg.top_k, act=cfg.act,
                           capacity_factor=cfg.capacity_factor)
    else:
        f, aux = mlp_apply(p["ffn"], h, cfg.act), \
            torch.zeros((), device=x.device)
    return x + f, aux


def _rope_for(cfg: ArchConfig, positions):
    """positions [B,S] (or [B,S,3] for M-RoPE) -> cos/sin [B,S,hd//2]."""
    hd = cfg.qk_rope_head_dim if cfg.kv_lora_rank else cfg.resolved_head_dim
    if cfg.mrope:
        return mrope_cos_sin(positions, hd, cfg.rope_theta,
                             cfg.mrope_sections)
    return rope_cos_sin(positions, hd, cfg.rope_theta)


def _split_layers(cfg: ArchConfig) -> Tuple[int, int]:
    """(n_dense_prefix, n_main): the prefix layers use a dense FFN."""
    if cfg.uses_moe and cfg.first_k_dense:
        return cfg.first_k_dense, cfg.n_layers - cfg.first_k_dense
    return 0, cfg.n_layers


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


def _refused(cfg: ArchConfig, reason: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(f"{cfg.name}: {reason}")
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
                     compute_dtype=None, remat: bool = False,
                     cache_dtype=torch.bfloat16, decode_impl: str = "auto",
                     impl: str = "auto", device="cuda",
                     generator: Optional[torch.Generator] = None
                     ) -> ModelBundle:
    """Dense, MoE, MLA and VLM decoders.  ``impl`` picks the training
    attention (kernels/ops.py::flash_attention: "auto" / "kernel" /
    "plain"); ``decode_impl`` the paged decode attention (kernels/ops.py::
    flash_decode), and only affects ``decode_step_paged``.  The pool's
    dtype is ``cache_dtype`` (bf16 by default, even with fp32 params).
    ``compute_dtype`` (None: ``param_dtype``) is the activations' type and
    ``remat`` recomputes each layer in the backward, as in the reference.
    MoE, MLA and VLM decoders train; their serving entry points raise."""
    reason = train_unsupported_reason(cfg)
    if reason:
        raise NotImplementedError(f"{cfg.name}: {reason}")
    serve_reason = serve_unsupported_reason(cfg)
    device = torch.device(device)
    compute_dtype = compute_dtype or param_dtype
    hd = cfg.resolved_head_dim
    window = cfg.sliding_window
    n_pre, n_main = _split_layers(cfg)

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
            lambda: layer_params(cfg, param_dtype, use_moe=cfg.uses_moe,
                                 **kw), n_main)
        if n_pre:
            p["layers_dense"] = stacked_init(
                lambda: layer_params(cfg, param_dtype, **kw), n_pre)
        return p

    def _body(use_moe):
        def body(carry, lp, cos, sin):
            x, aux = carry
            x, a = layer_apply(lp, x, cos, sin, cfg, use_moe, window, impl)
            return x, aux + a
        return body

    def forward(params: Params, embeds, positions):
        """embeds [B,S,d], positions [B,S] ([B,S,3] with M-RoPE) ->
        (hidden [B,S,d], the aux loss summed over the layers)."""
        _check_compute_dtype(param_dtype, compute_dtype)
        cos, sin = _rope_for(cfg, positions)
        carry = (embeds.to(compute_dtype),
                 torch.zeros((), device=embeds.device))
        if n_pre:
            carry = scan_layers(_body(False), carry, params["layers_dense"],
                                remat=remat, consts=(cos, sin))
        x, aux = scan_layers(_body(cfg.uses_moe), carry, params["layers"],
                             remat=remat, consts=(cos, sin))
        return rmsnorm(params["final_norm"]["scale"], x, cfg.norm_eps), aux

    def _embed_batch(params: Params, batch):
        """(embeds [B,S,d], positions, label offset): vision embeddings go
        in front of the text's, with the batch's M-RoPE positions."""
        tokens = batch["tokens"]
        tok_emb = params["embed"][tokens.long()]
        if cfg.family == "vlm" and "vision_embeds" in batch:
            v = batch["vision_embeds"].to(tok_emb.dtype)
            return (torch.cat([v, tok_emb], dim=1), batch["positions"],
                    v.shape[1])
        pos = text_positions(*tokens.shape, device=tokens.device)
        if cfg.mrope:
            pos = torch.stack([pos, pos, pos], dim=-1)
        return tok_emb, pos, 0

    def loss_fn(params: Params, batch):
        embeds, positions, off = _embed_batch(params, batch)
        h, aux = forward(params, embeds, positions)
        if off:
            h = h[:, off:]                  # labels cover the text only
        logits = mm(h, params["embed"].mT) if cfg.tie_embeddings \
            else mm(h, params["lm_head"])
        loss, metrics = softmax_cross_entropy(logits, batch["labels"],
                                              batch.get("mask"))
        if cfg.uses_moe:
            aux = aux / max(1, n_main)
            loss = loss + cfg.router_aux_coef * aux
            metrics["aux_loss"] = aux
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

    if serve_reason:
        init = _refused(cfg, serve_reason)
        init_paged_cache = _refused(cfg, serve_reason)
        prefill_paged_chunk = _refused(cfg, serve_reason)
        decode_step_paged = _refused(cfg, serve_reason)
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
                  compute_dtype=None, remat: bool = False,
                  impl: str = "auto", device="cuda",
                  generator: Optional[torch.Generator] = None
                  ) -> ModelBundle:
    """The RWKV-6 LM for training (``repro/models/transformer.py:513``).
    ``impl`` picks the WKV recurrence (kernels/ops.py::rwkv6_wkv);
    ``compute_dtype`` and ``remat`` are :func:`build_decoder_lm`'s.  Its
    prefill and decode step raise until ROADMAP Queue 1 item 6."""
    if cfg.family != "ssm":
        raise ValueError(f"{cfg.name}: build_rwkv_lm takes the 'ssm' family")
    device = torch.device(device)
    compute_dtype = compute_dtype or param_dtype
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
        _check_compute_dtype(param_dtype, compute_dtype)
        x = scan_layers(lambda x, lp: rwk.block_apply(
            lp, x, n_heads=H, head_dim=hd, eps=cfg.norm_eps, impl=impl),
            embeds.to(compute_dtype), params["layers"], remat=remat)
        return (rmsnorm(params["final_norm"]["scale"], x, cfg.norm_eps),
                torch.zeros((), device=embeds.device))

    def loss_fn(params: Params, batch):
        h, _ = forward(params, params["embed"][batch["tokens"].long()])
        logits = mm(h, params["lm_head"])
        return softmax_cross_entropy(logits, batch["labels"],
                                     batch.get("mask"))

    return ModelBundle(cfg=cfg, device=device, init=init, init_train=init,
                       forward=forward, loss_fn=loss_fn,
                       prefill=_not_ported("the RWKV prefill"),
                       decode_step=_not_ported("the RWKV decode step"))
