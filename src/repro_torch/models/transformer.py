"""Decoder-LM assembly (PyTorch port of ``repro/models/transformer.py``):
the dense, MoE, MLA and VLM decoders, the RWKV-6 LM and the Hymba hybrid
LM, each for training and serving.

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

Serving keeps a module tree (``init``, :class:`DecoderLM`) whose
parameter names are the reference's leaf paths (``layers.<i>.attn.wq``
for ``layers/attn/wq`` row ``i``, ``layers_dense.<i>.ffn.w_gate`` for the
dense layers before a MoE stack), so ``repro_torch/convert.py`` carries
weights across by splitting the stacks.  Every trained decoder serves:
dense GQA (with or without a sliding window), MLA, MoE and M-RoPE, through
the dense cache (``init_cache``, ``prefill``, ``decode_step``; full or
rolling) and the paged pool (``init_paged_cache``,
``prefill_paged_chunk``, ``decode_step_paged``).  Caches are lists of
per-layer dicts, updated in place.  The RWKV-6 LM serves from its
training tree through a constant-size state (``prefill`` through the WKV
kernel, ``decode_step`` in plain products); it has no paged path, as in
the reference.  So does the Hymba LM (:func:`build_hymba_lm`), whose
per-layer state is a rolling K/V cache of ``sliding_window`` positions
and the SSM head's fp32 scan and conv states.  The serving entry points
run under ``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import hybrid as hyb
from repro_torch.models import mamba as mam
from repro_torch.models import rwkv6 as rwk
from repro_torch.models.attention import (
    Pages, gqa_attention, gqa_decode, gqa_decode_paged, gqa_params,
    gqa_prefill_paged_chunk, init_kv_cache, init_mla_cache, init_paged_kv,
    init_paged_mla, mla_attention, mla_decode, mla_decode_paged,
    mla_params, mla_prefill_cache, mla_prefill_paged_chunk,
    prefill_kv_cache)
from repro_torch.models.common import (Params, dense_init, embed_init, mm,
                                       mrope_cos_sin, rmsnorm, rmsnorm_init,
                                       rope_cos_sin, scan_layers,
                                       scan_layers_with_cache,
                                       softmax_cross_entropy, stacked_init,
                                       text_positions)
from repro_torch.models.mlp import mlp_apply, mlp_params
from repro_torch.models.moe import moe_apply, moe_params


def train_unsupported_reason(cfg: ArchConfig) -> Optional[str]:
    """Why the port cannot train ``cfg`` as a decoder LM (None if it can);
    the RWKV family is :func:`build_rwkv_lm`'s."""
    if cfg.family == "ssm":
        return "family 'ssm' is the RWKV LM (build_rwkv_lm)"
    if cfg.family == "hybrid":
        return "family 'hybrid' is the Hymba LM (build_hymba_lm)"
    if cfg.family == "audio" or cfg.is_encoder_decoder:
        return (f"family '{cfg.family}' is the encoder-decoder "
                f"(models/encdec.py::build_encdec)")
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
# serving layout
# ===================================================================== #

class Leaves(nn.Module):
    """A nested tree of leaves as a module: dicts become submodules,
    lists ``ModuleList`` s, tensors parameters, under the tree's keys.
    Indexing by key reads the attribute, so the layer functions, written
    against the training path's dicts, read a module the same way."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, Mapping):
                v = Leaves(v)
            elif isinstance(v, (list, tuple)):
                v = nn.ModuleList([Leaves(x) for x in v])
            else:
                v = nn.Parameter(v)
            setattr(self, k, v)

    def __getitem__(self, name: str):
        if name not in self:
            raise KeyError(name)
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


class DecoderLayer(Leaves):
    """One layer's leaves (:func:`layer_params`) as a module."""

    def __init__(self, cfg: ArchConfig, dtype, *, use_moe: bool = False,
                 device, generator: Optional[torch.Generator]):
        super().__init__(layer_params(cfg, dtype, use_moe=use_moe,
                                      device=device, generator=generator))


class DecoderLM(Leaves):
    """Parameters: ``embed`` [V, d], ``final_norm.scale``, ``lm_head``
    [d, V] (unless tied), ``layers`` (one :class:`DecoderLayer` each, MoE
    where the config has experts) and, before a MoE stack, the dense
    ``layers_dense``."""

    def __init__(self, cfg: ArchConfig, dtype, *, device,
                 generator: Optional[torch.Generator]):
        kw = dict(device=device, generator=generator)
        tree = {"embed": embed_init(cfg.padded_vocab, cfg.d_model, dtype,
                                    **kw),
                "final_norm": {"scale": rmsnorm_init(cfg.d_model, dtype,
                                                     device=device)}}
        if not cfg.tie_embeddings:
            tree["lm_head"] = dense_init(cfg.d_model, cfg.padded_vocab,
                                         dtype, **kw)
        super().__init__(tree)
        n_pre, n_main = _split_layers(cfg)
        self.layers = nn.ModuleList(
            [DecoderLayer(cfg, dtype, use_moe=cfg.uses_moe, **kw)
             for _ in range(n_main)])
        if n_pre:
            self.layers_dense = nn.ModuleList(
                [DecoderLayer(cfg, dtype, **kw) for _ in range(n_pre)])


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

def _attend_kw(cfg: ArchConfig):
    if cfg.kv_lora_rank:
        return dict(n_heads=cfg.n_heads, kv_lora=cfg.kv_lora_rank,
                    qk_nope=cfg.qk_nope_head_dim,
                    qk_rope=cfg.qk_rope_head_dim, v_dim=cfg.v_head_dim,
                    eps=cfg.norm_eps)
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim)


def _layer_ffn(p, x, cfg: ArchConfig, use_moe: bool):
    h = rmsnorm(p["ln2"]["scale"], x, cfg.norm_eps)
    if use_moe:
        f, _ = moe_apply(p["ffn"], h, n_experts=cfg.n_experts,
                         top_k=cfg.top_k, act=cfg.act,
                         capacity_factor=cfg.capacity_factor)
    else:
        f = mlp_apply(p["ffn"], h, cfg.act)
    return x + f


def layer_decode(p, x, cache, cos, sin, cfg: ArchConfig, use_moe: bool,
                 rolling: bool):
    """One layer of the dense-cache decode step."""
    h = rmsnorm(p["ln1"]["scale"], x, cfg.norm_eps)
    if cfg.kv_lora_rank:
        a, cache = mla_decode(p["attn"], h, cache, cos, sin,
                              **_attend_kw(cfg))
    else:
        a, cache = gqa_decode(p["attn"], h, cache, cos, sin,
                              rolling=rolling, **_attend_kw(cfg))
    return _layer_ffn(p, x + a, cfg, use_moe), cache


def layer_decode_paged(p, x, pages: Pages, block_tables, lengths, active,
                       cos, sin, cfg: ArchConfig, use_moe: bool,
                       decode_impl: str):
    """One layer of the paged decode step (per-slot positions)."""
    h = rmsnorm(p["ln1"]["scale"], x, cfg.norm_eps)
    if cfg.kv_lora_rank:
        a, pages = mla_decode_paged(p["attn"], h, pages, block_tables,
                                    lengths, active, cos, sin,
                                    **_attend_kw(cfg))
    else:
        a, pages = gqa_decode_paged(
            p["attn"], h, pages, block_tables, lengths, active, cos, sin,
            window=cfg.sliding_window, impl=decode_impl, **_attend_kw(cfg))
    return _layer_ffn(p, x + a, cfg, use_moe), pages


def layer_prefill_paged(p, x, pages: Pages, block_tables, base, cos, sin,
                        cfg: ArchConfig, use_moe: bool):
    """One layer of one paged-prefill chunk (positions base..base+C-1)."""
    h = rmsnorm(p["ln1"]["scale"], x, cfg.norm_eps)
    if cfg.kv_lora_rank:
        a, pages = mla_prefill_paged_chunk(p["attn"], h, pages,
                                           block_tables, base, cos, sin,
                                           **_attend_kw(cfg))
    else:
        a, pages = gqa_prefill_paged_chunk(
            p["attn"], h, pages, block_tables, base, cos, sin,
            window=cfg.sliding_window, **_attend_kw(cfg))
    return _layer_ffn(p, x + a, cfg, use_moe), pages


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
      init_cache(batch, max_len) -> [ per-layer cache ]
      prefill(params, batch)     -> (last-position logits [B,V], cache)
                                    [tokens; max_len; vision_embeds and
                                    positions for the VLM]
      decode_step(params, tokens [B], cache) -> (logits [B,V], cache)
      init_paged_cache(n_pages, page_size) -> [ per-layer pages ]
      prefill_paged_chunk(params, tokens [B,C], pages, tables, base)
          -> (logits [B,C,V], pages)
      decode_step_paged(params, tokens [B], pages, tables, lengths,
          active) -> (logits [B,V], pages)

    The paged entry points are None for the RWKV and Hymba LMs, whose
    state has a constant size, and for the encoder-decoder, as in the
    reference.
    """
    cfg: ArchConfig
    device: torch.device
    init: Callable
    init_train: Optional[Callable] = None
    forward: Optional[Callable] = None
    loss_fn: Optional[Callable] = None
    prefill: Optional[Callable] = None
    decode_step: Optional[Callable] = None
    init_cache: Optional[Callable] = None
    init_paged_cache: Optional[Callable] = None
    prefill_paged_chunk: Optional[Callable] = None
    decode_step_paged: Optional[Callable] = None


def _generator(gen, default, device) -> Optional[torch.Generator]:
    """The caller's generator, else the bundle's, else one seeded with 0;
    none on the meta device, where nothing is drawn (shapes only)."""
    if gen is not None:
        return gen
    if default is not None or device.type == "meta":
        return default
    return torch.Generator(device=device).manual_seed(0)


def _unembed(params, cfg: ArchConfig, x):
    if cfg.tie_embeddings:
        return mm(x, params["embed"].T)
    return mm(x, params["lm_head"])


def build_decoder_lm(cfg: ArchConfig, *, param_dtype=torch.float32,
                     compute_dtype=None, remat: bool = False,
                     rolling_decode: bool = False,
                     cache_dtype=torch.bfloat16, decode_impl: str = "auto",
                     impl: str = "auto", device="cuda",
                     generator: Optional[torch.Generator] = None
                     ) -> ModelBundle:
    """Dense, MoE, MLA and VLM decoders.  ``impl`` picks the attention of
    training and of the dense prefill (kernels/ops.py::flash_attention:
    "auto" / "kernel" / "plain"); ``decode_impl`` the paged decode
    attention (kernels/ops.py::flash_decode), and only affects
    ``decode_step_paged``.  Caches and pools are ``cache_dtype`` (bf16 by
    default, even with fp32 params); ``rolling_decode`` makes the dense
    GQA cache a circular buffer of ``cfg.long_context_window`` positions.
    ``compute_dtype`` (None: ``param_dtype``) is the activations' type and
    ``remat`` recomputes each layer in the backward, as in the
    reference."""
    reason = train_unsupported_reason(cfg)
    if reason:
        raise NotImplementedError(f"{cfg.name}: {reason}")
    device = torch.device(device)
    compute_dtype = compute_dtype or param_dtype
    window = cfg.sliding_window
    n_pre, n_main = _split_layers(cfg)
    roll_w = cfg.long_context_window if rolling_decode else 0

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

    def _embed_batch(params, batch):
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

    # ------------------------- serving ------------------------------- #
    # The dense prefix's caches come first, then the main stack's, as the
    # reference concatenates its two stacked caches.

    def _run_layers(params, x, caches, body):
        """``body(x, layer, cache, use_moe)`` over the dense prefix then
        the main stack; ``caches`` covers all layers in that order."""
        new = []
        stacks = [(params["layers_dense"], False)] if n_pre else []
        for layers, use_moe in stacks + [(params["layers"], cfg.uses_moe)]:
            x, c = scan_layers_with_cache(
                lambda x, lp, lc: body(x, lp, lc, use_moe), x, layers,
                caches[len(new):len(new) + len(layers)])
            new += c
        return x, new

    def _positions_for(pos):
        """pos [B,S] int32 -> rope positions ([B,S] or [B,S,3] M-RoPE)."""
        return torch.stack([pos, pos, pos], dim=-1) if cfg.mrope else pos

    def init_cache(batch: int, max_len: int) -> List:
        if cfg.kv_lora_rank:
            return [init_mla_cache(batch, max_len, cfg.kv_lora_rank,
                                   cfg.qk_rope_head_dim, cache_dtype,
                                   device=device)
                    for _ in range(cfg.n_layers)]
        return [init_kv_cache(batch, max_len, cfg.n_kv_heads,
                              cfg.resolved_head_dim, cache_dtype,
                              rolling=rolling_decode, window=roll_w,
                              device=device)
                for _ in range(cfg.n_layers)]

    @torch.no_grad()
    def prefill(params, batch):
        """The whole prompt (``batch["tokens"]`` [B,S], and for the VLM
        ``vision_embeds`` and ``positions`` in front) -> (last-position
        logits [B,V], the caches of ``batch["max_len"]`` positions)."""
        embeds, positions, _ = _embed_batch(params, batch)
        cos, sin = _rope_for(cfg, positions)
        x = embeds.to(compute_dtype)
        max_len = int(batch.get("max_len", x.shape[1]))

        def body(x, lp, _, use_moe):
            h = rmsnorm(lp["ln1"]["scale"], x, cfg.norm_eps)
            if cfg.kv_lora_rank:
                kw = _attend_kw(cfg)
                a = mla_attention(lp["attn"], h, cos, sin, **kw)
                cache = mla_prefill_cache(lp["attn"], h, cos, sin,
                                          max_len=max_len, eps=kw["eps"],
                                          dtype=cache_dtype)
            else:
                a = gqa_attention(lp["attn"], h, cos, sin, window=window,
                                  impl=impl, **_attend_kw(cfg))
                cache = prefill_kv_cache(
                    lp["attn"], h, cos, sin, max_len=max_len,
                    dtype=cache_dtype, rolling=rolling_decode,
                    window=roll_w, **_attend_kw(cfg))
            return _layer_ffn(lp, x + a, cfg, use_moe), cache

        x, cache = _run_layers(params, x, [None] * cfg.n_layers, body)
        h = rmsnorm(params["final_norm"]["scale"], x, cfg.norm_eps)
        return _unembed(params, cfg, h[:, -1]), cache

    @torch.no_grad()
    def decode_step(params, tokens, cache):
        """tokens [B] -> (logits [B,V], cache): every layer writes at the
        same position, its cache's ``pos``."""
        b = tokens.shape[0]
        pos = torch.full((b, 1), cache[0]["pos"], dtype=torch.int32,
                         device=tokens.device)
        cos, sin = _rope_for(cfg, _positions_for(pos))
        x = params["embed"][tokens.long()][:, None].to(compute_dtype)
        x, cache = _run_layers(
            params, x, cache, lambda x, lp, lc, use_moe: layer_decode(
                lp, x, lc, cos, sin, cfg, use_moe, rolling_decode))
        h = rmsnorm(params["final_norm"]["scale"], x[:, 0:1], cfg.norm_eps)
        return _unembed(params, cfg, h[:, 0]), cache

    def init_paged_cache(n_pages: int, page_size: int) -> List[Pages]:
        if cfg.kv_lora_rank:
            return [init_paged_mla(n_pages, page_size, cfg.kv_lora_rank,
                                   cfg.qk_rope_head_dim, cache_dtype,
                                   device=device)
                    for _ in range(cfg.n_layers)]
        return [init_paged_kv(n_pages, page_size, cfg.n_kv_heads,
                              cfg.resolved_head_dim, cache_dtype,
                              device=device)
                for _ in range(cfg.n_layers)]

    @torch.no_grad()
    def prefill_paged_chunk(params, tokens, pages: List[Pages],
                            block_tables, base: int):
        """One prompt chunk: tokens [B,C] at positions base..base+C-1.
        Returns (logits [B,C,V], pages)."""
        b, c = tokens.shape
        pos = base + torch.arange(c, device=tokens.device).expand(b, c)
        cos, sin = _rope_for(cfg, _positions_for(pos.to(torch.int32)))
        x = params["embed"][tokens.long()].to(compute_dtype)
        x, pages = _run_layers(
            params, x, pages, lambda x, lp, lpg, use_moe:
            layer_prefill_paged(lp, x, lpg, block_tables, base, cos, sin,
                                cfg, use_moe))
        h = rmsnorm(params["final_norm"]["scale"], x, cfg.norm_eps)
        return _unembed(params, cfg, h), pages

    @torch.no_grad()
    def decode_step_paged(params, tokens, pages: List[Pages], block_tables,
                          lengths, active):
        """One decode step over the slot array: tokens [B], per-slot
        ``lengths`` [B] (cached tokens so far, the position each slot's
        token is written at), ``active`` [B] bool.  Returns
        (logits [B,V], pages)."""
        pos = lengths.to(torch.int32)[:, None]               # [B,1]
        cos, sin = _rope_for(cfg, _positions_for(pos))
        x = params["embed"][tokens.long()][:, None].to(compute_dtype)
        x, pages = _run_layers(
            params, x, pages, lambda x, lp, lpg, use_moe:
            layer_decode_paged(lp, x, lpg, block_tables, lengths, active,
                               cos, sin, cfg, use_moe, decode_impl))
        h = rmsnorm(params["final_norm"]["scale"], x[:, 0:1], cfg.norm_eps)
        return _unembed(params, cfg, h[:, 0]), pages

    return ModelBundle(cfg=cfg, device=device, init=init,
                       init_train=init_train, forward=forward,
                       loss_fn=loss_fn, prefill=prefill,
                       decode_step=decode_step, init_cache=init_cache,
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
    """The RWKV-6 LM (``repro/models/transformer.py:513``), for training
    and for serving from the same tree.  ``impl`` picks the WKV recurrence
    of training and of the prefill (kernels/ops.py::rwkv6_wkv: on CUDA
    tensors the kernel, which starts from the cache's state and returns
    the final one); the decode step is plain products, as in the
    reference.  ``compute_dtype`` and ``remat`` are
    :func:`build_decoder_lm`'s."""
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

    def init_cache(batch: int, max_len: int = 0) -> List:
        return [rwk.init_block_state(batch, cfg.d_model, H, hd,
                                     device=device)
                for _ in range(cfg.n_layers)]

    @torch.no_grad()
    def prefill(params: Params, batch):
        """The prompt through the recurrence from zero states; returns
        (last-position logits [B,V], each layer's final states)."""
        x = params["embed"][batch["tokens"].long()].to(compute_dtype)

        def body(x, lp, st):
            h_in = rmsnorm(lp["ln1"]["scale"], x, cfg.norm_eps)
            h, tm_shift, wkv = rwk.timemix_apply(
                lp["tm"], h_in, n_heads=H, head_dim=hd, eps=cfg.norm_eps,
                wkv_state=st["wkv"], impl=impl)
            x = x + h
            h2, cm_shift = rwk.channelmix_apply(
                lp["cm"], rmsnorm(lp["ln2"]["scale"], x, cfg.norm_eps))
            return x + h2, {"tm_shift": tm_shift, "wkv": wkv,
                            "cm_shift": cm_shift}

        x, cache = scan_layers_with_cache(body, x, params["layers"],
                                          init_cache(x.shape[0]))
        h = rmsnorm(params["final_norm"]["scale"], x, cfg.norm_eps)
        return mm(h[:, -1], params["lm_head"]), cache

    @torch.no_grad()
    def decode_step(params: Params, tokens, cache):
        x = params["embed"][tokens.long()][:, None].to(compute_dtype)
        x, cache = scan_layers_with_cache(
            lambda x, lp, st: rwk.block_decode(lp, x, st, n_heads=H,
                                               head_dim=hd,
                                               eps=cfg.norm_eps),
            x, params["layers"], cache)
        h = rmsnorm(params["final_norm"]["scale"], x[:, 0], cfg.norm_eps)
        return mm(h, params["lm_head"]), cache

    return ModelBundle(cfg=cfg, device=device, init=init, init_train=init,
                       forward=forward, loss_fn=loss_fn, prefill=prefill,
                       decode_step=decode_step, init_cache=init_cache)


# ===================================================================== #
# Hymba hybrid LM
# ===================================================================== #

def build_hymba_lm(cfg: ArchConfig, *, param_dtype=torch.float32,
                   compute_dtype=None, remat: bool = False,
                   impl: str = "auto", cache_dtype=torch.bfloat16,
                   device="cuda", generator: Optional[torch.Generator] = None
                   ) -> ModelBundle:
    """The Hymba LM (``repro/models/transformer.py:600``), for training
    and for serving from the same tree (``layers`` stacked ``[L, ...]``).
    ``impl`` picks the sliding-window attention of training and of the
    prefill (kernels/ops.py::flash_attention); the SSM scan is plain
    PyTorch (models/mamba.py).  The serving state of a layer is a rolling
    K/V cache of ``cfg.sliding_window`` positions in ``cache_dtype`` and
    the fp32 SSM and conv states; the decode's RoPE position is the
    cache's count, which the reference's rolling prefill caps at the
    window, and the port keeps that.  ``compute_dtype`` and ``remat`` are
    :func:`build_decoder_lm`'s."""
    if cfg.family != "hybrid":
        raise ValueError(f"{cfg.name}: build_hymba_lm takes the 'hybrid' "
                         f"family")
    device = torch.device(device)
    compute_dtype = compute_dtype or param_dtype
    hd, window = cfg.resolved_head_dim, cfg.sliding_window
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=hd,
              ssm_state=cfg.ssm_state, eps=cfg.norm_eps, act=cfg.act)

    def init(gen: Optional[torch.Generator] = None) -> Params:
        kw_ = dict(device=device,
                   generator=_generator(gen, generator, device))
        return {
            "embed": embed_init(cfg.padded_vocab, cfg.d_model, param_dtype,
                                **kw_),
            "layers": stacked_init(lambda: hyb.hymba_block_params(
                d_model=cfg.d_model, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, head_dim=hd, d_ff=cfg.d_ff,
                ssm_state=cfg.ssm_state, ssm_expand=cfg.ssm_expand,
                act=cfg.act, dtype=param_dtype, **kw_), cfg.n_layers),
            "final_norm": {"scale": rmsnorm_init(cfg.d_model, param_dtype,
                                                 device=device)},
            "lm_head": dense_init(cfg.d_model, cfg.padded_vocab,
                                  param_dtype, **kw_),
        }

    def _rope(b, s, dev):
        return rope_cos_sin(text_positions(b, s, device=dev), hd,
                            cfg.rope_theta)

    def forward(params: Params, embeds, positions=None):
        _check_compute_dtype(param_dtype, compute_dtype)
        b, s, _ = embeds.shape
        cos, sin = _rope(b, s, embeds.device) if positions is None else \
            rope_cos_sin(positions, hd, cfg.rope_theta)
        x = scan_layers(lambda x, lp, cos, sin: hyb.hymba_block_apply(
            lp, x, cos, sin, window=window, impl=impl, remat=remat, **kw),
            embeds.to(compute_dtype), params["layers"], remat=remat,
            consts=(cos, sin))
        return (rmsnorm(params["final_norm"]["scale"], x, cfg.norm_eps),
                torch.zeros((), device=embeds.device))

    def loss_fn(params: Params, batch):
        h, _ = forward(params, params["embed"][batch["tokens"].long()])
        return softmax_cross_entropy(mm(h, params["lm_head"]),
                                     batch["labels"], batch.get("mask"))

    def init_cache(batch: int, max_len: int = 0) -> List:
        return [hyb.init_hymba_state(
            batch, d_model=cfg.d_model, n_kv_heads=cfg.n_kv_heads,
            head_dim=hd, ssm_state=cfg.ssm_state,
            ssm_expand=cfg.ssm_expand, window=window, dtype=cache_dtype,
            device=device) for _ in range(cfg.n_layers)]

    @torch.no_grad()
    def prefill(params: Params, batch):
        """The prompt from zero states -> (last-position logits [B,V],
        each layer's state: the prompt's last ``window`` K/V, the final
        SSM state and conv tail)."""
        x = params["embed"][batch["tokens"].long()].to(compute_dtype)
        b, s, _ = x.shape
        cos, sin = _rope(b, s, x.device)

        def body(x, lp, _):
            h = rmsnorm(lp["ln_in"]["scale"], x, cfg.norm_eps)
            a = gqa_attention(lp["attn"], h, cos, sin, n_heads=cfg.n_heads,
                              n_kv_heads=cfg.n_kv_heads, head_dim=hd,
                              window=window, impl=impl)
            kv = prefill_kv_cache(lp["attn"], h, cos, sin,
                                  n_heads=cfg.n_heads,
                                  n_kv_heads=cfg.n_kv_heads, head_dim=hd,
                                  max_len=window, dtype=cache_dtype,
                                  rolling=True, window=window)
            m, h_t, conv_tail = mam.mamba_apply(lp["ssm"], h,
                                                state=cfg.ssm_state)
            return hyb._fuse(lp, x, a, m, cfg.norm_eps, cfg.act), \
                {"kv": kv, "ssm": h_t, "conv": conv_tail}

        x, cache = scan_layers_with_cache(body, x, params["layers"],
                                          [None] * cfg.n_layers)
        h = rmsnorm(params["final_norm"]["scale"], x, cfg.norm_eps)
        return mm(h[:, -1], params["lm_head"]), cache

    @torch.no_grad()
    def decode_step(params: Params, tokens, cache):
        b = tokens.shape[0]
        pos = torch.full((b, 1), cache[0]["kv"]["pos"], dtype=torch.int32,
                         device=tokens.device)
        cos, sin = rope_cos_sin(pos, hd, cfg.rope_theta)
        x = params["embed"][tokens.long()][:, None].to(compute_dtype)
        x, cache = scan_layers_with_cache(
            lambda x, lp, st: hyb.hymba_block_decode(lp, x, st, cos, sin,
                                                     **kw),
            x, params["layers"], cache)
        h = rmsnorm(params["final_norm"]["scale"], x[:, 0], cfg.norm_eps)
        return mm(h, params["lm_head"]), cache

    return ModelBundle(cfg=cfg, device=device, init=init, init_train=init,
                       forward=forward, loss_fn=loss_fn, prefill=prefill,
                       decode_step=decode_step, init_cache=init_cache)
