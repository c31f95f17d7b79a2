"""Seamless-style encoder-decoder backbone (PyTorch port of
``repro/models/encdec.py``).

The speech frontend (mel + conformer conv) is a stub: the encoder takes
precomputed frame embeddings [B, T_frames, d_model]
(``models/stubs.py::audio_frame_embeds``).  Encoder layers are
bidirectional self-attention + FFN; decoder layers are causal
self-attention, cross-attention over the encoder's output (``enc @ wk``,
``enc @ wv`` per layer) and the FFN.  Self-attention takes RoPE (the
reference's stand-in for the release's conformer relative positions).
The decoder's causal self-attention runs through
``kernels.ops.flash_attention`` under ``impl``; the encoder's and the
cross-attention are non-causal, so they take the masked core, as in the
reference, whose Pallas kernel is causal only.

The model trains and serves from one tree with the reference's keys
(``embed``, ``enc_layers`` and ``dec_layers`` stacked ``[L, ...]``,
``enc_norm``, ``final_norm``, ``lm_head``).  A decoder layer's serving
cache is ``{"self": a dense K/V cache, "cross_k", "cross_v": the
encoder's projected K/V [B, Te, Hkv, D]}`` in ``cache_dtype``; there is
no paged path, as in the reference.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import (cross_attention, gqa_attention,
                                          gqa_decode, gqa_params,
                                          init_kv_cache, prefill_kv_cache)
from repro_torch.models.common import (Params, dense_init, embed_init, mm,
                                       rmsnorm, rmsnorm_init, rope_cos_sin,
                                       scan_layers, scan_layers_with_cache,
                                       softmax_cross_entropy, stacked_init,
                                       text_positions)
from repro_torch.models.mlp import mlp_apply, mlp_params
from repro_torch.models.transformer import (ModelBundle, _check_compute_dtype,
                                            _generator)


def _norm(cfg: ArchConfig, dtype, device):
    return {"scale": rmsnorm_init(cfg.d_model, dtype, device=device)}


def _attn(cfg: ArchConfig, dtype, **kw):
    return gqa_params(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.resolved_head_dim, dtype, **kw)


def enc_layer_params(cfg: ArchConfig, dtype, *, device,
                     generator: Optional[torch.Generator]) -> Params:
    kw = dict(device=device, generator=generator)
    return {"ln1": _norm(cfg, dtype, device), "attn": _attn(cfg, dtype, **kw),
            "ln2": _norm(cfg, dtype, device),
            "mlp": mlp_params(cfg.d_model, cfg.d_ff, cfg.act, dtype, **kw)}


def dec_layer_params(cfg: ArchConfig, dtype, *, device,
                     generator: Optional[torch.Generator]) -> Params:
    kw = dict(device=device, generator=generator)
    return {"ln1": _norm(cfg, dtype, device),
            "self_attn": _attn(cfg, dtype, **kw),
            "ln_x": _norm(cfg, dtype, device),
            "cross_attn": _attn(cfg, dtype, **kw),
            "ln2": _norm(cfg, dtype, device),
            "mlp": mlp_params(cfg.d_model, cfg.d_ff, cfg.act, dtype, **kw)}


def build_encdec(cfg: ArchConfig, *, param_dtype=torch.float32,
                 compute_dtype=None, remat: bool = False,
                 impl: str = "auto", cache_dtype=torch.bfloat16,
                 device="cuda", generator: Optional[torch.Generator] = None
                 ) -> ModelBundle:
    """The encoder-decoder (``repro/models/encdec.py:54``).  Batches
    carry ``frames`` [B, Tf, d] besides ``tokens`` and ``labels``;
    ``prefill`` takes ``frames`` and ``tokens`` (and ``max_len``).
    ``impl`` picks the decoder's causal self-attention of training and of
    the prefill; ``compute_dtype``, ``remat`` and ``cache_dtype`` are
    :func:`~repro_torch.models.transformer.build_decoder_lm`'s (remat
    recomputes each encoder and decoder layer)."""
    if not (cfg.family == "audio" or cfg.is_encoder_decoder):
        raise ValueError(f"{cfg.name}: build_encdec takes the encoder-"
                         f"decoder family")
    device = torch.device(device)
    compute_dtype = compute_dtype or param_dtype
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    eps = cfg.norm_eps
    akw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=hd)

    def init(gen: Optional[torch.Generator] = None) -> Params:
        kw = dict(device=device,
                  generator=_generator(gen, generator, device))
        return {
            "embed": embed_init(cfg.padded_vocab, cfg.d_model, param_dtype,
                                **kw),
            "enc_layers": stacked_init(
                lambda: enc_layer_params(cfg, param_dtype, **kw),
                cfg.n_encoder_layers),
            "enc_norm": _norm(cfg, param_dtype, device),
            "dec_layers": stacked_init(
                lambda: dec_layer_params(cfg, param_dtype, **kw),
                cfg.n_layers),
            "final_norm": _norm(cfg, param_dtype, device),
            "lm_head": dense_init(cfg.d_model, cfg.padded_vocab,
                                  param_dtype, **kw),
        }

    def _rope(b, s, dev):
        return rope_cos_sin(text_positions(b, s, device=dev), hd,
                            cfg.rope_theta)

    def encode(params: Params, frames):
        """frames [B,Tf,d] (the stub frontend's output) -> the encoder's
        normed states [B,Tf,d]."""
        _check_compute_dtype(param_dtype, compute_dtype)
        x = frames.to(compute_dtype)
        cos, sin = _rope(x.shape[0], x.shape[1], x.device)

        def body(x, lp, cos, sin):
            x = x + gqa_attention(lp["attn"],
                                  rmsnorm(lp["ln1"]["scale"], x, eps),
                                  cos, sin, causal=False, impl=impl, **akw)
            return x + mlp_apply(lp["mlp"], rmsnorm(lp["ln2"]["scale"], x,
                                                    eps), cfg.act)

        x = scan_layers(body, x, params["enc_layers"], remat=remat,
                        consts=(cos, sin))
        return rmsnorm(params["enc_norm"]["scale"], x, eps)

    def _cross_kv(lp, enc):
        b, te, _ = enc.shape
        return (mm(enc, lp["cross_attn"]["wk"]).reshape(b, te, Hkv, hd),
                mm(enc, lp["cross_attn"]["wv"]).reshape(b, te, Hkv, hd))

    def _cross_and_mlp(lp, x, ek, ev):
        hx = rmsnorm(lp["ln_x"]["scale"], x, eps)
        x = x + cross_attention(lp["cross_attn"], hx, ek, ev, None, **akw)
        return x + mlp_apply(lp["mlp"], rmsnorm(lp["ln2"]["scale"], x, eps),
                             cfg.act)

    def dec_layer(x, lp, enc, cos, sin):
        # one alias of enc a layer: its cotangent sums the layer's two
        # uses (the cross K and V) before the layers' sums meet, as a
        # remat'd layer's returned gradient does, so remat keeps the bits
        enc = enc.view_as(enc)
        x = x + gqa_attention(lp["self_attn"],
                              rmsnorm(lp["ln1"]["scale"], x, eps), cos, sin,
                              impl=impl, **akw)
        return _cross_and_mlp(lp, x, *_cross_kv(lp, enc))

    def loss_fn(params: Params, batch):
        enc = encode(params, batch["frames"])
        x = params["embed"][batch["tokens"].long()].to(compute_dtype)
        cos, sin = _rope(x.shape[0], x.shape[1], x.device)
        x = scan_layers(dec_layer, x, params["dec_layers"], remat=remat,
                        consts=(enc, cos, sin))
        h = rmsnorm(params["final_norm"]["scale"], x, eps)
        return softmax_cross_entropy(mm(h, params["lm_head"]),
                                     batch["labels"], batch.get("mask"))

    # --------------------------- serving ----------------------------- #

    def init_cache(batch: int, max_len: int, enc_len: int = 0) -> List:
        enc_len = enc_len or cfg.frontend_tokens
        shape = (batch, enc_len, Hkv, hd)
        return [{"self": init_kv_cache(batch, max_len, Hkv, hd, cache_dtype,
                                       device=device),
                 "cross_k": torch.zeros(shape, dtype=cache_dtype,
                                        device=device),
                 "cross_v": torch.zeros(shape, dtype=cache_dtype,
                                        device=device)}
                for _ in range(cfg.n_layers)]

    @torch.no_grad()
    def prefill(params: Params, batch):
        """``frames`` [B,Tf,d] and the prompt ``tokens`` [B,S] ->
        (last-position logits [B,V], each decoder layer's cache: the
        prompt's K/V in ``max_len`` positions and the cross K/V)."""
        enc = encode(params, batch["frames"])
        x = params["embed"][batch["tokens"].long()].to(compute_dtype)
        b, s, _ = x.shape
        max_len = int(batch.get("max_len", s))
        cos, sin = _rope(b, s, x.device)

        def body(x, lp, _):
            h_in = rmsnorm(lp["ln1"]["scale"], x, eps)
            x = x + gqa_attention(lp["self_attn"], h_in, cos, sin, impl=impl,
                                  **akw)
            kv = prefill_kv_cache(lp["self_attn"], h_in, cos, sin,
                                  max_len=max_len, dtype=cache_dtype, **akw)
            ek, ev = _cross_kv(lp, enc)
            return _cross_and_mlp(lp, x, ek, ev), {
                "self": kv, "cross_k": ek.to(cache_dtype),
                "cross_v": ev.to(cache_dtype)}

        x, cache = scan_layers_with_cache(body, x, params["dec_layers"],
                                          [None] * cfg.n_layers)
        h = rmsnorm(params["final_norm"]["scale"], x, eps)
        return mm(h[:, -1], params["lm_head"]), cache

    @torch.no_grad()
    def decode_step(params: Params, tokens, cache):
        """tokens [B] -> (logits [B,V], cache): causal self-attention over
        the dense cache, cross-attention over the cached encoder K/V."""
        b = tokens.shape[0]
        pos = torch.full((b, 1), cache[0]["self"]["pos"], dtype=torch.int32,
                         device=tokens.device)
        cos, sin = rope_cos_sin(pos, hd, cfg.rope_theta)
        x = params["embed"][tokens.long()][:, None].to(compute_dtype)

        def body(x, lp, st):
            h, kv = gqa_decode(lp["self_attn"],
                               rmsnorm(lp["ln1"]["scale"], x, eps),
                               st["self"], cos, sin, **akw)
            x = _cross_and_mlp(lp, x + h, st["cross_k"].to(x.dtype),
                               st["cross_v"].to(x.dtype))
            return x, dict(st, self=kv)

        x, cache = scan_layers_with_cache(body, x, params["dec_layers"],
                                          cache)
        h = rmsnorm(params["final_norm"]["scale"], x[:, 0], eps)
        return mm(h, params["lm_head"]), cache

    return ModelBundle(cfg=cfg, device=device, init=init, init_train=init,
                       loss_fn=loss_fn, prefill=prefill,
                       decode_step=decode_step, init_cache=init_cache)
