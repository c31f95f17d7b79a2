"""Model zoo: ``build(cfg, **options)`` returns a ModelBundle.

Every family of the reference trains and serves: the dense GQA decoders
(yi-34b, starcoder2-15b, deepseek-67b, mistral-large-123b), the MoE and
MLA decoders (deepseek-v2-lite-16b, phi3.5-moe-42b-a6.6b) and the M-RoPE
VLM backbone (qwen2-vl-2b) through dense and paged caches; the RWKV-6 LM
(rwkv6-1.6b) and the Hymba hybrid LM (hymba-1.5b) through their
constant-size states; the SeamlessM4T-style encoder-decoder
(seamless-m4t-large-v2, stub audio frames) through a dense cache with the
encoder's cross K/V.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ops import IMPLS
from repro_torch.models.encdec import build_encdec
from repro_torch.models.transformer import (ModelBundle, build_decoder_lm,
                                            build_hymba_lm, build_rwkv_lm)


def build(cfg: ArchConfig, *, param_dtype=torch.float32, compute_dtype=None,
          remat: bool = False, impl: str = "auto",
          rolling_decode: bool = False, cache_dtype=torch.bfloat16,
          decode_impl: str = "auto", device="cuda",
          generator: Optional[torch.Generator] = None) -> ModelBundle:
    """``impl`` picks the kernels of training and of the dense prefill
    (attention, WKV); ``rolling_decode`` makes the decoders' dense cache
    a circular buffer of ``cfg.long_context_window`` positions;
    ``decode_impl`` the paged decode attention: "auto" / "kernel" /
    "plain" (kernels/ops.py).  ``compute_dtype`` (None: ``param_dtype``)
    and ``remat`` are the reference's: fp32 compute over bf16 params
    trains in fp32 on bf16 storage, a narrower compute type than the
    params' raises ``TypeError`` when the model runs, and ``remat``
    recomputes each layer in the backward (the same bits, less memory)."""
    for name, val in (("impl", impl), ("decode_impl", decode_impl)):
        if val not in IMPLS:
            raise ValueError(f"{name} {val!r} not in {IMPLS}")
    if cfg.family == "ssm":
        return build_rwkv_lm(cfg, param_dtype=param_dtype,
                             compute_dtype=compute_dtype, remat=remat,
                             impl=impl, device=device, generator=generator)
    kw = dict(param_dtype=param_dtype, compute_dtype=compute_dtype,
              remat=remat, impl=impl, cache_dtype=cache_dtype,
              device=device, generator=generator)
    if cfg.family == "hybrid":
        return build_hymba_lm(cfg, **kw)
    if cfg.family == "audio" or cfg.is_encoder_decoder:
        return build_encdec(cfg, **kw)
    return build_decoder_lm(cfg, param_dtype=param_dtype,
                            compute_dtype=compute_dtype, remat=remat,
                            rolling_decode=rolling_decode,
                            cache_dtype=cache_dtype, decode_impl=decode_impl,
                            impl=impl, device=device, generator=generator)
