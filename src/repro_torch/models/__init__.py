"""Model zoo: ``build(cfg, **options)`` returns a ModelBundle.

Ported so far: the dense GQA decoders (yi-34b, starcoder2-15b,
deepseek-67b, mistral-large-123b) for training and paged serving; the MoE
and MLA decoders (deepseek-v2-lite-16b, phi3.5-moe-42b-a6.6b), the
M-RoPE VLM backbone (qwen2-vl-2b) and the RWKV-6 LM (rwkv6-1.6b) for
training; other families, and the serving of those four, raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ops import IMPLS
from repro_torch.models.transformer import (ModelBundle, build_decoder_lm,
                                            build_rwkv_lm)


def build(cfg: ArchConfig, *, param_dtype=torch.float32, compute_dtype=None,
          remat: bool = False, cache_dtype=torch.bfloat16, impl: str = "auto",
          decode_impl: str = "auto", device="cuda",
          generator: Optional[torch.Generator] = None) -> ModelBundle:
    """``impl`` picks the training kernels (attention, WKV);
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
    return build_decoder_lm(cfg, param_dtype=param_dtype,
                            compute_dtype=compute_dtype, remat=remat,
                            cache_dtype=cache_dtype, decode_impl=decode_impl,
                            impl=impl, device=device, generator=generator)
