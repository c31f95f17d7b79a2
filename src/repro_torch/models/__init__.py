"""Model zoo: ``build(cfg, **options)`` returns a ModelBundle.

Ported so far: the dense GQA decoders (yi-34b, starcoder2-15b,
deepseek-67b, mistral-large-123b) for training and paged serving, and the
RWKV-6 LM (rwkv6-1.6b) for training; other families raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ops import IMPLS
from repro_torch.models.transformer import (ModelBundle, build_decoder_lm,
                                            build_rwkv_lm)


def build(cfg: ArchConfig, *, param_dtype=torch.float32,
          cache_dtype=torch.bfloat16, impl: str = "auto",
          decode_impl: str = "auto", device="cuda",
          generator: Optional[torch.Generator] = None) -> ModelBundle:
    """``impl`` picks the training kernels (attention, WKV);
    ``decode_impl`` the paged decode attention: "auto" / "kernel" /
    "plain" (kernels/ops.py)."""
    for name, val in (("impl", impl), ("decode_impl", decode_impl)):
        if val not in IMPLS:
            raise ValueError(f"{name} {val!r} not in {IMPLS}")
    if cfg.family == "ssm":
        return build_rwkv_lm(cfg, param_dtype=param_dtype, impl=impl,
                             device=device, generator=generator)
    return build_decoder_lm(cfg, param_dtype=param_dtype,
                            cache_dtype=cache_dtype, decode_impl=decode_impl,
                            impl=impl, device=device, generator=generator)
