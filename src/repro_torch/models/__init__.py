"""Model zoo: ``build(cfg, **options)`` returns a ModelBundle.

Ported so far: the dense GQA decoders (yi-34b, starcoder2-15b,
deepseek-67b, mistral-large-123b); other families raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ops import IMPLS
from repro_torch.models.transformer import ModelBundle, build_decoder_lm


def build(cfg: ArchConfig, *, param_dtype=torch.float32,
          cache_dtype=torch.bfloat16, decode_impl: str = "auto",
          device="cuda",
          generator: Optional[torch.Generator] = None) -> ModelBundle:
    if decode_impl not in IMPLS:
        raise ValueError(f"decode_impl {decode_impl!r} not in {IMPLS}")
    return build_decoder_lm(cfg, param_dtype=param_dtype,
                            cache_dtype=cache_dtype, decode_impl=decode_impl,
                            device=device, generator=generator)
