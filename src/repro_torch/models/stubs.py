"""Synthetic training batches (PyTorch port of ``make_train_batch`` in
``repro/models/stubs.py``).

Ported: the text families (dense, moe, ssm, hybrid): random tokens and
labels.  The [vlm] and [audio] frontend stubs raise until their families
are ported (ROADMAP Queue 1 items 4 and 9).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig


def make_train_batch(generator: torch.Generator, cfg: ArchConfig,
                     batch: int, seq_len: int) -> Dict[str, torch.Tensor]:
    """{'tokens', 'labels'}: int32 [batch, seq_len], uniform over the
    vocab, on the generator's device."""
    if cfg.family == "vlm":
        raise NotImplementedError("the VLM frontend stub is not ported yet "
                                  "(ROADMAP Queue 1 item 4: M-RoPE/VLM)")
    if cfg.family == "audio":
        raise NotImplementedError("the audio frontend stub is not ported "
                                  "yet (ROADMAP Queue 1 item 9)")
    kw = dict(generator=generator, device=generator.device,
              dtype=torch.int32)
    return {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq_len),
                                    **kw),
            "labels": torch.randint(0, cfg.vocab_size, (batch, seq_len),
                                    **kw)}
