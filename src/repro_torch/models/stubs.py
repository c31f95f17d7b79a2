"""Modality-frontend stubs and synthetic training batches (PyTorch port of
``repro/models/stubs.py``).

For the [vlm] and [audio] architectures only the transformer backbone is
implemented; the ViT encoder and the speech frontend are replaced by
precomputed embeddings of the right shape (random, from the caller's
generator): patch embeddings with the (t, h, w) position grid that M-RoPE
consumes, and frame embeddings for the encoder-decoder.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig


def vision_patch_embeds(generator: torch.Generator, batch: int,
                        n_patches: int, d_model: int,
                        dtype=torch.float32) -> torch.Tensor:
    """Stub ViT output: [B, n_patches, d_model], 0.02 x standard normal,
    on the generator's device."""
    x = torch.randn((batch, n_patches, d_model), generator=generator,
                    device=generator.device)
    return (0.02 * x).to(dtype)


def mrope_positions(batch: int, n_patches: int, text_len: int,
                    grid: Optional[Tuple[int, int, int]] = None, *,
                    device=None) -> torch.Tensor:
    """Qwen2-VL position ids [B, n_patches + text_len, 3] (t, h, w), int32.

    Vision tokens get grid coordinates; text tokens continue sequentially
    from max(grid) with t == h == w."""
    if grid is None:
        side = int(round(n_patches ** 0.5))
        while n_patches % side:
            side -= 1
        grid = (1, side, n_patches // side)
    t, h, w = grid
    assert t * h * w == n_patches, (grid, n_patches)
    tt, hh, ww = torch.meshgrid(torch.arange(t, device=device),
                                torch.arange(h, device=device),
                                torch.arange(w, device=device),
                                indexing="ij")
    vis = torch.stack([tt.reshape(-1), hh.reshape(-1), ww.reshape(-1)],
                      dim=-1)
    txt = int(max(grid)) + torch.arange(text_len, device=device)
    txt = torch.stack([txt, txt, txt], dim=-1)
    pos = torch.cat([vis, txt], dim=0).to(torch.int32)
    return pos[None].expand(batch, n_patches + text_len, 3)


def audio_frame_embeds(generator: torch.Generator, batch: int,
                       n_frames: int, d_model: int,
                       dtype=torch.float32) -> torch.Tensor:
    """Stub speech-frontend output: [B, n_frames, d_model], 0.02 x
    standard normal, on the generator's device."""
    x = torch.randn((batch, n_frames, d_model), generator=generator,
                    device=generator.device)
    return (0.02 * x).to(dtype)


def make_train_batch(generator: torch.Generator, cfg: ArchConfig,
                     batch: int, seq_len: int,
                     dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A runnable synthetic batch honoring the family's input contract, on
    the generator's device: {'tokens', 'labels'} int32 [batch, seq_len],
    uniform over the vocab; for [vlm], ``min(frontend_tokens,
    seq_len // 4)`` patch embeddings ('vision_embeds' [batch, Nv, d]) in
    front of seq_len - Nv text tokens, and their 'positions'
    [batch, seq_len, 3]; for [audio], ``min(frontend_tokens, max(4,
    seq_len // 4))`` stub frames ('frames' [batch, Tf, d]) beside
    seq_len tokens and labels."""
    kw = dict(generator=generator, device=generator.device,
              dtype=torch.int32)
    if cfg.family == "audio":
        tf = min(cfg.frontend_tokens, max(4, seq_len // 4))
        return {
            "frames": audio_frame_embeds(generator, batch, tf, cfg.d_model,
                                         dtype),
            "tokens": torch.randint(0, cfg.vocab_size, (batch, seq_len),
                                    **kw),
            "labels": torch.randint(0, cfg.vocab_size, (batch, seq_len),
                                    **kw),
        }
    if cfg.family == "vlm":
        nv = min(cfg.frontend_tokens, max(1, seq_len // 4))
        st = seq_len - nv
        return {
            "tokens": torch.randint(0, cfg.vocab_size, (batch, st), **kw),
            "labels": torch.randint(0, cfg.vocab_size, (batch, st), **kw),
            "vision_embeds": vision_patch_embeds(generator, batch, nv,
                                                 cfg.d_model, dtype),
            "positions": mrope_positions(batch, nv, st,
                                         device=generator.device),
        }
    return {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq_len),
                                    **kw),
            "labels": torch.randint(0, cfg.vocab_size, (batch, seq_len),
                                    **kw)}
