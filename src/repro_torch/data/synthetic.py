"""Synthetic but *learnable* data (PyTorch port of the classification half
of ``repro/data/synthetic.py``; the Markov LM sampler arrives with the LM
training stack, ROADMAP Queue 1 item 4).

Samplers draw from a ``torch.Generator`` on the generator's device.  They
follow the reference's distributions, not its random bits (jax threefry
and torch Philox differ): parity tests feed both packages numpy data.

  * gaussian-mixture classification: the CIFAR stand-in for the paper's
    K2/K1/S sweeps.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch


def make_classification_task(in_dim: int, n_classes: int, seed: int = 4321,
                             noise: float = 0.6, *, device="cuda"
                             ) -> Callable:
    """Gaussian mixture: class means on a random simplex; returns sampler
    sample(generator, n) -> {'x': [n, in_dim] fp32, 'y': [n] int64}, drawn
    on ``device`` (the generator must live there too)."""
    g = torch.Generator(device=device).manual_seed(seed)
    means = torch.randn((n_classes, in_dim), generator=g, device=device)
    means = means / torch.linalg.norm(means, dim=-1, keepdim=True) * 2.0

    def sample(gen: torch.Generator, n: int) -> Dict[str, torch.Tensor]:
        y = torch.randint(0, n_classes, (n,), generator=gen, device=device)
        x = means[y] + noise * torch.randn((n, in_dim), generator=gen,
                                           device=device)
        return {"x": x, "y": y}

    return sample


def gaussian_mixture_batch(generator: torch.Generator, n: int,
                           in_dim: int = 64, n_classes: int = 10, *,
                           device="cuda") -> Dict[str, torch.Tensor]:
    return make_classification_task(in_dim, n_classes,
                                    device=device)(generator, n)
