"""Synthetic but *learnable* data (PyTorch port of
``repro/data/synthetic.py``).

Samplers draw from a ``torch.Generator`` on the generator's device.  They
follow the reference's distributions, not its random bits (jax threefry
and torch Philox differ): parity tests feed both packages numpy data, and
the Markov chain's transition logits can be handed in as numpy.

  * markov LM: tokens follow a fixed random first-order Markov chain;
    cross-entropy has a known floor (the chain's conditional entropy).
  * gaussian-mixture classification: the CIFAR stand-in for the paper's
    K2/K1/S sweeps.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch


def make_markov_task(vocab: int, temperature: float = 1.5,
                     seed: int = 1234, *, device="cuda",
                     logits: Optional[np.ndarray] = None
                     ) -> Tuple[torch.Tensor, float]:
    """(transition logits [V, V] fp32 on ``device``, per-token entropy
    floor in nats).  The logits are ``temperature`` times a standard
    normal draw seeded by ``seed``, or the given numpy ``logits`` (the
    reference's, in the parity tests).  The floor is the conditional
    entropy under the stationary distribution (64 power iterations from
    uniform), in fp32 as the reference computes it."""
    if logits is None:
        g = torch.Generator(device=device).manual_seed(seed)
        lg = torch.randn((vocab, vocab), generator=g, device=device) \
            * temperature
    else:
        lg = torch.from_numpy(np.array(logits, np.float32)).to(device)
    logp = torch.log_softmax(lg, dim=-1)
    p = torch.exp(logp)
    cond_ent = -torch.sum(p * logp, dim=-1)                   # [V]
    pi = torch.full((lg.shape[0],), 1.0 / lg.shape[0], device=device)
    for _ in range(64):
        pi = pi @ p
    return lg, float(torch.sum(pi * cond_ent))


def markov_lm_batch(generator: torch.Generator, n: int, seq: int,
                    logits: torch.Tensor) -> Dict[str, torch.Tensor]:
    """n chains of seq + 1 tokens (the first uniform, each next drawn
    from the chain's row of the one before) -> {'tokens', 'labels'},
    int32 [n, seq], labels the tokens shifted by one."""
    probs = torch.softmax(logits.float(), dim=-1)
    tok = torch.randint(0, logits.shape[0], (n,), generator=generator,
                        device=logits.device)
    toks = [tok]
    for _ in range(seq):
        tok = torch.multinomial(probs[tok], 1, generator=generator)[:, 0]
        toks.append(tok)
    t = torch.stack(toks, 1).to(torch.int32)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


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
