"""Learning-rate schedules (PyTorch port of ``repro/optim/schedules.py``).

A schedule is a callable of the int step returning the rate as a Python
float, computed in fp32 as the reference computes it.  The paper's CIFAR
recipe: constant 0.1 for 150 epochs, then 0.01 (``step_decay_lr``).
Theorem 3.1's rate-optimal constant step is ``gamma = sqrt(P*B/T)``
(``thm31_lr``).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

f32 = np.float32


def constant_lr(lr: float):
    def f(step):
        return float(f32(lr))
    return f


def step_decay_lr(base: float, boundaries: Sequence[int],
                  decays: Sequence[float]):
    """Paper-style piecewise-constant decay (e.g. 0.1 -> 0.01 at epoch 150)."""
    bs = tuple(boundaries)
    ds = tuple(decays)
    if len(bs) != len(ds):
        raise ValueError(f"{len(bs)} boundaries for {len(ds)} decays")

    def f(step):
        lr = f32(base)
        for b, d in zip(bs, ds):
            if step >= b:
                lr = f32(base * d)
        return float(lr)
    return f


def cosine_lr(base: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = np.clip(f32(step) / f32(max(1, total_steps)), f32(0), f32(1))
        c = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * t))
        return float(f32(base * (final_frac + (1 - final_frac) * c)))
    return f


def warmup_cosine_lr(base: float, warmup: int, total_steps: int,
                     final_frac: float = 0.1):
    cos = cosine_lr(base, max(1, total_steps - warmup), final_frac)

    def f(step):
        w = min(f32(step) / f32(max(1, warmup)), f32(1.0))
        return float(f32(w) * f32(cos(max(step - warmup, 0))))
    return f


def thm31_lr(P: int, B: int, T: int) -> float:
    """Theorem 3.1 rate-optimal constant step size: sqrt(P*B/T)."""
    return math.sqrt(P * B / T)


def thm31_k2(P: int, B: int, T: int) -> int:
    """Theorem 3.1 admissible global-averaging interval T^1/4 / (PB)^3/4."""
    return max(1, int(round(T ** 0.25 / (P * B) ** 0.75)))
