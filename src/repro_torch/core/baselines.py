"""Baselines the paper compares against, as Hier-AVG special cases
(PyTorch port of ``repro/core/baselines.py``).

  * K-AVG (Zhou & Cong 2018):   K1 == K2 (equivalently S == 1) — no local
    reductions, one global reduction every K steps.
  * Synchronous parallel SGD (Zinkevich et al. 2010): K1 == K2 == 1 — a
    global reduction after every step (== large-batch sequential SGD).

Both reuse the Hier-AVG round machinery, so every comparison is
apples-to-apples (same data order, same optimizer, same numerics).
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.configs.base import HierAvgParams
from repro_torch.core.hier_avg import make_hier_round
from repro_torch.optim import Optimizer


def make_kavg_round(loss_fn: Callable, optimizer: Optimizer, k: int, *,
                    constraint_fn: Optional[Callable] = None,
                    grad_postprocess: Optional[Callable] = None,
                    reducer=None):
    """K-AVG with averaging interval K: local reductions disabled."""
    hier = HierAvgParams(k1=k, k2=k)
    return make_hier_round(loss_fn, optimizer, hier, skip_local=True,
                           constraint_fn=constraint_fn,
                           grad_postprocess=grad_postprocess,
                           reducer=reducer)


def make_sync_sgd_round(loss_fn: Callable, optimizer: Optimizer, *,
                        constraint_fn: Optional[Callable] = None,
                        grad_postprocess: Optional[Callable] = None,
                        reducer=None):
    """Fully synchronous parallel SGD: one round == one step == one
    global reduction."""
    hier = HierAvgParams(k1=1, k2=1)
    return make_hier_round(loss_fn, optimizer, hier, skip_local=True,
                           constraint_fn=constraint_fn,
                           grad_postprocess=grad_postprocess,
                           reducer=reducer)
