"""Minimal functional optimizers (PyTorch port of
``repro/optim/optimizers.py``).

An :class:`Optimizer` is a pair of plain functions on trees of tensors, not
a ``torch.optim`` class: state trees mirror the param tree, so they keep
the Hier-AVG stacked-learner layout (each learner gets its own optimizer
state slice).  Updates are computed in fp32 and cast back to each
parameter's dtype, as in the reference; they return new tensors and never
write into their inputs.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten, leaves, tree_map, unflatten


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, int], Tuple[Any, Any]]
    # update(grads, params, opt_state, step) -> (new_params, new_opt_state)


def _lr_at(lr, step: int) -> float:
    # the reference holds the rate as an fp32 scalar
    return float(np.float32(lr(step) if callable(lr) else lr))


def _map_n(fn, n: int, tree, *rest):
    """``fn`` over aligned leaves returning n-tuples -> n trees."""
    flat, treedef = flatten(tree)
    outs = [fn(*xs) for xs in zip(flat, *(leaves(r) for r in rest))]
    return tuple(unflatten(treedef, [o[i] for o in outs]) for i in range(n))


def sgd(lr, momentum: float = 0.0, nesterov: bool = False,
        weight_decay: float = 0.0) -> Optimizer:
    """Plain / momentum SGD — the paper's optimizer (lr 0.1 -> 0.01 step decay)."""

    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, params, state, step):
        g = _lr_at(lr, step)

        def upd(p, gr, m=None):
            gr = gr.float()
            if weight_decay:
                gr = gr + weight_decay * p.float()
            if momentum == 0.0:
                return (p.float() - g * gr).to(p.dtype), None
            m_new = momentum * m + gr
            d = gr + momentum * m_new if nesterov else m_new
            return (p.float() - g * d).to(p.dtype), m_new.to(m.dtype)

        if momentum == 0.0:
            return tree_map(lambda p, gr: upd(p, gr)[0], params, grads), ()
        return _map_n(upd, 2, params, grads, state)

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:

    def init(params):
        z = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
        return {"mu": z, "nu": tree_map(torch.zeros_like, z)}

    def update(grads, params, state, step):
        g = _lr_at(lr, step)
        # bias corrections in fp32, as the reference computes them
        t = np.float32(step) + np.float32(1.0)
        c1 = float(np.float32(1.0) - np.float32(b1) ** t)
        c2 = float(np.float32(1.0) - np.float32(b2) ** t)

        def upd(p, gr, mu, nu):
            gr = gr.float()
            mu = b1 * mu + (1 - b1) * gr
            nu = b2 * nu + (1 - b2) * torch.square(gr)
            d = (mu / c1) / (torch.sqrt(nu / c2) + eps)
            if weight_decay:
                d = d + weight_decay * p.float()
            return (p.float() - g * d).to(p.dtype), mu, nu

        new_p, mu, nu = _map_n(upd, 3, params, grads, state["mu"],
                               state["nu"])
        return new_p, {"mu": mu, "nu": nu}

    return Optimizer(init, update)
