"""Feed-forward blocks: SwiGLU (3-matrix) and classic 2-matrix MLPs
(PyTorch port of ``repro/models/mlp.py``).

The leaves ``w_gate`` (SwiGLU only), ``w_up`` and ``w_down`` are the
attributes of the serving path's :class:`MLP` module, or the keys of the
training path's dict (:func:`mlp_params`)."""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from repro_torch.models.common import activation, dense_init, mm


def mlp_params(d_model: int, d_ff: int, act: str = "silu",
               dtype=torch.float32, *, device,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """The reference's leaves, each ``[d_in, d_out]``."""
    kw = dict(device=device, generator=generator)
    p = {}
    if act == "silu":  # SwiGLU
        p["w_gate"] = dense_init(d_model, d_ff, dtype, **kw)
    p["w_up"] = dense_init(d_model, d_ff, dtype, **kw)
    p["w_down"] = dense_init(d_ff, d_model, dtype, **kw)
    return p


class MLP(nn.Module):
    """Parameters named as the reference's pytree leaves: ``w_gate``
    (SwiGLU only), ``w_up``, ``w_down``, each ``[d_in, d_out]``."""

    def __init__(self, d_model: int, d_ff: int, act: str = "silu",
                 dtype=torch.float32, *, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = act
        for name, w in mlp_params(d_model, d_ff, act, dtype, device=device,
                                  generator=generator).items():
            setattr(self, name, nn.Parameter(w))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self, x, self.act)


def mlp_init(d_model: int, d_ff: int, act: str = "silu",
             dtype=torch.float32, *, device,
             generator: Optional[torch.Generator] = None) -> MLP:
    return MLP(d_model, d_ff, act, dtype, device=device, generator=generator)


def mlp_apply(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """``p``: an :class:`MLP` or a dict of its leaves.  Products take the
    promoted type of x and the leaves, as the reference's do."""
    get = p.get if isinstance(p, Mapping) else \
        (lambda name: getattr(p, name, None))
    fn = activation(act)
    if get("w_gate") is not None:
        return mm(fn(mm(x, get("w_gate"))) * mm(x, get("w_up")),
                  get("w_down"))
    return mm(fn(mm(x, get("w_up"))), get("w_down"))
