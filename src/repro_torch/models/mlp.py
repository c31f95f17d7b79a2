"""Feed-forward blocks: SwiGLU (3-matrix) and classic 2-matrix MLPs
(PyTorch port of ``repro/models/mlp.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models.common import activation, dense_init


class MLP(nn.Module):
    """Parameters named as the reference's pytree leaves: ``w_gate``
    (SwiGLU only), ``w_up``, ``w_down``, each ``[d_in, d_out]``."""

    def __init__(self, d_model: int, d_ff: int, act: str = "silu",
                 dtype=torch.float32, *, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = act
        kw = dict(device=device, generator=generator)
        if act == "silu":  # SwiGLU
            self.w_gate = nn.Parameter(dense_init(d_model, d_ff, dtype, **kw))
        self.w_up = nn.Parameter(dense_init(d_model, d_ff, dtype, **kw))
        self.w_down = nn.Parameter(dense_init(d_ff, d_model, dtype, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self, x, self.act)


def mlp_init(d_model: int, d_ff: int, act: str = "silu",
             dtype=torch.float32, *, device,
             generator: Optional[torch.Generator] = None) -> MLP:
    return MLP(d_model, d_ff, act, dtype, device=device, generator=generator)


def mlp_apply(p: MLP, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    fn = activation(act)
    if hasattr(p, "w_gate"):
        return (fn(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down
    return fn(x @ p.w_up) @ p.w_down
