"""Mixture-of-Experts layer: top-k router and capacity-based einsum dispatch
(PyTorch port of ``repro/models/moe.py``).

The reference's formulation, kept as it is: tokens are given
expert/capacity slots with one-hot dispatch and combine tensors, and the
expert FFN is one batched product over the expert dimension.  Routing
goes in independent chunks of ``chunk`` tokens along the sequence
(grouped routing: capacity applies per sequence row and chunk), so the
dispatch tensor is O(chunk^2 * top_k * cf) per row; with a dropless
capacity factor (cf >= E / top_k) chunking changes nothing.

Dispatch and combine are products with one-hot tensors, never
``index_add_`` or ``scatter_add``: those are atomic on the card, and their
sums would change from run to run.  A slot holds one token, so the
dispatch product is exact; the combine sums a token's top_k expert
outputs.  The router is fp32 whatever the parameter type.

Supports DeepSeek-style shared experts and the switch-transformer
auxiliary load-balance loss (returned, so the LM adds
``router_aux_coef * aux``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (Params, dense_init, einsum,
                                       stacked_init)
from repro_torch.models.mlp import mlp_apply, mlp_params

DEFAULT_CHUNK = 4096


def moe_params(d_model: int, expert_d_ff: int, n_experts: int,
               n_shared: int, act: str = "silu", dtype=torch.float32, *,
               device, generator: Optional[torch.Generator] = None
               ) -> Params:
    """The reference's leaves: ``router`` [d, E] (fp32), ``experts`` (an
    MLP's leaves stacked on a leading [E, ...] dim) and, with shared
    experts, ``shared`` (one MLP of width expert_d_ff * n_shared)."""
    kw = dict(device=device, generator=generator)
    p: Params = {
        "router": dense_init(d_model, n_experts, torch.float32, **kw),
        "experts": stacked_init(lambda: mlp_params(
            d_model, expert_d_ff, act, dtype, **kw), n_experts),
    }
    if n_shared:
        p["shared"] = mlp_params(d_model, expert_d_ff * n_shared, act,
                                 dtype, **kw)
    return p


def _expert_ffn(experts: Dict[str, torch.Tensor], x_ecd: torch.Tensor,
                act: str) -> torch.Tensor:
    """x [..., E, C, d] through each expert's FFN (leaves [E, ...])."""
    if "w_gate" in experts:
        g = einsum("...ecd,edf->...ecf", x_ecd, experts["w_gate"])
        u = einsum("...ecd,edf->...ecf", x_ecd, experts["w_up"])
        h = F.silu(g) * u
    else:
        h = F.gelu(einsum("...ecd,edf->...ecf", x_ecd, experts["w_up"]),
                   approximate="tanh")
    return einsum("...ecf,efd->...ecd", h, experts["w_down"])


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _gates(router: torch.Tensor, xt: torch.Tensor, valid: torch.Tensor,
           top_k: int):
    """The fp32 router: (probs [..., Tc, E], gate values [..., Tc, k]
    normalized over the k and zero on invalid tokens, expert indices
    [..., Tc, k] by falling probability)."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals * valid[:, None], gate_idx


def _route_chunk(p: Params, xt: torch.Tensor, valid: torch.Tensor, *,
                 n_experts: int, top_k: int, capacity: int, act: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xt [B, Tc, d], valid [Tc] -> (y [B, Tc, d], aux [B]): each row of
    B routed alone, as the reference's vmap over rows does."""
    b, n_tok, _ = xt.shape
    probs, gate_vals, gate_idx = _gates(p["router"], xt, valid, top_k)

    onehot = _one_hot(gate_idx, n_experts, torch.int32)         # [B,Tc,k,E]
    onehot = onehot * valid[:, None, None].to(torch.int32)
    flat = onehot.reshape(b, n_tok * top_k, n_experts)
    pos_in_expert = torch.cumsum(flat, dim=1) * flat - 1        # [B,Tc*k,E]
    pos = pos_in_expert.amax(dim=-1).reshape(b, n_tok, top_k)   # [B,Tc,k]
    fits = pos < capacity

    pos_oh = _one_hot(torch.where(fits, pos, capacity), capacity + 1,
                      xt.dtype)[..., :capacity]                 # [B,Tc,k,C]
    disp = torch.einsum("btke,btkc->btec", onehot.to(xt.dtype), pos_oh)
    comb = torch.einsum("btke,btkc,btk->btec", onehot.float(),
                        pos_oh.float(), gate_vals.float()).to(xt.dtype)

    x_ecd = torch.einsum("btec,btd->becd", disp, xt)           # [B,E,C,d]
    y_ecd = _expert_ffn(p["experts"], x_ecd, act)
    yt = einsum("btec,becd->btd", comb, y_ecd)

    # switch-style load-balance aux loss over valid tokens
    denom = torch.clamp(valid.sum(), min=1.0)
    me = (probs * valid[:, None]).sum(dim=1) / denom            # [B,E]
    ce = onehot.sum(dim=2).float().sum(dim=1) / denom
    aux = n_experts * (me * ce).sum(dim=-1) / top_k
    return yt, aux


def moe_apply(p: Params, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, act: str = "silu",
              chunk: int = DEFAULT_CHUNK
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (out [B, S, d], aux loss fp32 scalar).

    Chunks run along the sequence axis (padded with zero tokens that
    route nowhere); the routing group is one (sequence row, chunk), and
    capacity ceil(chunk * top_k / E * capacity_factor) applies per
    group."""
    b, s, d = x.shape
    tc = min(chunk, s)
    n_chunks = -(-s // tc)
    pad = n_chunks * tc - s
    valid = torch.cat([torch.ones((s,), device=x.device),
                       torch.zeros((pad,), device=x.device)])
    xt = x
    if pad:
        xt = torch.cat([x, torch.zeros((b, pad, d), dtype=x.dtype,
                                       device=x.device)], dim=1)
    capacity = max(1, int(math.ceil(tc * top_k / n_experts
                                    * capacity_factor)))
    ys, auxes = [], []
    for c in range(n_chunks):
        y, a = _route_chunk(p, xt[:, c * tc:(c + 1) * tc],
                            valid[c * tc:(c + 1) * tc],
                            n_experts=n_experts, top_k=top_k,
                            capacity=capacity, act=act)
        ys.append(y)
        auxes.append(a)
    out = torch.cat(ys, dim=1)[:, :s] if n_chunks > 1 else ys[0]
    aux = torch.stack(auxes).mean()
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x, act)
    return out, aux.float()
