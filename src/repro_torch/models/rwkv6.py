"""RWKV-6 "Finch" blocks for training: time-mix with data-dependent decay
and channel-mix (PyTorch port of ``repro/models/rwkv6.py:30-191``).

The WKV6 recurrence per head (head size Dh, state S in R^{Dh x Dh}):

    y_t[i]   = sum_j r_t[j] * ( S_t[j,i] + u[j] * k_t[j] * v_t[i] )
    S_{t+1}  = diag(w_t) S_t + k_t^T v_t          (w_t = data-dependent decay)

runs through ``kernels.ops.rwkv6_wkv`` (the hand-written CUDA kernels on
the card, forward and backward; the plain versions on the CPU).  Token
shift uses the paper's ddlerp.  Parameters are dicts with the reference's
keys; products take the promoted type of their operands, as the
reference's do (fp32 compute over bf16 parameters).  The one-token decode (``timemix_decode``, ``block_decode``) is not
ported yet: ROADMAP Queue 1 item 6.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.common import (Params, dense_init, einsum,
                                       layernorm, layernorm_init, mm,
                                       rmsnorm, rmsnorm_init)

LORA_DIM = 32
DECAY_LORA_DIM = 64
MIX_NAMES = ("w", "k", "v", "r", "g")


def timemix_init(d_model: int, n_heads: int, head_dim: int,
                 dtype=torch.float32, *, device,
                 generator: Optional[torch.Generator] = None) -> Params:
    d_attn = n_heads * head_dim
    kw = dict(device=device, generator=generator)
    u = torch.empty((d_attn,), dtype=torch.float32, device=device)
    u.normal_(generator=generator)
    return {
        # static token-shift interpolants
        "mu_x": torch.full((d_model,), 0.5, dtype=dtype, device=device),
        "mu": torch.full((5, d_model), 0.5, dtype=dtype, device=device),
        # ddlerp low-rank (shared A, per-target B)
        "mix_A": dense_init(d_model, 5 * LORA_DIM, dtype, scale=1e-2, **kw),
        "mix_B": dense_init(LORA_DIM, 5 * d_model, dtype, scale=1e-2, **kw),
        # projections
        "wr": dense_init(d_model, d_attn, dtype, **kw),
        "wk": dense_init(d_model, d_attn, dtype, **kw),
        "wv": dense_init(d_model, d_attn, dtype, **kw),
        "wg": dense_init(d_model, d_attn, dtype, **kw),
        "wo": dense_init(d_attn, d_model, dtype, **kw),
        # data-dependent decay
        "decay_base": torch.linspace(-6.0, -1.0, d_attn,
                                     device=device).to(dtype),
        "decay_A": dense_init(d_model, DECAY_LORA_DIM, dtype, scale=1e-2,
                              **kw),
        "decay_B": dense_init(DECAY_LORA_DIM, d_attn, dtype, scale=1e-2,
                              **kw),
        # per-channel bonus ("time_faaaa")
        "u": (0.1 * u).to(dtype),
        "ln_out": layernorm_init(d_attn, dtype, device=device),
    }


def _ddlerp(p: Params, x: torch.Tensor, x_prev: torch.Tensor):
    """The 5 mixed inputs (w, k, v, r, g), each [B, S, d]."""
    dx = x_prev - x
    xxx = x + dx * p["mu_x"].to(x.dtype)
    lora = torch.tanh(mm(xxx, p["mix_A"]))
    b, s, _ = x.shape
    lora = lora.reshape(b, s, 5, LORA_DIM)
    mix_b = p["mix_B"].reshape(LORA_DIM, 5, -1)
    dyn = einsum("bsfl,lfd->bsfd", lora, mix_b)      # [B,S,5,d]
    mixes = p["mu"].to(x.dtype)[None, None] + dyn
    return [x + dx * mixes[:, :, i] for i in range(5)]    # MIX_NAMES order


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None):
    """Previous-token sequence shift; prev [B, d] fills position 0."""
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def timemix_apply(p: Params, x: torch.Tensor, *, n_heads: int,
                  head_dim: int, eps: float, shift_state=None,
                  wkv_state=None, impl: str = "auto"
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence time-mix.  Returns (out [B, S, d], new shift state
    [B, d] fp32, new WKV state [B, H, Dh, Dh] fp32)."""
    b, s, d = x.shape
    xs = _shift(x, shift_state)
    xw, xk, xv, xr, xg = _ddlerp(p, x, xs)
    r = mm(xr, p["wr"]).reshape(b, s, n_heads, head_dim)
    k = mm(xk, p["wk"]).reshape(b, s, n_heads, head_dim)
    v = mm(xv, p["wv"]).reshape(b, s, n_heads, head_dim)
    g = F.silu(mm(xg, p["wg"]))
    # decay in (0, 1): w = exp(-exp(base + lora))
    dec = p["decay_base"].float() + \
        mm(torch.tanh(mm(xw, p["decay_A"])), p["decay_B"]).float()
    w = torch.exp(-torch.exp(dec)).reshape(b, s, n_heads, head_dim)
    u = p["u"].float().reshape(n_heads, head_dim)
    if wkv_state is None:
        wkv_state = torch.zeros((b, n_heads, head_dim, head_dim),
                                dtype=torch.float32, device=x.device)
    y, new_state = kops.rwkv6_wkv(r, k, v, w, u, wkv_state, impl=impl)
    y = layernorm(p["ln_out"], y.reshape(b, s, n_heads * head_dim), eps)
    out = mm(y * g, p["wo"])
    return out, x[:, -1].float(), new_state


def channelmix_init(d_model: int, d_ff: int, dtype=torch.float32, *, device,
                    generator: Optional[torch.Generator] = None) -> Params:
    kw = dict(device=device, generator=generator)
    return {
        "mu_k": torch.full((d_model,), 0.5, dtype=dtype, device=device),
        "mu_r": torch.full((d_model,), 0.5, dtype=dtype, device=device),
        "wk": dense_init(d_model, d_ff, dtype, **kw),
        "wv": dense_init(d_ff, d_model, dtype, **kw),
        "wr": dense_init(d_model, d_model, dtype, **kw),
    }


def channelmix_apply(p: Params, x: torch.Tensor, shift_state=None):
    xs = _shift(x, shift_state)
    dx = xs - x
    xk = x + dx * p["mu_k"].to(x.dtype)
    xr = x + dx * p["mu_r"].to(x.dtype)
    k = torch.square(F.relu(mm(xk, p["wk"])))
    out = torch.sigmoid(mm(xr, p["wr"])) * mm(k, p["wv"])
    return out, x[:, -1].float()


def block_init(d_model: int, d_ff: int, n_heads: int, head_dim: int,
               dtype=torch.float32, *, device,
               generator: Optional[torch.Generator] = None) -> Params:
    kw = dict(device=device, generator=generator)
    return {
        "ln1": {"scale": rmsnorm_init(d_model, dtype, device=device)},
        "tm": timemix_init(d_model, n_heads, head_dim, dtype, **kw),
        "ln2": {"scale": rmsnorm_init(d_model, dtype, device=device)},
        "cm": channelmix_init(d_model, d_ff, dtype, **kw),
    }


def block_apply(p: Params, x: torch.Tensor, *, n_heads: int, head_dim: int,
                eps: float, impl: str = "auto") -> torch.Tensor:
    h, _, _ = timemix_apply(p["tm"], rmsnorm(p["ln1"]["scale"], x, eps),
                            n_heads=n_heads, head_dim=head_dim, eps=eps,
                            impl=impl)
    x = x + h
    h, _ = channelmix_apply(p["cm"], rmsnorm(p["ln2"]["scale"], x, eps))
    return x + h
