"""Hymba hybrid block [arXiv:2411.13676] (PyTorch port of
``repro/models/hybrid.py``): attention heads and Mamba (SSM) heads run in
parallel on the same normalized input; each branch's output is
re-normalized and the two are averaged before the residual add.
Attention uses a sliding window (the release's few global-attention
layers are approximated by the same window, as in the reference), through
``kernels.ops.flash_attention`` in training and the prefill; the decode
attends over a rolling cache of ``window`` positions.  Parameters are
dicts with the reference's keys (:func:`hymba_block_params`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import mamba as mam
from repro_torch.models.attention import (gqa_attention, gqa_decode,
                                          gqa_params, init_kv_cache)
from repro_torch.models.common import Params, rmsnorm, rmsnorm_init
from repro_torch.models.mlp import mlp_apply, mlp_params


def hymba_block_params(*, d_model: int, n_heads: int, n_kv_heads: int,
                       head_dim: int, d_ff: int, ssm_state: int,
                       ssm_expand: int, act: str, dtype=torch.float32,
                       device,
                       generator: Optional[torch.Generator] = None
                       ) -> Params:
    kw = dict(device=device, generator=generator)

    def norm():
        return {"scale": rmsnorm_init(d_model, dtype, device=device)}

    return {
        "ln_in": norm(),
        "attn": gqa_params(d_model, n_heads, n_kv_heads, head_dim, dtype,
                           **kw),
        "ssm": mam.mamba_params(d_model, d_model * ssm_expand, ssm_state,
                                dtype, **kw),
        "ln_attn": norm(),
        "ln_ssm": norm(),
        "ln_mlp": norm(),
        "mlp": mlp_params(d_model, d_ff, act, dtype, **kw),
    }


def _fuse(p, x, a, m, eps, act):
    """The branches' re-normed average, the residual add and the MLP."""
    fused = 0.5 * (rmsnorm(p["ln_attn"]["scale"], a, eps)
                   + rmsnorm(p["ln_ssm"]["scale"], m, eps))
    x = x + fused
    return x + mlp_apply(p["mlp"], rmsnorm(p["ln_mlp"]["scale"], x, eps),
                         act)


def hymba_block_apply(p, x, cos, sin, *, n_heads, n_kv_heads, head_dim,
                      ssm_state, window, eps, act, impl: str = "auto",
                      remat: bool = False):
    """One block, full sequence (training) -> x.  ``remat``: the block
    runs rematerialized, so its scan chunks do not remat again
    (models/mamba.py)."""
    h = rmsnorm(p["ln_in"]["scale"], x, eps)
    a = gqa_attention(p["attn"], h, cos, sin, n_heads=n_heads,
                      n_kv_heads=n_kv_heads, head_dim=head_dim,
                      window=window, impl=impl)
    m, _, _ = mam.mamba_apply(p["ssm"], h, state=ssm_state,
                              chunk_remat=not remat)
    return _fuse(p, x, a, m, eps, act)


def hymba_block_decode(p, x, state: Dict, cos, sin, *, n_heads, n_kv_heads,
                       head_dim, ssm_state, eps, act
                       ) -> Tuple[torch.Tensor, Dict]:
    """One token against the block's state {kv (rolling), ssm, conv}."""
    h = rmsnorm(p["ln_in"]["scale"], x, eps)
    a, kv = gqa_decode(p["attn"], h, state["kv"], cos, sin, n_heads=n_heads,
                       n_kv_heads=n_kv_heads, head_dim=head_dim,
                       rolling=True)
    m, ssm = mam.mamba_decode(p["ssm"], h, {"ssm": state["ssm"],
                                            "conv": state["conv"]},
                              state=ssm_state)
    return _fuse(p, x, a, m, eps, act), {"kv": kv, "ssm": ssm["ssm"],
                                         "conv": ssm["conv"]}


def init_hymba_state(batch: int, *, d_model: int, n_kv_heads: int,
                     head_dim: int, ssm_state: int, ssm_expand: int,
                     window: int, dtype=torch.bfloat16, device) -> Dict:
    """A block's zero state: a rolling K/V cache of ``window`` positions
    in ``dtype``, and the fp32 SSM and conv states."""
    kv = init_kv_cache(batch, window, n_kv_heads, head_dim, dtype,
                       rolling=True, window=window, device=device)
    ms = mam.init_mamba_state(batch, d_model * ssm_expand, ssm_state,
                              device=device)
    return {"kv": kv, "ssm": ms["ssm"], "conv": ms["conv"]}
