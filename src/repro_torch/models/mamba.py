"""Selective SSM (Mamba-style) head of the Hymba hybrid block (PyTorch
port of ``repro/models/mamba.py``).

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * (B_t (x) u_t)
    y_t = C_t . h_t + D * u_t

with A diagonal (negative) and (dt, B, C) input-dependent ("selective"),
behind the causal depthwise conv1d front (kernel 4) whose last inputs are
carried as the decode's conv state.  The scan runs in fp32 whatever the
compute type, as the reference's does.  The reference runs it as a
``lax.scan`` and has no Pallas kernel for it; the port runs the same step
loop in plain PyTorch, the readout ``C_t . h_t`` of a chunk's steps as one
product after the loop.  The loop is an autograd Function
(:class:`_Scan`: one ``addcmul`` a step forward, the reverse recurrence
written out backward, a product and an ``addcmul`` a step) whose vmap
rule folds the trainer's learners into the batch, as the kernels'
Functions do (``kernels/ops.py``), so each step is one eager call on the
whole grid.

Long sequences scan in chunks of ``chunk`` steps (256): when the
sequence is a multiple of the chunk and longer than one, each chunk runs
under ``models.common._Remat`` (the reference's ``jax.checkpoint`` of the
chunk body), so the backward keeps only the ``[B, Ci, N]`` states at the
chunk boundaries and recomputes a chunk's ``[B, chunk, Ci, N]`` terms.
Inside a layer that is itself rematerialized the chunks run without
their own ``_Remat`` (``chunk_remat=False``): functorch cannot nest the
Function's ``vjp`` in another's backward, and the layer's recomputation
already bounds what is kept to one layer (the reference nests its two
checkpoints; the arithmetic is the same either way).
Parameters are dicts with the reference's keys (:func:`mamba_params`).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import _fold, _unfold
from repro_torch.models.common import (Params, _Remat, dense_init, einsum,
                                       mm)
from repro_torch.tree import flatten

CONV_K = 4
DT_RANK_DIV = 16


def mamba_params(d_model: int, d_inner: int, state: int,
                 dtype=torch.float32, *, device,
                 generator: Optional[torch.Generator] = None) -> Params:
    """The reference's leaves: ``in_proj`` [d, 2 Ci], ``conv_w`` [4, Ci]
    (0.1 x normal), ``conv_b``, ``x_proj`` [Ci, dt_rank + 2 N],
    ``dt_proj`` [dt_rank, Ci], ``dt_bias`` (-4.6, softplus^-1(0.01)),
    ``A_log`` [Ci, N] = log(1..N), ``D`` (ones), ``out_proj`` [Ci, d]."""
    kw = dict(device=device, generator=generator)
    dt_rank = max(1, d_model // DT_RANK_DIV)
    conv_w = torch.empty((CONV_K, d_inner), dtype=torch.float32,
                         device=device)
    conv_w.normal_(generator=generator)
    a = torch.arange(1, state + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(d_model, 2 * d_inner, dtype, **kw),
        "conv_w": (0.1 * conv_w).to(dtype),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "x_proj": dense_init(d_inner, dt_rank + 2 * state, dtype, **kw),
        "dt_proj": dense_init(dt_rank, d_inner, dtype, **kw),
        "dt_bias": torch.full((d_inner,), -4.6, dtype=dtype, device=device),
        "A_log": torch.log(a).expand(d_inner, state).to(dtype).clone(),
        "D": torch.ones((d_inner,), dtype=dtype, device=device),
        "out_proj": dense_init(d_inner, d_model, dtype, **kw),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  u [B,S,C]; w [K,C]; conv_state [B,K-1,C]
    (None: zeros).  Returns (silu(conv + b), the last K-1 inputs
    [B,K-1,C] in fp32: the next call's conv state)."""
    if conv_state is None:
        pad = torch.zeros_like(u[:, :CONV_K - 1])
    else:
        pad = conv_state.to(u.dtype)
    ext = torch.cat([pad, u], dim=1)
    s = u.shape[1]
    y = 0
    for i in range(CONV_K):
        y = y + ext[:, i:i + s] * w[i]
    return F.silu(y + b), ext[:, -(CONV_K - 1):].float()


def _ssm_params(p, u: torch.Tensor, state: int):
    """(dt [B,S,Ci], B [B,S,N], C [B,S,N], all fp32) from u [B,S,Ci]."""
    dt_rank = p["dt_proj"].shape[0]
    proj = mm(u, p["x_proj"])
    dt = F.softplus(mm(proj[..., :dt_rank], p["dt_proj"])
                    + p["dt_bias"]).float()
    bm = proj[..., dt_rank:dt_rank + state].float()
    cm = proj[..., dt_rank + state:].float()
    return dt, bm, cm


def _fake(t: torch.Tensor) -> bool:
    """A fake tensor (the dry run's trace, launch/dryrun.py): the step
    loops below then allocate their outputs and skip the steps, which
    write in place (the memory is the same, and nothing is computed)."""
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t)


def scan_states(da: torch.Tensor, dbu: torch.Tensor,
                h0: torch.Tensor) -> torch.Tensor:
    """h_t = da_t * h_{t-1} + dbu_t over t, from h0 [B,Ci,N]; da, dbu
    [B,T,Ci,N] fp32 -> every state [B,T,Ci,N]."""
    hs = torch.empty_like(dbu)
    if _fake(dbu):
        return hs               # the steps write in place: no allocation
    h = h0
    for da_t, dbu_t, h_t in zip(da.unbind(1), dbu.unbind(1), hs.unbind(1)):
        h = torch.addcmul(dbu_t, da_t, h, out=h_t)
    return hs


def scan_states_backward(da, hs, h0, g_hs):
    """The reverse recurrence of :func:`scan_states`: with g_t the
    cotangent of h_t (its own, g_hs_t, plus g_{t+1} da_{t+1} from the
    next step), d da_t = g_t h_{t-1} and d dbu_t = g_t.  Returns
    (d da, d dbu, d h0 = g_0 da_0)."""
    g_da = torch.empty_like(da)
    g_dbu = torch.empty_like(da)
    if _fake(da):
        return g_da, g_dbu, g_dbu[:, 0] * da[:, 0]
    das, gs, gds = da.unbind(1), g_dbu.unbind(1), g_da.unbind(1)
    prev = (h0,) + hs.unbind(1)[:-1]
    own = g_hs.unbind(1)
    gs[-1].copy_(own[-1])
    for t in range(len(das) - 1, 0, -1):
        torch.mul(gs[t], prev[t], out=gds[t])
        torch.addcmul(own[t - 1], gs[t], das[t], out=gs[t - 1])
    torch.mul(gs[0], prev[0], out=gds[0])
    return g_da, g_dbu, gs[0] * das[0]


class _ScanBackward(torch.autograd.Function):
    @staticmethod
    def forward(da, hs, h0, g_hs):
        return scan_states_backward(da, hs, h0, g_hs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        outs = _ScanBackward.apply(*_fold(info, in_dims, args))
        return _unfold(info.batch_size, outs), (0, 0, 0)


class _Scan(torch.autograd.Function):
    """:func:`scan_states` with its written-out backward; under vmap the
    learners fold into the batch."""

    @staticmethod
    def forward(da, dbu, h0):
        return scan_states(da, dbu, h0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        da, _, h0 = inputs
        ctx.save_for_backward(da, output, h0)

    @staticmethod
    def backward(ctx, g_hs):
        return _ScanBackward.apply(*ctx.saved_tensors, g_hs.contiguous())

    @staticmethod
    def vmap(info, in_dims, *args):
        (hs,) = _unfold(info.batch_size, (_Scan.apply(*_fold(info, in_dims,
                                                             args)),))
        return hs, 0


def _scan_chunk(carry, lp, _consts, *, state: int):
    """One chunk: carry (h [B,Ci,N] fp32, u_c [B,tc,Ci], A [Ci,N] fp32),
    lp the selective projections -> (h at the chunk's end, y_c [B,tc,Ci]
    fp32)."""
    h, u_c, a = carry
    dt, bm, cm = _ssm_params(lp, u_c, state)
    da = torch.exp(dt[..., None] * a)                       # [B,tc,Ci,N]
    dbu = (dt * u_c.float())[..., None] * bm[:, :, None]
    hs = _Scan.apply(da, dbu, h)
    return hs[:, -1], einsum("btcn,btn->btc", hs, cm)


def mamba_apply(p, x: torch.Tensor, *, state: int,
                ssm_state: Optional[torch.Tensor] = None,
                conv_state: Optional[torch.Tensor] = None,
                chunk: int = 256, chunk_remat: bool = True):
    """Full-sequence selective scan, time-chunked.  x [B,S,d] ->
    (out [B,S,d], final state [B,Ci,N] fp32, conv tail [B,K-1,Ci] fp32),
    from ``ssm_state`` / ``conv_state`` (None: zeros).  ``chunk_remat``
    False runs the chunks without their own remat (inside a remat'd
    layer)."""
    b, s, _ = x.shape
    ui = mm(x, p["in_proj"])
    d_inner = ui.shape[-1] // 2
    u, z = ui[..., :d_inner], ui[..., d_inner:]
    u, conv_tail = _causal_conv(u, p["conv_w"], p["conv_b"], conv_state)
    a = -torch.exp(p["A_log"].float())                      # [Ci,N]
    h = ssm_state if ssm_state is not None else torch.zeros(
        (b, d_inner, state), dtype=torch.float32, device=x.device)
    lp = {k: p[k] for k in ("x_proj", "dt_proj", "dt_bias")}

    def body(carry, lp, consts):
        return _scan_chunk(carry, lp, consts, state=state)

    tc = min(chunk, s)
    if s % tc == 0 and s > tc:
        flat, treedef = flatten(lp)
        ys = []
        for i in range(0, s, tc):
            if chunk_remat:
                h, y_c = _Remat.apply(body, treedef, 3, 0, h,
                                      u[:, i:i + tc], a, *flat)
            else:
                h, y_c = body((h, u[:, i:i + tc], a), lp, ())
            ys.append(y_c)
        y = torch.cat(ys, 1)
    else:
        h, y = body((h, u, a), lp, ())
    y = y.to(x.dtype)
    y = y + u * p["D"].to(u.dtype)
    y = y * F.silu(z)
    return mm(y, p["out_proj"]), h, conv_tail


def mamba_decode(p, x: torch.Tensor, states: Dict[str, torch.Tensor], *,
                 state: int):
    """One token.  x [B,1,d]; states {ssm [B,Ci,N], conv [B,K-1,Ci]} ->
    (out [B,1,d], the new states)."""
    ui = mm(x, p["in_proj"])
    d_inner = ui.shape[-1] // 2
    u, z = ui[..., :d_inner], ui[..., d_inner:]
    u, conv_tail = _causal_conv(u, p["conv_w"], p["conv_b"], states["conv"])
    dt, bm, cm = _ssm_params(p, u, state)
    a = -torch.exp(p["A_log"].float())
    da = torch.exp(dt[:, 0, :, None] * a)                   # [B,Ci,N]
    dbu = (dt[:, 0] * u[:, 0].float())[..., None] * bm[:, 0, None]
    h = da * states["ssm"] + dbu
    y = torch.einsum("bcn,bn->bc", h, cm[:, 0])[:, None].to(x.dtype)
    y = y + u * p["D"].to(u.dtype)
    y = y * F.silu(z)
    return mm(y, p["out_proj"]), {"ssm": h, "conv": conv_tail}


def init_mamba_state(batch: int, d_inner: int, state: int, *,
                     device) -> Dict[str, torch.Tensor]:
    """Zero states: ssm [B,Ci,N] and conv [B,K-1,Ci], fp32."""
    return {"ssm": torch.zeros((batch, d_inner, state), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, CONV_K - 1, d_inner),
                                dtype=torch.float32, device=device)}
