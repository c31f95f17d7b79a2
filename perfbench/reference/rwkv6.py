"""Plain RWKV-6 ("Finch", Peng et al., arXiv:2404.05892) language model,
all learners at once, in plain PyTorch.

Every tensor carries a leading learner axis L: weights [L, ...], tokens
[L, B, S].  A product with per-learner weights is a batched ``matmul``;
nothing else mixes learners.  Per layer (pre-norm residual):

  x  <- x + TimeMix(RMSNorm(x));   x <- x + ChannelMix(RMSNorm(x))

TimeMix, with x' the previous token's x (zero before the first):
  dx = x' - x;  lora = tanh((x + dx mu_x) A_mix)            (5 x 32 wide)
  m_f = mu_f + lora_f B_mix,f;  x_f = x + dx m_f   f in (w, k, v, r, g)
  r, k, v = x_r W_r, x_k W_k, x_v W_v  (H heads of D);  g = silu(x_g W_g)
  w = exp(-exp(decay + tanh(x_w A_dec) B_dec))               per channel
  y_t[i] = sum_j r_t[j] (S_t[j, i] + u[j] k_t[j] v_t[i])
  S_{t+1}[j, i] = w_t[j] S_t[j, i] + k_t[j] v_t[i],  S_0 = 0
  out = (LayerNorm(y) * g) W_o
ChannelMix:  k = relu(x_k W_k)^2;  out = sigmoid(x_r W_r) * (k W_v)

The WKV recurrence runs as written: one ``addcmul`` a step for the state
(every step's state kept), then the outputs of all steps in one product.
Departures from the paper, each the system's own definition of the model:
RMSNorm (fp32, eps 1e-5) as the pre-norms and the final norm, and one
LayerNorm over all heads' outputs where the paper has a GroupNorm per
head.  The loss is the mean token cross-entropy of each learner, in fp32,
over the whole vocabulary.  Nothing here imports the system under test.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

LORA = 32
DECAY_LORA = 64
EPS = 1e-5


def param_specs(cfg: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(path, shape) of every leaf in the benchmark's order: dict keys
    sorted at every level.  Layer leaves are stacked on a leading layer
    axis."""
    d, f, n = cfg["d_model"], cfg["d_ff"], cfg["n_layers"]
    a = cfg["ssm_heads"] * cfg["head_dim"]
    v = -(-cfg["vocab_size"] // 128) * 128
    layer = {
        "cm/mu_k": (d,), "cm/mu_r": (d,), "cm/wk": (d, f), "cm/wr": (d, d),
        "cm/wv": (f, d), "ln1/scale": (d,), "ln2/scale": (d,),
        "tm/decay_A": (d, DECAY_LORA), "tm/decay_B": (DECAY_LORA, a),
        "tm/decay_base": (a,), "tm/ln_out/bias": (a,),
        "tm/ln_out/scale": (a,), "tm/mix_A": (d, 5 * LORA),
        "tm/mix_B": (LORA, 5 * d), "tm/mu": (5, d), "tm/mu_x": (d,),
        "tm/u": (a,), "tm/wg": (d, a), "tm/wk": (d, a), "tm/wo": (a, d),
        "tm/wr": (d, a), "tm/wv": (d, a)}
    return ([("embed", (v, d)), ("final_norm/scale", (d,))]
            + [(f"layers/{k}", (n,) + s) for k, s in sorted(layer.items())]
            + [("lm_head", (d, v))])


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [L, B, S, i] times per-learner w [L, i, o]."""
    return torch.matmul(x, w[:, None])


def _bcast(p: torch.Tensor) -> torch.Tensor:
    """A per-learner vector [L, ...] against [L, B, S, ...]."""
    return p[:, None, None]


def rms_norm(x, scale):
    x32 = x.float()
    return x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + EPS) \
        * _bcast(scale)


def layer_norm(x, scale, bias):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + EPS) * _bcast(scale) + _bcast(bias)


def shift(x):
    return torch.cat([torch.zeros_like(x[:, :, :1]), x[:, :, :-1]], dim=2)


def wkv(r, k, v, w, u):
    """The recurrence over [N, S, H, D] inputs and a per-row bonus u
    [N, H, D], from a zero state; returns y [N, S, H, D]."""
    n, s, h, d = r.shape
    kv = k[..., :, None] * v[..., None, :]              # [N, S, H, D, D]
    # unbind: one gradient stack in the backward, not one per step
    kvs, ws = kv.unbind(1), w[..., None].unbind(1)
    state = torch.zeros((n, h, d, d), dtype=r.dtype, device=r.device)
    states = []
    for t in range(s):
        states.append(state)
        state = torch.addcmul(kvs[t], ws[t], state)
    past = torch.stack(states, dim=1)                   # S_t for every t
    return torch.einsum("nshj,nshji->nshi", r,
                        past + u[:, None, :, :, None] * kv)


def time_mix(p, x, cfg):
    L, B, S, d = x.shape
    H, D = cfg["ssm_heads"], cfg["head_dim"]
    dx = shift(x) - x
    lora = torch.tanh(_mm(x + dx * _bcast(p["mu_x"]), p["mix_A"]))
    lora = lora.reshape(L, B, S, 5, LORA)
    mix_b = p["mix_B"].reshape(L, LORA, 5, d)
    dyn = torch.einsum("lbsfr,lrfd->lbsfd", lora, mix_b)
    mixes = p["mu"][:, None, None] + dyn                # [L, B, S, 5, d]
    xw, xk, xv, xr, xg = (x + dx * mixes[:, :, :, i] for i in range(5))
    r = _mm(xr, p["wr"]).reshape(L * B, S, H, D)
    k = _mm(xk, p["wk"]).reshape(L * B, S, H, D)
    v = _mm(xv, p["wv"]).reshape(L * B, S, H, D)
    g = F.silu(_mm(xg, p["wg"]))
    dec = _bcast(p["decay_base"]) + _mm(torch.tanh(_mm(xw, p["decay_A"])),
                                        p["decay_B"])
    w = torch.exp(-torch.exp(dec)).reshape(L * B, S, H, D)
    u = p["u"].reshape(L, 1, H, D).expand(L, B, H, D).reshape(L * B, H, D)
    y = wkv(r, k, v, w, u).reshape(L, B, S, H * D)
    y = layer_norm(y, p["ln_out/scale"], p["ln_out/bias"])
    return _mm(y * g, p["wo"])


def channel_mix(p, x):
    dx = shift(x) - x
    xk = x + dx * _bcast(p["mu_k"])
    xr = x + dx * _bcast(p["mu_r"])
    k = F.relu(_mm(xk, p["wk"])) ** 2
    return torch.sigmoid(_mm(xr, p["wr"])) * _mm(k, p["wv"])


def learner_losses(params: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor], cfg: Dict) -> torch.Tensor:
    """Each learner's mean token loss [L].  ``params`` leaves [L, ...]
    (layer leaves [L, n_layers, ...]); tokens and labels [L, B, S]."""
    tok = batch["tokens"].long()
    L = tok.shape[0]
    lid = torch.arange(L, device=tok.device)[:, None, None]
    x = params["embed"][lid, tok]                       # [L, B, S, d]
    for i in range(cfg["n_layers"]):
        lp = {k[len("layers/"):]: v[:, i] for k, v in params.items()
              if k.startswith("layers/")}
        x = x + time_mix({k[3:]: v for k, v in lp.items()
                          if k.startswith("tm/")},
                         rms_norm(x, lp["ln1/scale"]), cfg)
        x = x + channel_mix({k[3:]: v for k, v in lp.items()
                             if k.startswith("cm/")},
                            rms_norm(x, lp["ln2/scale"]))
    h = rms_norm(x, params["final_norm/scale"])
    z = _mm(h, params["lm_head"]).float()
    nll = F.cross_entropy(z.reshape(-1, z.shape[-1]),
                          batch["labels"].long().reshape(-1),
                          reduction="none").reshape(L, -1)
    return nll.mean(dim=1)


def learner_grads(params: Dict[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor], cfg: Dict):
    """({path: [L, ...] gradient of each learner's loss}, losses [L])."""
    names = list(params)
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    losses = learner_losses(p, batch, cfg)
    grads = torch.autograd.grad(losses.sum(), [p[k] for k in names])
    return dict(zip(names, grads)), losses.detach()
