"""Compact ResNet + MLP classifiers — the paper's own model family
(PyTorch port of ``repro/models/resnet.py``).

Pure functional on nested dict/list parameter trees with the reference's
layouts: conv weights are HWIO and activations NHWC at every function
here; each conv permutes to PyTorch's NCHW/OIHW inside the call only, so
the per-leaf top-k of the sparse reducer flattens the same elements in the
same order as the reference.  GroupNorm (batch-independent, so right
under the per-learner vmap) uses the population variance in fp32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.resnet18_cifar import CNNConfig, MLPConfig
from repro_torch.models.common import dense_init, softmax_cross_entropy

Params = Dict[str, object]


def _conv_init(generator: Optional[torch.Generator], k: int, cin: int,
               cout: int, dtype=torch.float32, *, device) -> torch.Tensor:
    fan_in = k * k * cin
    w = torch.randn((k, k, cin, cout), generator=generator, device=device)
    return (w * (2.0 / fan_in) ** 0.5).to(dtype)


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding: (low, high); at stride 2 with a 3x3 kernel
    on an even input that is (0, 1), not (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x [N, H, W, Cin] * w [kh, kw, Cin, Cout] -> [N, H', W', Cout]."""
    (ph0, ph1) = _same_pads(x.shape[1], w.shape[0], stride)
    (pw0, pw1) = _same_pads(x.shape[2], w.shape[1], stride)
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1)
    if ph0 == ph1 and pw0 == pw1:
        y = F.conv2d(xc, wc, stride=stride, padding=(ph0, pw0))
    else:
        y = F.conv2d(F.pad(xc, (pw0, pw1, ph0, ph1)), wc, stride=stride)
    return y.permute(0, 2, 3, 1)


def _gn_init(c: int, dtype=torch.float32, *, device) -> Params:
    return {"bias": torch.zeros((c,), dtype=dtype, device=device),
            "scale": torch.ones((c,), dtype=dtype, device=device)}


def _gn(p: Params, x: torch.Tensor, groups: int = 8,
        eps: float = 1e-5) -> torch.Tensor:
    n, h, w, c = x.shape
    g = min(groups, c)
    while c % g:
        g -= 1
    xg = x.reshape(n, h, w, g, c // g).float()
    mu = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = xg.var(dim=(1, 2, 4), keepdim=True, correction=0)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return xg.reshape(n, h, w, c) * p["scale"] + p["bias"]


def _block_init(generator, cin: int, cout: int, dtype=torch.float32, *,
                device) -> Params:
    p = {"conv1": _conv_init(generator, 3, cin, cout, dtype, device=device),
         "conv2": _conv_init(generator, 3, cout, cout, dtype, device=device),
         "gn1": _gn_init(cout, dtype, device=device),
         "gn2": _gn_init(cout, dtype, device=device)}
    if cin != cout:
        p["proj"] = _conv_init(generator, 1, cin, cout, dtype, device=device)
    return p


def _block_apply(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    h = F.relu(_gn(p["gn1"], _conv(x, p["conv1"], stride)))
    h = _gn(p["gn2"], _conv(h, p["conv2"]))
    sc = x if "proj" not in p else _conv(x, p["proj"], stride)
    return F.relu(h + sc)


def resnet_init(generator: Optional[torch.Generator], cfg: CNNConfig,
                dtype=torch.float32, *, device="cuda") -> Params:
    w = cfg.width
    stem = _conv_init(generator, 3, cfg.channels, w, dtype, device=device)
    blocks = []
    cin = w
    for stage, n in enumerate(cfg.depth_blocks):
        cout = w * (2 ** stage)
        for _ in range(n):
            blocks.append(_block_init(generator, cin, cout, dtype,
                                      device=device))
            cin = cout
    head = dense_init(cin, cfg.n_classes, dtype, device=device,
                      generator=generator)
    return {"blocks": blocks, "gn0": _gn_init(w, dtype, device=device),
            "head": head, "stem": stem}


def resnet_apply(p: Params, x: torch.Tensor, cfg: CNNConfig) -> torch.Tensor:
    """x [N, H, W, C] -> logits [N, n_classes]."""
    h = F.relu(_gn(p["gn0"], _conv(x, p["stem"])))
    i = 0
    for stage, n in enumerate(cfg.depth_blocks):
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            h = _block_apply(p["blocks"][i], h, stride)
            i += 1
    h = h.mean(dim=(1, 2))
    return h @ p["head"]


def resnet_loss(p: Params, batch: Dict[str, torch.Tensor], cfg: CNNConfig):
    logits = resnet_apply(p, batch["x"], cfg)
    return softmax_cross_entropy(logits, batch["y"])


# ---------------------------------------------------------------------- #

def mlp_cls_init(generator: Optional[torch.Generator], cfg: MLPConfig,
                 dtype=torch.float32, *, device="cuda") -> Params:
    dims = (cfg.in_dim,) + tuple(cfg.hidden) + (cfg.n_classes,)
    w = [dense_init(a, b, dtype, device=device, generator=generator)
         for a, b in zip(dims[:-1], dims[1:])]
    b = [torch.zeros((d,), dtype=dtype, device=device) for d in dims[1:]]
    return {"b": b, "w": w}


def mlp_cls_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    for i, (w, b) in enumerate(zip(p["w"], p["b"])):
        x = x @ w + b
        if i < len(p["w"]) - 1:
            x = F.relu(x)
    return x


def mlp_cls_loss(p: Params, batch: Dict[str, torch.Tensor]):
    return softmax_cross_entropy(mlp_cls_apply(p, batch["x"]), batch["y"])
