"""Plain ResNet-18 in the CIFAR form (He et al., arXiv:1512.03385), one
learner at a time, in plain PyTorch and NCHW.

The network the benchmark holds the system to:

  stem     3x3 conv, width w, GroupNorm, ReLU
  stages   widths w, 2w, 4w, 8w, two basic blocks each; the first block
           of stages 2-4 has stride 2
  block    relu(GN(conv3x3(relu(GN(conv3x3(x, stride)))))) + shortcut),
           the shortcut a 1x1 conv of the same stride where the width
           changes, else x
  head     global mean over the image, then a product with [8w, classes]

Two departures from the paper's CIFAR network, both the system's own
definition of the model: GroupNorm (8 groups, or the largest count below
that divides the channels; population variance in fp32, eps 1e-5, a
scale and a bias per channel) stands where the paper has BatchNorm, so
that a learner's step does not depend on another's batch; and every
convolution pads as "SAME" does (out = ceil(in / stride); the odd pad
goes below and right), which at stride 2 on an even image is (0, 1).
The head has no bias.  No convolution has a bias.

Weights arrive as a dict of named leaves in HWIO layout for convolutions
and [in, out] for the head (the benchmark's raw inputs); they are
permuted here.  Nothing here imports the system under test.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

GN_GROUPS = 8
GN_EPS = 1e-5


def param_specs(cfg: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(path, shape) of every leaf, in the order the benchmark makes and
    lists them: dict keys sorted at every level, list entries in order."""
    w, cin = cfg["width"], cfg["channels"]
    blocks = []
    c = w
    for stage, n in enumerate(cfg["depth_blocks"]):
        cout = w * 2 ** stage
        for _ in range(n):
            blocks.append((c, cout))
            c = cout
    out: List[Tuple[str, Tuple[int, ...]]] = []
    for i, (a, b) in enumerate(blocks):
        leaf = {"conv1": (3, 3, a, b), "conv2": (3, 3, b, b),
                "gn1/bias": (b,), "gn1/scale": (b,),
                "gn2/bias": (b,), "gn2/scale": (b,)}
        if a != b:
            leaf["proj"] = (1, 1, a, b)
        out += [(f"blocks/{i}/{k}", s) for k, s in sorted(leaf.items())]
    out += [("gn0/bias", (w,)), ("gn0/scale", (w,)),
            ("head", (c, cfg["n_classes"])), ("stem", (3, 3, cin, w))]
    return out


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w_hwio: torch.Tensor, stride: int) -> torch.Tensor:
    """x [N, C, H, W], w [kh, kw, Cin, Cout] -> [N, Cout, H', W']."""
    w = w_hwio.permute(3, 2, 0, 1)
    h0, h1 = _same_pad(x.shape[2], w.shape[2], stride)
    v0, v1 = _same_pad(x.shape[3], w.shape[3], stride)
    return F.conv2d(F.pad(x, (v0, v1, h0, h1)), w, stride=stride)


def group_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    n, c, h, w = x.shape
    g = min(GN_GROUPS, c)
    while c % g:
        g -= 1
    xg = x.float().reshape(n, g, c // g, h, w)
    mu = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = ((xg - mu) ** 2).mean(dim=(2, 3, 4), keepdim=True)
    y = ((xg - mu) / torch.sqrt(var + GN_EPS)).reshape(n, c, h, w)
    return y * scale[None, :, None, None] + bias[None, :, None, None]


def logits(p: Dict[str, torch.Tensor], x_nhwc: torch.Tensor,
           cfg: Dict) -> torch.Tensor:
    """One learner's forward: images [N, H, W, C] -> [N, classes]."""
    x = x_nhwc.permute(0, 3, 1, 2)
    h = F.relu(group_norm(conv(x, p["stem"], 1), p["gn0/scale"],
                          p["gn0/bias"]))
    i = 0
    for stage, n in enumerate(cfg["depth_blocks"]):
        for b in range(n):
            stride = 2 if b == 0 and stage > 0 else 1
            q = f"blocks/{i}/"
            y = F.relu(group_norm(conv(h, p[q + "conv1"], stride),
                                  p[q + "gn1/scale"], p[q + "gn1/bias"]))
            y = group_norm(conv(y, p[q + "conv2"], 1), p[q + "gn2/scale"],
                           p[q + "gn2/bias"])
            sc = h if q + "proj" not in p else conv(h, p[q + "proj"], stride)
            h = F.relu(y + sc)
            i += 1
    return h.mean(dim=(2, 3)) @ p["head"]


def loss(p: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
         cfg: Dict) -> torch.Tensor:
    """Mean softmax cross-entropy of one learner's batch."""
    z = logits(p, batch["x"], cfg).float()
    return F.cross_entropy(z, batch["y"].long())


def learner_grads(params: Dict[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor], cfg: Dict):
    """Each learner's loss and gradient, one learner after another.

    ``params`` leaves are [L, *shape], ``batch`` leaves [L, B, ...].
    Returns ({path: [L, *shape]}, losses [L])."""
    names = list(params)
    n = params[names[0]].shape[0]
    grads = {k: torch.empty_like(v) for k, v in params.items()}
    losses = []
    for i in range(n):
        p = {k: params[k][i].detach().requires_grad_(True) for k in names}
        val = loss(p, {k: v[i] for k, v in batch.items()}, cfg)
        for k, g in zip(names, torch.autograd.grad(val, [p[k] for k in
                                                         names])):
            grads[k][i] = g
        losses.append(val.detach())
    return grads, torch.stack(losses)
