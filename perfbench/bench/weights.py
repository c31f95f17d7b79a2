"""The weights of a run, made on the device from the seed by leaf name.

A configuration's ``init`` list holds rules; each leaf takes the first
whose ``match`` (a regular expression) is found in its path:

  {"match": ..., "init": "normal", "std": s}           N(0, s^2)
  {"match": ..., "init": "normal", "gain": g, "fan_in": [dims]}
        N(0, (g / sqrt(fan_in))^2), fan_in the product of those dims
  {"match": ..., "init": "const", "value": c}          every entry c
  {"match": ..., "init": "linspace", "start": a, "stop": b}
        a to b along the last dim, the same for every leading index

All normal leaves come from one draw of a generator on the device, in
leaf order, then are scaled in place: a few large calls, whatever the
number of leaves.

:func:`residual` makes, the same way, the error-feedback residual that a
top-k level carries into the checked round.
"""
from __future__ import annotations

import math
import re
import statistics
from typing import Dict, List, Sequence, Tuple

import torch

from perfbench.bench.seeds import derive


def rule_for(path: str, rules: Sequence[Dict]) -> Dict:
    for r in rules:
        if re.search(r["match"], path):
            return r
    raise ValueError(f"no init rule matches leaf {path!r}")


def _std(rule: Dict, shape: Tuple[int, ...]) -> float:
    if "std" in rule:
        return float(rule["std"])
    fan = math.prod(shape[d] for d in rule["fan_in"])
    return float(rule.get("gain", 1.0)) / math.sqrt(fan)


def make(specs: List[Tuple[str, Tuple[int, ...]]], rules: Sequence[Dict],
         seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """{path: tensor} in the order of ``specs``."""
    normal = [(p, s) for p, s in specs if rule_for(p, rules)["init"]
              == "normal"]
    total = sum(math.prod(s) for _, s in normal)
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    draw = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for path, shape in normal:
        n = math.prod(shape)
        out[path] = draw[at:at + n].view(shape).mul_(
            _std(rule_for(path, rules), shape))
        at += n
    for path, shape in specs:
        rule = rule_for(path, rules)
        if rule["init"] == "const":
            out[path] = torch.full(shape, float(rule["value"]), dtype=dtype,
                                   device=device)
        elif rule["init"] == "linspace":
            row = torch.linspace(float(rule["start"]), float(rule["stop"]),
                                 shape[-1], device=device, dtype=dtype)
            out[path] = row.expand(shape).contiguous()
        elif rule["init"] != "normal":
            raise ValueError(f"unknown init {rule['init']!r} for {path!r}")
    return {p: out[p] for p, _ in specs}


# the residual's spread, as a share of each leaf's rms in the weights
RESIDUAL_SHARE = 0.1


def residual(w0: Dict[str, torch.Tensor], learners: int, seed: int,
             device) -> Dict[str, torch.Tensor]:
    """{path: [learners, *shape]}: the untransmitted residual each learner
    carries from earlier fires, N(0, s^2) per entry with s =
    ``RESIDUAL_SHARE`` x the leaf's rms in ``w0`` (the median nonzero
    leaf's where the leaf is all zero), from one draw on the device."""
    rms = {p: float(torch.linalg.vector_norm(w.double()))
           / math.sqrt(w.numel()) for p, w in w0.items()}
    med = statistics.median(v for v in rms.values() if v > 0)
    gen = torch.Generator(device=device).manual_seed(derive(seed,
                                                            "residual"))
    draw = torch.randn(learners * sum(w.numel() for w in w0.values()),
                       generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for p, w in w0.items():
        n = learners * w.numel()
        out[p] = draw[at:at + n].view((learners,) + tuple(w.shape)).mul_(
            RESIDUAL_SHARE * (rms[p] or med))
        at += n
    return out
