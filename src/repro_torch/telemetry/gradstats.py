"""Device-side gradient/parameter statistics inside the round (PyTorch
port of ``repro/telemetry/gradstats.py``).

Everything here is a few fp32 tensor reductions on the device, added to
the round behind the opt-in ``telemetry=`` knob on ``make_hier_round`` —
pure OBSERVERS: no statistic writes into params/opt_state/EF, runs an
in-place op on them or draws from a generator, so a telemetry-on round
is bit-identical in losses and params to telemetry-off.  The stats land
as extra scalar keys in the round's metrics dict, each the mean over the
round's fires (or steps):

* ``telemetry/div_pre/<level>`` / ``div_post/<level>`` — mean over the
  level's learners of the squared distance to the level-group mean,
  summed over the parameter tree.  ``div_pre`` is the paper's Theorem
  3.2 pre-average discrepancy (the quantity Local SGD analyses bound —
  Stich 1805.09767); ``div_post`` shows what the reduction left behind
  (0 for an exact mean, > 0 under lossy codecs);
* ``telemetry/grad_norm_var/<level>`` — cross-learner variance of the
  per-learner squared gradient norm within the level's averaging
  groups: the Adaptive Periodic Averaging trigger signal (Jiang &
  Agrawal 2007.06134 — stretch periods when gradients agree, shrink
  when they diverge), plus ``telemetry/grad_sq_norm`` (fleet mean);
* ``telemetry/ef_mass/<level>`` — squared mass of the level's
  error-feedback residual (the untransmitted delta a sparse codec
  carries forward);
* ``telemetry/codec_err/<level>`` — relative squared error of the
  post-reduction params against the exact dense group mean of the
  pre-reduction params: the compression error the level's codec
  actually introduced this fire (~0 for the identity mean).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch

from repro_torch.tree import leaves


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Which device-side statistics the round computes (all on by
    default; each adds a handful of fused reductions per level fire)."""

    divergence: bool = True     # div_pre / div_post per level
    grad_var: bool = True       # grad_norm_var per level + grad_sq_norm
    ef_mass: bool = True        # EF residual mass per stateful level
    codec_err: bool = True      # codec error vs the exact dense mean


TelemetryKnob = Union[None, bool, TelemetryConfig]


def resolve_telemetry(knob: TelemetryKnob) -> Optional[TelemetryConfig]:
    """``None``/``False`` -> off; ``True`` -> all stats; a
    :class:`TelemetryConfig` passes through."""
    if knob is None or knob is False:
        return None
    if knob is True:
        return TelemetryConfig()
    if isinstance(knob, TelemetryConfig):
        return knob
    raise TypeError(
        f"telemetry= wants None/bool/TelemetryConfig, got {knob!r}")


def _per_learner_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the trailing dims of a stacked ``[pods, G, S, *shape]``
    leaf: the ``[pods, G, S]`` per-learner totals."""
    return x.reshape(tuple(x.shape[:3]) + (-1,)).sum(-1)


def _zero(tree) -> torch.Tensor:
    ls = leaves(tree)
    dev = ls[0].device if ls else "cpu"
    return torch.zeros((), dtype=torch.float32, device=dev)


def group_divergence(params: Any, axes: Sequence[int]) -> torch.Tensor:
    """Mean over learners of ||w_j - mean_group(w)||^2, summed over the
    tree — the Thm-3.2 discrepancy at a level whose groups are the
    stacked ``axes``.  fp32 accumulation regardless of param dtype."""
    tot = _zero(params)
    for leaf in leaves(params):
        x = leaf.float()
        d = torch.square(x - x.mean(dim=tuple(axes), keepdim=True))
        tot = tot + _per_learner_sum(d).mean()
    return tot


def codec_error(post: Any, pre: Any, axes: Sequence[int]) -> torch.Tensor:
    """Relative squared error of the reduced params vs the exact dense
    group mean of the pre-reduction params, over the whole tree."""
    num = _zero(post)
    den = _zero(post)
    for p_leaf, q_leaf in zip(leaves(post), leaves(pre)):
        m = q_leaf.float().mean(dim=tuple(axes), keepdim=True)
        num = num + torch.square(p_leaf.float() - m).sum()
        den = den + torch.square(m.expand(p_leaf.shape)).sum()
    return num / (den + 1e-30)


def ef_mass(level_state: Any) -> torch.Tensor:
    """Squared mass of a level's error-feedback residual.  Sparse/qint8
    EF states carry the untransmitted residual in ``.err``; for other
    stateful reducers every float leaf counts (int leaves — RNG carries,
    counters — are skipped)."""
    src = getattr(level_state, "err", level_state)
    fl = [x for x in leaves(src) if torch.is_floating_point(x)]
    tot = _zero(fl)
    for leaf in fl:
        tot = tot + torch.square(leaf.float()).sum()
    return tot


def level_stats(cfg: TelemetryConfig, level: Any, pre_params: Any,
                post_params: Any, comm_state: Any
                ) -> Dict[str, torch.Tensor]:
    """The per-fire statistics of one reduction at ``level`` (a
    ReductionLevel): pre/post divergence, codec error, EF mass."""
    out: Dict[str, torch.Tensor] = {}
    if cfg.divergence:
        out[f"telemetry/div_pre/{level.name}"] = \
            group_divergence(pre_params, level.axes)
        out[f"telemetry/div_post/{level.name}"] = \
            group_divergence(post_params, level.axes)
    if cfg.codec_err:
        out[f"telemetry/codec_err/{level.name}"] = \
            codec_error(post_params, pre_params, level.axes)
    if (cfg.ef_mass and level.reducer.stateful
            and isinstance(comm_state, dict)
            and level.name in comm_state):
        out[f"telemetry/ef_mass/{level.name}"] = \
            ef_mass(comm_state[level.name])
    return out


def make_grad_observer(cfg: Optional[TelemetryConfig],
                       levels: Sequence[Any]
                       ) -> Optional[Callable[[Any], Dict]]:
    """Observer the SGD step calls on the (stacked, fp32-accumulated)
    per-learner gradients: per-level within-group variance of the
    per-learner squared gradient norm — the Jiang & Agrawal period
    trigger — plus the fleet-mean squared norm."""
    if cfg is None or not cfg.grad_var:
        return None

    def observe(grads: Any) -> Dict[str, torch.Tensor]:
        sq = _zero(grads)
        for leaf in leaves(grads):
            sq = sq + _per_learner_sum(torch.square(leaf.float()))
        out = {"telemetry/grad_sq_norm": sq.mean()}
        for lvl in levels:
            m = sq.mean(dim=tuple(lvl.axes), keepdim=True)
            out[f"telemetry/grad_norm_var/{lvl.name}"] = \
                torch.square(sq - m).mean()
        return out

    return observe
