"""Numeric evaluators of the paper's bounds and conditions (PyTorch port
of ``repro/core/theory.py``).

The theorem functions and the communication-cost model are plain Python,
copied from the reference.  Parameter templates are meta tensors (shape
and dtype, no storage) where the reference uses ``ShapeDtypeStruct``s, so
every bill is the reference's to the last bit for the same shapes.

:class:`CommModel`'s defaults are the reference's modeled link and codec
rates, kept so that ``cm=None`` bills exactly as the reference does.
They are uncalibrated placeholders, not rates of any device this port
runs on; a calibration artifact (``repro_torch.autotune``: the probe on
the card, then the fit) gives a model that bills the card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.tree import leaves


# --------------------------------------------------------------------- #
# Theorem 3.1 — convergence bound under the w-bar metric
# --------------------------------------------------------------------- #

def thm31_bound(F0_minus_Fstar: float, L: float, M: float, M_G: float,
                gamma: float, K2: int, P: int, B: int, T: int) -> float:
    """(3.2):  2(F0-F*)/(gamma T) + 4 L^2 gamma^2 K2^2 M_G^2 + L gamma M/(PB)."""
    return (2.0 * F0_minus_Fstar / (gamma * T)
            + 4.0 * L ** 2 * gamma ** 2 * K2 ** 2 * M_G ** 2
            + L * gamma * M / (P * B))


def thm31_rate_at_optimum(F0_minus_Fstar: float, L: float, M: float,
                          M_G: float, P: int, B: int, T: int) -> float:
    """(3.4) with gamma=sqrt(PB/T), K2=T^.25/(PB)^.75 — the O(1/sqrt(PBT))
    constant."""
    return (2.0 * F0_minus_Fstar + 4.0 * L ** 2 * M_G ** 2 + L * M) \
        / math.sqrt(P * B * T)


# --------------------------------------------------------------------- #
# Theorem 3.2 — bound under the w-tilde metric (captures K1 and S)
# --------------------------------------------------------------------- #

def third_term_poly(K2: int, K1: int, S: int) -> float:
    """The K1/S-dependent polynomial in (3.6):
    (K2-K1)(4K2+K1-3)/S + (K1-1)(3K2+K1-2)."""
    return ((K2 - K1) * (4 * K2 + K1 - 3) / S
            + (K1 - 1) * (3 * K2 + K1 - 2))


def thm32_bound(F1_minus_Fstar: float, L: float, M: float, gamma: float,
                K1: int, K2: int, S: int, P: int, B: int, N: int,
                delta: float = 0.5) -> float:
    """(3.6) with delta = L^2 gamma^2 (1+delta_{grad,w}) in (0,1)."""
    assert 0.0 < delta < 1.0
    denom = K2 - delta
    return (2.0 * F1_minus_Fstar / (N * denom * gamma)
            + L * gamma * M * K2 ** 2 / (P * B * denom)
            + L ** 2 * gamma ** 2 * M * K2 / (12.0 * B * denom)
            * third_term_poly(K2, K1, S))


def thm32_condition(L: float, gamma: float, K2: int,
                    delta_grad_w: float = 0.0) -> bool:
    """(3.5): 1 - L^2 g^2 (K2(K2-1)/2 - 1 - d) - L g K2 >= 0."""
    return (1.0 - L ** 2 * gamma ** 2
            * (K2 * (K2 - 1) / 2.0 - 1.0 - delta_grad_w)
            - L * gamma * K2) >= 0.0


# --------------------------------------------------------------------- #
# Theorem 3.4 — when is some K2 > 1 faster (fixed data budget T = N*K2)
# --------------------------------------------------------------------- #

def thm34_terms(F1_minus_Fstar: float, L: float, M: float, gamma: float,
                T: int, P: int, B: int) -> Tuple[float, float, float]:
    """alpha, beta, eta of the proof of Thm 3.4."""
    alpha = 2.0 * F1_minus_Fstar / (T * gamma)
    beta = L * gamma * M / (P * B)
    eta = L ** 2 * gamma ** 2 * M / (12.0 * B)
    return alpha, beta, eta


def thm34_condition(F1_minus_Fstar: float, L: float, M: float, gamma: float,
                    T: int, P: int, B: int, S: int,
                    delta: float = 0.5) -> bool:
    """(3.11): delta*alpha/(1-delta) > 2*beta + 12*eta/S  =>  K2*>1."""
    alpha, beta, eta = thm34_terms(F1_minus_Fstar, L, M, gamma, T, P, B)
    return delta * alpha / (1.0 - delta) > 2.0 * beta + 12.0 * eta / S


def thm34_objective(K2: int, K1: int, S: int, alpha: float, beta: float,
                    eta: float, delta: float = 0.5) -> float:
    """B(K2) = f(K2) * g(K2) from the proof (fixed data budget)."""
    K1_eff = min(K1, K2)
    f = alpha + beta * K2 + eta * third_term_poly(K2, K1_eff, S)
    g = K2 / (K2 - delta)
    return f * g


def optimal_k2(K1: int, S: int, alpha: float, beta: float, eta: float,
               delta: float = 0.5, k2_max: int = 512) -> int:
    """Numeric argmin of B(K2) over multiples of K1 (and K2=1)."""
    candidates = [1] + [k for k in range(K1, k2_max + 1, K1)]
    return min(candidates,
               key=lambda k: thm34_objective(k, K1, S, alpha, beta, eta,
                                             delta))


# --------------------------------------------------------------------- #
# Theorem 3.6 — Hier-AVG (K2=(1+a)K, K1=1, S=4) vs K-AVG (K)
# --------------------------------------------------------------------- #

def thm36_hier_bound(K: int, a: float, alpha: float, eta: float,
                     delta: float = 0.5) -> float:
    """H(K) from the proof of Thm 3.6 (second bound term dropped,
    L*gamma*P >> 1 regime).  eta here is L^2 g^2 M / (6B)."""
    Kp = (1.0 + a) * K
    f1 = alpha + eta * ((Kp - 1.0) * (2.0 * Kp - 1.0) / 4.0)
    g1 = Kp / (Kp - delta)
    return f1 * g1


def thm36_kavg_bound(K: int, alpha: float, eta: float,
                     delta: float = 0.5) -> float:
    """chi(K) for K-AVG in the same regime."""
    f2 = alpha + eta * (K - 1.0) * (2.0 * K - 1.0)
    g2 = K / (K - delta)
    return f2 * g2


# --------------------------------------------------------------------- #
# Communication-cost model (the paper's motivation, made quantitative)
# --------------------------------------------------------------------- #

def tier_for(axes, pods: int) -> str:
    """Link tier a reduction scope rides: ``"dci"`` iff it includes the
    pod axis of a multi-pod topology, ``"ici"`` otherwise.  The ONE
    classification rule — ``CommModel.bw_for_level`` bills with it and
    the autotune probe labels its calibration samples with it, so the
    fitted bandwidth columns cannot drift from the billed ones."""
    return "dci" if (0 in tuple(axes) and pods > 1) else "ici"


@dataclass(frozen=True)
class CommModel:
    """Ring all-reduce cost model: reducing V bytes over n participants on a
    fabric of bandwidth bw costs 2V(n-1)/(n*bw) seconds (+ latency per
    step).  Reductions confined to one pod (local / pod plan levels) ride
    the fast fabric (intra-pod ICI); levels whose scope crosses pods
    (global) pay the slow one (inter-pod DCI / the paper's InfiniBand).

    ``compress_bw`` models one learner's compress+reconstruct compute as
    an effective bytes/s over the *uncompressed* bucket — what the
    pipelined schedule overlaps against the wire time (see
    :func:`plan_comm_per_round`).

    ``codec_bw`` refines that single constant per codec family: a tuple
    of ``(codec_name, bytes/s)`` pairs (tuple-of-pairs so the model stays
    hashable/frozen) keyed by ``Reducer.codec_name`` — top-k's
    select+scatter, qint8's fused quantize+pack and PowerSGD's
    einsum+QR chains run at very different rates, and the calibration
    fit (autotune/calibrate.py) can observe each from codec-labeled
    probe points.  ``compress_bw_for`` falls back to the shared
    ``compress_bw`` for codecs without a fitted entry, so an uncalibrated
    model bills exactly as before."""

    # the reference's uncalibrated placeholder rates, kept so that a
    # default model bills as the reference does; no measured device rate
    fast_bw: float = 50.0e9          # intra-pod link
    slow_bw: float = 2.5e9           # cross-pod link
    latency: float = 5.0e-6
    compress_bw: float = 150.0e9     # codec compute, bytes/s uncompressed
    codec_bw: Optional[Tuple[Tuple[str, float], ...]] = None

    def __post_init__(self):
        if self.codec_bw is not None:
            # normalize JSON-loaded lists-of-lists into the hashable
            # tuple-of-pairs form
            object.__setattr__(self, "codec_bw", tuple(
                (str(k), float(v)) for k, v in self.codec_bw))

    def compress_bw_for(self, codec: Optional[str]) -> float:
        """Codec-compute rate for a ``Reducer.codec_name`` label —
        the per-codec calibrated rate when one was fitted, else the
        shared ``compress_bw`` constant."""
        if codec and self.codec_bw:
            for name, bw in self.codec_bw:
                if name == codec:
                    return bw
        return self.compress_bw

    def allreduce_time(self, bytes_: float, n: float, bw: float) -> float:
        """``n`` may be fractional: expected-cost billing under elastic
        membership passes :func:`effective_participants` — the ring
        formula is smooth in n, and n_eff -> 1 correctly drives the bill
        to zero (a one-survivor group reduces with nobody)."""
        if n <= 1:
            return 0.0
        steps = 2.0 * (n - 1)
        return 2.0 * bytes_ * (n - 1) / (n * bw) + steps * self.latency

    def bw_for_level(self, axes, pods: int) -> float:
        """Link tier a plan level rides (see :func:`tier_for`)."""
        return self.slow_bw if tier_for(axes, pods) == "dci" \
            else self.fast_bw


def effective_participants(n: int, drop_prob: float = 0.0) -> float:
    """Expected ring size of a grouped reduction whose members each miss
    the fire independently with probability ``drop_prob``:
    ``n_eff = 1 + (n - 1)(1 - p)``.

    The masked reduction always runs *as if* from one anchor's
    perspective — a group never shrinks below its own survivor — so the
    expected number of OTHER contributors is ``(n-1)(1-p)``, and the
    ring terms of :meth:`CommModel.allreduce_time` scale with exactly
    that count.  ``p=0`` recovers ``n`` (dense billing, bit-identical
    plan scores); ``p=1`` gives 1 (no wire cost at all).  This is how
    ``plan_comm_per_round(..., drop_prob=)`` prices an unreliable tier
    for ``CostAwarePlan``/``--autotune``.
    """
    p = min(1.0, max(0.0, float(drop_prob)))
    return 1.0 + (n - 1) * (1.0 - p)


def comm_per_k2_steps(model_bytes: float, hier_k1: int, hier_k2: int,
                      P: int, S: int, cm: Optional[CommModel] = None
                      ) -> Tuple[float, float]:
    """(local_seconds, global_seconds) spent on reductions per K2-step cycle
    for Hier-AVG; K-AVG(K) is the special case k1=k2=K, S=1."""
    cm = cm or CommModel()
    n_local = hier_k2 // hier_k1 - 1 if hier_k1 < hier_k2 else 0
    # the local reduction right before the global one is subsumed by it
    local = n_local * cm.allreduce_time(model_bytes, S, cm.fast_bw)
    glob = cm.allreduce_time(model_bytes, P, cm.slow_bw)
    return local, glob


@dataclass(frozen=True)
class LevelCost:
    """One ReductionPlan level's communication bill per round."""

    name: str
    participants: int        # learners averaged together at this level
    period: int              # SGD steps between reductions
    payload_bytes: int       # per-learner wire bytes (compressed)
    count_per_round: int     # reductions per round (outer-subsumed removed)
    bandwidth: float         # link tier this level rides (ICI or DCI)
    seconds_per_round: float
    messages: int = 1        # grouped collectives dispatched per reduction
                             # (per-leaf: n_leaves; bucketed: n_buckets)
    wire_bytes: int = 0      # per-DEVICE wire bytes: == payload_bytes on
                             # the replicated path; fsdp-sharded buckets
                             # are billed at payload/F because the
                             # reduce-scatter/all-gather lowering moves
                             # only each device's shard slice (0 means
                             # "same as payload_bytes")
    compute_s: float = 0.0   # codec compute per round (compress+rebuild)
    codec: str = ""          # Reducer.codec_name — which codec_bw entry
                             # priced compute_s ("" = no codec / shared
                             # compress_bw constant)
    overlap_s: float = 0.0   # wall seconds per round incl compute on the
                             # level's actual schedule: pipelined levels
                             # pay max(compute, comm) per bucket stage plus
                             # the fill/drain ramp; serial levels pay the
                             # sum.  Compare against seconds_per_round +
                             # compute_s (the serial wall) for the win.
    drop_prob: float = 0.0   # per-member miss probability this level was
                             # billed under (elastic expected-cost mode)
    n_eff: float = 0.0       # effective_participants(participants,
                             # drop_prob) the ring terms used (0 means
                             # dense billing: n_eff == participants)

    @property
    def overlap_speedup(self) -> float:
        """Serial wall / scheduled wall — 1.0 when nothing overlaps."""
        serial = self.seconds_per_round + self.compute_s
        return serial / self.overlap_s if self.overlap_s > 0 else 1.0


def scheduled_wall(stage_compute: float, stage_comm: float, messages: int,
                   overlaps: bool) -> float:
    """Wall seconds of one reduction's bucket schedule.

    Serial: every stage pays compute then comm — the sum.  Pipelined
    (``overlaps`` and more than one stage): stage *i*'s collective runs
    concurrently with stage *i+1*'s compute, so the steady state costs
    ``max(compute, comm)`` per stage and the pipeline fill/drain ramp
    adds one stage of each.  The single formula both
    :func:`plan_comm_per_round` and ``launch/analytic.py`` bill from.
    """
    if overlaps and messages > 1:
        return (stage_compute + stage_comm
                + (messages - 1) * max(stage_compute, stage_comm))
    return messages * (stage_compute + stage_comm)


def level_reduction_seconds(lvl, topo, template,
                            cm: Optional[CommModel] = None, *,
                            drop_prob: float = 0.0
                            ) -> Tuple[float, float, float]:
    """The bill of ONE reduction at plan level ``lvl`` on ``topo``:
    ``(comm_s, compute_s, scheduled_wall_s)`` — schedule-count
    independent, so controllers (autotune/controller.py) can compare
    levels without dividing a round bill back by ``counts_per_round``
    (which is zero for a level subsumed by its outer neighbour).

    ``comm_s`` is the wire time (fused-message ring + per-message ring
    startups), ``compute_s`` the codec compute over the dense bytes, and
    ``scheduled_wall_s`` what the level's actual schedule pays
    (:func:`scheduled_wall`: pipelined levels overlap compute against
    comm per bucket stage).  :func:`plan_comm_per_round` multiplies
    these by the billable count per round.

    ``drop_prob`` — expected-cost billing under elastic membership: the
    ring terms run at ``effective_participants(n, drop_prob)`` instead of
    the dense ``n`` (codec compute is unchanged — survivors still
    compress their full bucket).  ``drop_prob=0`` bills identically to
    before."""
    cm = cm or CommModel()
    n = 1
    for a in lvl.axes:
        n *= topo.shape[a]
    wire = lvl.reducer.wire_payload_bytes(template)
    messages = lvl.reducer.n_messages(template)
    bw = cm.bw_for_level(lvl.axes, topo.pods)
    dense_bytes = int(sum(leaf.numel() * leaf.element_size()
                          for leaf in leaves(template)))
    n_eff = effective_participants(n, drop_prob)
    # the RS+AG decomposition of a sharded bucket walks the same
    # 2(n-1)-step ring as the fused all-reduce, so the ring formula
    # applies verbatim with the per-device wire bytes
    comm_s = cm.allreduce_time(wire, n_eff, bw) \
        + (messages - 1) * 2.0 * (n_eff - 1) * cm.latency
    stage_compute = (dense_bytes / messages
                     / cm.compress_bw_for(getattr(lvl.reducer,
                                                  "codec_name", None))
                     if getattr(lvl.reducer, "has_codec", True) else 0.0)
    compute_s = messages * stage_compute
    wall_s = scheduled_wall(stage_compute, comm_s / messages, messages,
                            getattr(lvl.reducer, "overlaps", False))
    return comm_s, compute_s, wall_s


def param_template(n_params: int, dtype="bfloat16", n_leaves: int = 1):
    """A square-ish single-learner matrix standing in for the model's
    parameters — what ``Reducer.payload_bytes`` needs to size a level's
    compressed wire cost analytically (2-D so low-rank reducers apply).

    ``n_leaves > 1`` splits the budget into that many equal matrices —
    use it when the per-message latency term matters (the single-leaf
    default dispatches one collective on the per-leaf path too, so it
    cannot show bucketing's message-count advantage).

    The leaves are meta tensors: shape and dtype, no storage."""
    per = max(1, n_params // n_leaves)
    side = max(1, int(round(per ** 0.5)))
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    shape = (side, -(-per // side))
    if n_leaves == 1:
        return {"params": torch.empty(shape, dtype=dt, device="meta")}
    return {f"params{i}": torch.empty(shape, dtype=dt, device="meta")
            for i in range(n_leaves)}


def plan_comm_per_round(plan, topo, template,
                        cm: Optional[CommModel] = None, *,
                        drop_prob=0.0) -> Tuple[LevelCost, ...]:
    """Cost every level of a ReductionPlan over its own link tier and its
    own *compressed* payload.

    ``template`` is a single-learner parameter tree (meta tensors
    suffice — see :func:`param_template`); ``topo`` a
    core.topology.HierTopology.  A level reduction coinciding with an
    outer level's is not billed (``plan.counts_per_round`` — the payload-
    aware-schedule convention, matching ``comm_per_k2_steps``'s
    "subsumed" accounting; see its docstring for the caveat that the
    scan-nest program still executes those inner reductions).

    Latency is billed per dispatched collective (``Reducer.n_messages``):
    the per-leaf path pays the ring's startup cost once per leaf, the
    bucketed path (comm/bucket.py) once per bucket — the wire-bytes term
    is message-count independent.  The term only differentiates the two
    paths when ``template`` has a realistic leaf structure (real param
    trees, or ``param_template(..., n_leaves=...)``); the default
    single-leaf template dispatches one message either way, since buckets
    never split a leaf.

    Each level also carries its codec compute (``compute_s``, the
    uncompressed bytes through ``cm.compress_bw``) and its *scheduled*
    wall time ``overlap_s``: pipelined levels (comm/bucket.py Pipelined,
    detected via ``reducer.overlaps``) run bucket stages double-buffered,
    so per reduction they pay one stage of compute (fill), one stage of
    comm (drain), and ``max(compute, comm)`` for every stage in between —
    instead of the serial ``sum`` for every stage.  With one message
    there is nothing to overlap and both forms coincide.

    ``drop_prob`` — expected-cost billing for unreliable fleets: a scalar
    per-member miss probability applied to every level, or a mapping
    ``{level_name: p}`` (levels not named bill dense).  Each level's ring
    terms then run at ``effective_participants(n, p)``; the resulting
    ``LevelCost`` records both ``drop_prob`` and ``n_eff`` so autotune
    reports can show what the score assumed.
    """
    cm = cm or CommModel()
    counts = dict(plan.counts_per_round())
    out = []
    for lvl in plan.levels:
        n = 1
        for a in lvl.axes:
            n *= topo.shape[a]
        p = (drop_prob.get(lvl.name, 0.0) if hasattr(drop_prob, "get")
             else float(drop_prob))
        payload = lvl.reducer.payload_bytes(template)
        wire = lvl.reducer.wire_payload_bytes(template)
        messages = lvl.reducer.n_messages(template)
        bw = cm.bw_for_level(lvl.axes, topo.pods)
        count = counts[lvl.name]
        comm_s, compute_s, wall_s = level_reduction_seconds(
            lvl, topo, template, cm, drop_prob=p)
        out.append(LevelCost(lvl.name, n, lvl.period, payload, count, bw,
                             count * comm_s, messages, wire_bytes=wire,
                             compute_s=count * compute_s,
                             codec=getattr(lvl.reducer, "codec_name", ""),
                             overlap_s=count * wall_s, drop_prob=p,
                             n_eff=effective_participants(n, p)))
    return tuple(out)


def comm_advantage(model_bytes: float, K: int, a: float, P: int, S: int = 4,
                   cm: Optional[CommModel] = None) -> float:
    """Seconds saved per *data-equivalent* K2 window by Hier-AVG with
    K2=(1+a)K, K1=1, S=4 versus K-AVG(K) (Thm 3.6 setup)."""
    cm = cm or CommModel()
    k2 = int(round((1 + a) * K))
    loc, glo = comm_per_k2_steps(model_bytes, 1, k2, P, S, cm)
    hier_per_step = (loc + glo) / k2
    _, glo_k = comm_per_k2_steps(model_bytes, K, K, P, 1, cm)
    kavg_per_step = glo_k / K
    return kavg_per_step - hier_per_step
