"""Roofline terms and the collectives of a round (PyTorch port of
``repro/launch/hlo_analysis.py``).

The port has no HLO: nothing is lowered or compiled, so there is no
per-device program text to parse.  The reference reads its collectives
from ``compiled.as_text()``; the port derives them from what its round
runs (:func:`round_collectives`): the plan, each level's bucket layout
(``comm/bucket.py`` ``layout_for``) and the mesh of ranks.  Those are the
calls ``parallel/collectives.py`` makes and counts.  Everything else is
the reference's, with the per-device constants of an NVIDIA H100
(``launch/analytic.py``) in place of the TPU's:

  compute    = flops_per_device / peak_flops_chip
  memory     = bytes_per_device / hbm_bw_chip
  collective = sum over collective ops of ring-model link-bytes / link_bw

Ring model per op (n = replica-group size, V = per-device payload bytes,
payload = the op's per-device RESULT shape):
  all-reduce        2 V (n-1)/n
  all-gather        V (n-1)/n   (result holds all n shards; (n-1)/n received)
  reduce-scatter    V (n-1)     (result is one shard; n-1 shard exchanges)
  all-to-all        V (n-1)/n
  collective-permute V

A round of the port has no tensor-parallel activation collectives and no
FSDP compute gathers (``model`` stays 1, and the ranks of one learner
compute its step on its whole parameters): those kinds of the reference's
HLO have no counterpart here, and :func:`round_collectives` lists only
the reductions' calls.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.launch.analytic import HBM_BW, LINK_BW, PEAK_FLOPS

# parallel/collectives.py's kind names -> the reference's HLO op names
_KIND = {"all_reduce": "all-reduce", "reduce_scatter": "reduce-scatter",
         "all_gather": "all-gather"}


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    payload_bytes: int       # per-device operand/result bytes
    group_size: int
    link_bytes: float        # ring-model bytes crossing links per device

    def as_dict(self):
        return dataclasses.asdict(self)


def _ring_factor(kind: str, n: int) -> float:
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    if kind == "all-gather":
        # payload = per-device gathered result (all n shards): recv (n-1)/n
        return float(n - 1) / n
    if kind == "reduce-scatter":
        # payload = per-device scattered result shard: send/recv (n-1) shards
        return float(n - 1)
    if kind == "all-to-all":
        return float(n - 1) / n
    return 1.0  # collective-permute


def _op(kind: str, payload: int, n: int) -> CollectiveOp:
    kind = _KIND.get(kind, kind)
    return CollectiveOp(kind, int(payload), int(n),
                        payload * _ring_factor(kind, n))


def round_collectives(plan, params, mesh, *, steps: Optional[int] = None
                      ) -> List[CollectiveOp]:
    """The collectives one round of ``plan`` calls on this rank of
    ``mesh`` (a ``RankMesh``; bound or not, its rank's block is what
    ``params`` holds: leaves ``[pods, G, S, ...]`` of one rank, meta
    tensors will do).  ``plan`` is the resolved plan the round is built
    with (``resolve_plan(..., shards=)``); ``steps`` the round's SGD steps
    (its last level's period by default).

    Per fire of a level whose learner axes are spread over ranks, one
    message per leaf (per-leaf reducers) or per bucket: a packed bucket
    of a shard-aware layout runs one reduce-scatter and one all-gather
    per spread axis, the others one all-reduce over the level's group;
    16-bit leaves are summed in fp32.  Each sharded bucket of a
    shard-aware layout is regathered over its fsdp group after every fire
    of its level.  Payloads are the per-rank result bytes."""
    from repro_torch.core.plan import LEVEL_AXES
    from repro_torch.core.topology import LEARNER_AXES
    from repro_torch.launch.mesh import level_replica_groups
    from repro_torch.tree import leaves

    steps = steps or plan.levels[-1].period
    flat = leaves(params)
    block = tuple(flat[0].shape[:3]) if flat else (1, 1, 1)
    ops: List[CollectiveOp] = []
    for lvl in plan.levels:
        fires = steps // lvl.period
        axes = LEVEL_AXES[lvl.name]
        spread = [(a, mesh.spread(LEARNER_AXES[a])) for a in sorted(axes)
                  if mesh.spread(LEARNER_AXES[a]) > 1]
        group = len(level_replica_groups(mesh, lvl.name)[0])
        keep = tuple(1 if i in axes else n for i, n in enumerate(block))
        red = lvl.reducer
        lay = red.layout_for(params) if hasattr(red, "layout_for") else None
        if lay is None:
            msgs = [(tuple(x.shape[3:]), x.dtype, None, 1) for x in flat]
        else:
            specs = lay.bucket_shardings() or [None] * lay.n_buckets
            # a rank's wire view: a sharded bucket [F, run] holds its
            # local shards' rows
            msgs = [((lay.local_shards,) + b.shape[1:] if b.shards > 1
                     else b.shape, t.dtype, s, b.shards)
                    for t, s, b in zip(lay.bucket_structs(), specs,
                                       lay.buckets)]
        fire: List[CollectiveOp] = []
        for shape, dtype, spec, shards in msgs:
            esize = 4 if dtype.itemsize < 4 else dtype.itemsize
            numel = math.prod(keep) * math.prod(shape)
            tile = math.prod(n for _, n in spread)
            if spread and spec is not None and shape[-1] % tile == 0:
                # reduce-scatter per axis, minor first; all-gather back,
                # major first
                part = numel
                for _, n in reversed(spread):
                    part //= n
                    fire.append(_op("reduce_scatter", part * esize, n))
                for _, n in spread:
                    part *= n
                    fire.append(_op("all_gather", part * esize, n))
            elif spread:
                fire.append(_op("all_reduce", numel * esize, group))
            if shards > 1 and mesh.bound and lay.local_shards == 1:
                whole = math.prod(block) * shape[-1] * shards
                fire.append(_op("all_gather", whole * dtype.itemsize,
                                shards))
        ops.extend(fire * fires)
    return ops


def collective_counts(ops: List[CollectiveOp]) -> Dict[str, int]:
    """Per-kind counts under ``parallel/collectives.py``'s names (what
    ``collectives.counts()`` reads after the same round)."""
    back = {v: k for k, v in _KIND.items()}
    out = {k: 0 for k in _KIND}
    for o in ops:
        out[back[o.kind]] += 1
    return out


def collective_summary(ops: List[CollectiveOp]) -> Dict:
    by_kind: Dict[str, Dict] = {}
    for o in ops:
        d = by_kind.setdefault(o.kind, {"count": 0, "payload_bytes": 0,
                                        "link_bytes": 0.0})
        d["count"] += 1
        d["payload_bytes"] += o.payload_bytes
        d["link_bytes"] += o.link_bytes
    return by_kind


def roofline_terms(cost: Dict, ops: List[CollectiveOp], *,
                   model_flops_per_device: Optional[float] = None,
                   steps: int = 1) -> Dict:
    """Three roofline terms in seconds (per executed program / steps)."""
    flops = float(cost.get("flops", 0.0))
    # 'bytes accessed' aggregates operand+output HBM traffic
    bytes_ = float(cost.get("bytes accessed", 0.0))
    link_bytes = sum(o.link_bytes for o in ops)
    compute_s = flops / PEAK_FLOPS / steps
    memory_s = bytes_ / HBM_BW / steps
    collective_s = link_bytes / LINK_BW / steps
    dom = max((("compute", compute_s), ("memory", memory_s),
               ("collective", collective_s)), key=lambda kv: kv[1])[0]
    out = {
        "flops_per_device": flops,
        "bytes_per_device": bytes_,
        "collective_link_bytes": link_bytes,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "bottleneck": dom,
        "steps": steps,
    }
    if model_flops_per_device:
        out["model_flops_per_device"] = model_flops_per_device / steps
        out["useful_flops_ratio"] = (model_flops_per_device / flops
                                     if flops else 0.0)
    return out
