"""The port's collectives: the one module that calls ``torch.distributed``
for the reduction stack.

  * :func:`all_reduce` — a sum over a level's group (a learner mean whose
    axes are spread over ranks, outside the shard-aware bucket path);
  * :func:`scatter_mean` — the reference's ``_scatter_mean``
    (``repro/core/topology.py:94``): one reduce-scatter per active mesh
    axis, minor axis first, the division, then one all-gather per axis,
    major first;
  * :func:`all_gather` — the fsdp regather that rebuilds a learner's full
    bucket from its F shards, and the gathers of checkpoints.

``counts()`` holds how many calls of each kind this process made since
:func:`reset_counts` (the counterpart of the reference's HLO collective
count, ``repro/testing.py:168``), and, while :func:`timed` is on, the
seconds each kind took (the device is synchronized around every call, so
timing costs a synchronize per collective and is off by default).

Several ranks on one card run over gloo, which takes a CUDA tensor only
for the collectives its build implements: :func:`probe_gloo_cuda` finds
which it refuses (on an H100 with torch 2.11 it refused none of these
three, PERF.md), and a refused collective raises where it is called.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Optional, Sequence

import torch

KINDS = ("all_reduce", "reduce_scatter", "all_gather")

_CALLS: Dict[str, int] = {k: 0 for k in KINDS}
_SECONDS: Dict[str, float] = {k: 0.0 for k in KINDS}
_TIMING = [False]


def reset_counts() -> None:
    for k in KINDS:
        _CALLS[k] = 0
        _SECONDS[k] = 0.0


def counts() -> Dict[str, int]:
    """Calls of each kind since :func:`reset_counts`."""
    return dict(_CALLS)


def seconds() -> Dict[str, float]:
    """Seconds of each kind since :func:`reset_counts`, while timed."""
    return dict(_SECONDS)


@contextmanager
def timed():
    """Time every collective inside the block (synchronizing the device
    around each), into :func:`seconds`."""
    _TIMING[0] = True
    try:
        yield
    finally:
        _TIMING[0] = False


def _run(kind: str, fn, out: torch.Tensor, inp: torch.Tensor):
    """``fn(out, inp)`` as one collective of ``kind``: counted, and timed
    when asked."""
    _CALLS[kind] += 1
    timing = _TIMING[0] and inp.is_cuda
    if timing:
        torch.cuda.synchronize(inp.device)
        t0 = time.perf_counter()
    fn(out, inp)
    if timing:
        torch.cuda.synchronize(inp.device)
        _SECONDS[kind] += time.perf_counter() - t0
    return out


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group``, in place; returns ``x``."""
    import torch.distributed as dist
    return _run("all_reduce",
                lambda o, i: dist.all_reduce(i, op=dist.ReduceOp.SUM,
                                             group=group), x, x)


def reduce_scatter(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Sum ``x`` over the ``size`` ranks of ``group`` and keep this
    rank's 1/size block of dim 0."""
    import torch.distributed as dist
    if x.shape[0] % size:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not tile over "
                         f"{size} ranks")
    out = torch.empty((x.shape[0] // size,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return _run("reduce_scatter",
                lambda o, i: dist.reduce_scatter_tensor(
                    o, i, op=dist.ReduceOp.SUM, group=group),
                out, x.contiguous())


def all_gather(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Concatenate ``x`` from the ``size`` ranks of ``group`` along dim
    0, in rank order."""
    import torch.distributed as dist
    out = torch.empty((x.shape[0] * size,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return _run("all_gather",
                lambda o, i: dist.all_gather_into_tensor(o, i, group=group),
                out, x.contiguous())


def _on_lead(fn, x: torch.Tensor, k: int, scatter: bool) -> torch.Tensor:
    """Run ``fn`` over the last dim of ``x`` [L, run]: the run's k tiles
    go to dim 0 ([k, L, run/k]) for a scatter, and come back from it for
    a gather."""
    L, run = x.shape
    if scatter:
        y = x.reshape(L, k, run // k).transpose(0, 1).reshape(k * L,
                                                              run // k)
        return fn(y).reshape(L, run // k)
    y = fn(x)                                       # [k * L, run]
    return y.reshape(k, L, run).transpose(0, 1).reshape(L, k * run)


def scatter_mean(x: torch.Tensor, groups: Sequence, denom: torch.Tensor
                 ) -> torch.Tensor:
    """The grouped mean of ``x`` [L, run] over the ranks of ``groups``
    (``(group, size)`` per active mesh axis, major axis first): one
    reduce-scatter per axis, minor axis first, each keeping 1/size of the
    run; the division by ``denom`` (broadcastable to [L, 1], held on the
    device); then one all-gather per axis, major axis first.  The run must
    tile over the product of the sizes."""
    tile = 1
    for _, n in groups:
        tile *= n
    if x.shape[-1] % tile:
        raise ValueError(f"run {x.shape[-1]} does not tile over {tile} "
                         f"ranks")
    s = x
    for g, n in reversed(list(groups)):
        s = _on_lead(lambda y, g=g, n=n: reduce_scatter(y, g, n), s, n,
                     True)
    s = s / denom
    for g, n in groups:
        s = _on_lead(lambda y, g=g, n=n: all_gather(y, g, n), s, n, False)
    return s


def barrier(group=None) -> None:
    """Wait for every rank of ``group`` (not counted: it moves no data)."""
    import torch.distributed as dist
    dist.barrier(group=group)


def probe_gloo_cuda(device, group=None) -> Sequence[str]:
    """The kinds this gloo build refuses on a tensor on the card: each
    kind runs once, in the order of ``KINDS``, on every rank of
    ``group``.  Counted calls are undone."""
    import torch.distributed as dist
    if str(dist.get_backend(group)) != "gloo":
        raise ValueError("the probe is for gloo groups")
    n = dist.get_world_size(group)
    before = dict(_CALLS)
    refused = []
    x = torch.ones(n * 4, device=device)
    for kind, call in (("all_reduce", lambda: all_reduce(x.clone(), group)),
                       ("reduce_scatter",
                        lambda: reduce_scatter(x, group, n)),
                       ("all_gather", lambda: all_gather(x, group, n))):
        try:
            call()
            torch.cuda.synchronize(device)
        except (RuntimeError, ValueError):
            refused.append(kind)
    _CALLS.update(before)
    return refused


def world_mean(values: torch.Tensor, group: Optional[object] = None
               ) -> torch.Tensor:
    """The mean of ``values`` over the ranks of ``group`` (the world by
    default): how the launcher prints one loss for the whole grid."""
    import torch.distributed as dist
    out = all_reduce(values.clone(), group)
    return out / dist.get_world_size(group)


def world_max(value: float, device, group: Optional[object] = None
              ) -> float:
    """The largest of every rank's ``value`` (one all-gather over
    ``group``, the world by default): the world's wall of a step that
    every rank timed from a barrier."""
    import torch.distributed as dist
    x = torch.tensor([value], dtype=torch.float64, device=device)
    return float(all_gather(x, group, dist.get_world_size(group)).max())
