"""Harness for the reductions on a mesh of ranks (PyTorch port of
``repro/testing.py``).

The reference's builders return one jitted reduction over a forced
host-device mesh; here a reduction runs on every rank of a
``torch.distributed`` world, so the builders take the rank's bound
:class:`~repro_torch.parallel.sharding.RankMesh` and return the rank's
block.  :func:`spawn_world` starts such a world (gloo on the CPU, or
several ranks on one card), and :func:`count_collective_ops` reads the
collectives a rank called (the reference counts them in the compiled
HLO, which torch has no counterpart of).
"""
from __future__ import annotations

import socket
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.comm import Bucketed, Pipelined, get_reducer, reduce_with
from repro_torch.core.topology import (HierTopology, global_average,
                                       local_average, pod_average,
                                       stack_like)
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import (RankMesh, make_constraint_fn,
                                           shard_plan)

LEVEL_AVG_FNS = {
    "local": local_average,
    "pod": pod_average,
    "global": global_average,
}

# the A/B shape: 24 leaves x 96*64 fp32 = 24 KiB each.  32 KiB cap -> 24
# buckets (one leaf each); 4 MiB cap -> 1 bucket
AB_LEAVES = 24
AB_LEAF_SHAPE: Tuple[int, int] = (96, 64)
AB_SMALL_CAP = 32 << 10
AB_LARGE_CAP = 4 << 20
HIER_AXES = ("pod", "group", "local", "fsdp", "model")


def ab_tree(seed: int = 0, n_leaves: int = AB_LEAVES,
            leaf_shape: Tuple[int, ...] = AB_LEAF_SHAPE
            ) -> Dict[str, np.ndarray]:
    """The A/B tree of one learner, from numpy (the reference's builder
    draws it from a JAX key; the parity tests hand both the same
    arrays)."""
    rs = np.random.RandomState(seed)
    return {f"w{i:02d}": rs.standard_normal(leaf_shape).astype(np.float32)
            for i in range(n_leaves)}


def _build(red, mesh: Optional[RankMesh], topo: HierTopology, level: str,
           tree1, device) -> Dict:
    tree1 = {k: torch.as_tensor(v, device=device) for k, v in tree1.items()}
    block = topo if mesh is None else mesh.block_topology(topo)
    params = stack_like(block, tree1)
    state = red.init_state(params)
    avg = LEVEL_AVG_FNS[level]
    cf = None if mesh is None else make_constraint_fn(mesh)

    def reduction(p, s):
        return reduce_with(red, lambda t, c=None, sp=None: avg(
            t, c, sp, mesh=mesh), p, s, cf)

    return {"reducer": red, "tree1": tree1, "params": params,
            "state": state, "fn": reduction,
            "n_buckets": (red.layout_for(params).n_buckets
                          if hasattr(red, "layout_for") else len(tree1))}


def build_ab_reduction(sched: str, cap: int, *, mesh=None,
                       spec: str = "topk:0.05",
                       topo_shape: Tuple[int, int, int] = (1, 2, 4),
                       level: str = "global", tree1=None,
                       device="cpu") -> Dict:
    """One A/B variant: the ``level`` reduction of the A/B tree stacked
    over ``topo_shape`` learners, on the serial (``Bucketed``) or
    pipelined (``Pipelined``) schedule at bucket cap ``cap``, or with
    ``sched="perleaf"`` the raw reducer.  On a bound ``mesh`` the params
    and state are this rank's block and the reduction runs on the mesh.
    Returns the reducer, the one-learner tree, the params, the carried
    state, the reduction ``fn(params, state)`` and the bucket count."""
    if sched == "perleaf":
        red = get_reducer(spec)
    else:
        engine = Pipelined if sched == "pipelined" else Bucketed
        red = engine(get_reducer(spec), cap)
    return _build(red, mesh, HierTopology(*topo_shape), level,
                  ab_tree() if tree1 is None else tree1, device)


def build_sharded_ab_reduction(sched: str, cap: int, *, mesh: RankMesh,
                               spec: str = "topk:0.05",
                               topo_shape: Tuple[int, int, int] = (1, 2, 2),
                               level: str = "global", tree1=None,
                               device="cpu") -> Dict:
    """The fsdp > 1 counterpart of :func:`build_ab_reduction` on a hier
    mesh (learners x fsdp x model=1) with a ``ShardPlan``: the bucket
    engine packs per-shard runs and the grouped means run as
    reduce-scatter + all-gather.  The default shape is 4 learners x 2
    shards.  Rank-2 leaves shard trailing dim 0 over fsdp (the rules'
    fallback).  Returns :func:`build_ab_reduction`'s keys plus ``mesh``
    and ``shards``."""
    sp = shard_plan(mesh)
    if sp is None:
        raise ValueError(f"{mesh} has no fsdp axis above 1")
    engine = Pipelined if sched == "pipelined" else Bucketed
    out = _build(engine(get_reducer(spec), cap, shards=sp), mesh,
                 HierTopology(*topo_shape), level,
                 ab_tree() if tree1 is None else tree1, device)
    out.update(mesh=mesh, shards=sp)
    return out


def count_collective_ops() -> Dict[str, int]:
    """Per-kind collective calls this process made since
    ``collectives.reset_counts()``: a sharded bucket's mean shows one
    reduce-scatter and one all-gather per active mesh axis, its fsdp
    regather one more all-gather, and no all-reduce."""
    return collectives.counts()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def _world_main(rank: int, fn: Callable, world: int, port: int,
                backend: str, args: tuple) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_world(fn: Callable, world: int, *args,
                backend: str = "gloo", timeout: float = 600.0) -> None:
    """Run ``fn(rank, world, *args)`` on ``world`` fresh processes (the
    ``spawn`` start method), joined in one ``torch.distributed`` world
    over ``tcp://127.0.0.1``; raises if any rank fails or the world
    outlasts ``timeout`` seconds.  ``fn`` must be importable by name (a
    module-level function of a module that imports no JAX, since every
    rank imports it)."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(
        _world_main, args=(fn, world, _free_port(), backend, args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"a world of {world} ranks outlasted "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)


def world_rank_mesh(shape, rank: int) -> RankMesh:
    """A hier mesh of ``shape`` (pod, group, local, fsdp, model) bound to
    ``rank``."""
    return RankMesh(shape, HIER_AXES, rank=rank)
