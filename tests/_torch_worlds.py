"""Rank programs of the gloo worlds that tests/test_torch_distributed.py
spawns.  Every rank imports this module, so it imports the port and
numpy, never JAX.  Each world runs every case once and writes what the
tests read: rank 0 the whole grid's results (``<world>.npz``), every
rank its own checks, collective counts and telemetry values
(``<world>-<rank>.json``).

The worlds (the learner grid is (1, 2, 2) in all three):
  a — mesh (1, 2, 2, 1, 1): every learner on a rank of its own;
  b — mesh (1, 2, 2, 2, 1): 4 learners x fsdp 2, the shard-aware buckets;
  c — mesh (1, 2, 1, 1, 1): each rank a cluster, the local level in-rank.
"""
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch import optim as toptim
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.checkpoint import gather_blocks
from repro_torch.comm import Bucketed, Pipelined, get_reducer, reduce_with
from repro_torch.configs.base import HierAvgParams
from repro_torch.core import hier_avg as th
from repro_torch.core.topology import (HierTopology, average_over,
                                       global_average, local_average)
from repro_torch.data.loader import HierDataLoader, round_batch_shardings
from repro_torch.launch import hlo_analysis as ha
from repro_torch.launch.mesh import level_process_groups
from repro_torch.models import resnet as tres
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import make_constraint_fn, shard_plan
from repro_torch.testing import (AB_SMALL_CAP, build_ab_reduction,
                                 build_sharded_ab_reduction,
                                 count_collective_ops, world_rank_mesh)
from repro_torch.telemetry import gradstats as gs
from repro_torch.tree import leaves

TOPO = (1, 2, 2)
MESHES = {"a": (1, 2, 2, 1, 1), "b": (1, 2, 2, 2, 1), "c": (1, 2, 1, 1, 1)}
# four (16, 8) leaves (fsdp shards dim 0) and one (6,) leaf that no rule
# shards, so a shard-aware layout has sharded and flat buckets
LEAVES = {"w00": (16, 8), "w01": (16, 8), "w02": (16, 8), "w03": (16, 8),
          "b": (6,)}
CAP = 512                  # bytes: one (16, 8) leaf per bucket
SPECS = ("mean", "cast:bfloat16", "qint8:32", "topk:0.25")
ROUND_PLANS = {"a": "local@2/global@4:topk:0.25",
               "b": "local@2:mean:bucketed/pod@4:mean:bucketed/"
                    "global@8:mean:bucketed",
               "c": "local@2/global@4:topk:0.25"}
ROUNDS = 2
B = 4
# the telemetry rounds: a stateful (top-k) global level on every world,
# so world b holds its EF state in shard rows (fsdp 2)
TEL_PLAN = "local@2/global@4:topk:0.25"


def reduction_inputs():
    """Distinct per-learner params ``p`` and EF references ``a``, numpy,
    stacked over the (1, 2, 2) grid."""
    rs = np.random.RandomState(5)
    draw = lambda: {k: rs.standard_normal(TOPO + s).astype(np.float32)  # noqa
                    for k, s in LEAVES.items()}
    return draw(), draw()


def masks(n_levels: int):
    """A seeded participation mask per level, every group keeping one."""
    rs = np.random.RandomState(9)
    m = rs.rand(n_levels, *TOPO) > 0.4
    m[:, :, :, 0] = True
    return m


def _t(tree):
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in tree.items()}


def _np(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def _avg(level, mesh):
    fn = {"local": local_average, "global": global_average}[level]
    return lambda t, cf=None, sp=None: fn(t, cf, sp, mesh=mesh)


def _reductions(world, mesh, topo, out, checks, ckpt_dir):
    """Each reducer of SPECS, bucketed (shard-aware on an fsdp mesh), on
    the rank's block: the averaged tree and the EF state, gathered."""
    p_np, a_np = reduction_inputs()
    p = {k: mesh.take_block(v) for k, v in _t(p_np).items()}
    a = {k: mesh.take_block(v) for k, v in _t(a_np).items()}
    sp = shard_plan(mesh)
    cf = make_constraint_fn(mesh)
    for spec in SPECS:
        tag = spec.split(":")[0]
        for engine in (Bucketed, Pipelined):
            red = engine(get_reducer(spec), CAP, shards=sp)
            st = red.init_state(a)
            collectives.reset_counts()
            got, st1 = reduce_with(red, _avg("global", mesh), p, st,
                                   cf)
            counts = collectives.counts()
            name = f"{tag}_{engine.name}"
            checks[f"counts_{name}"] = counts
            checks[f"n_buckets_{name}"] = red.layout_for(p).n_buckets
            checks[f"n_sharded_{name}"] = sum(
                b.shards > 1 for b in red.layout_for(p).buckets)
            g = gather_blocks(got, mesh, HierTopology(*TOPO))
            for k, v in g.items():
                out[f"{name}/out/{k}"] = _np(v)
            if red.stateful:
                rows = red.state_rows(st1, p)
                ef = gather_blocks(st1._replace(key=None), mesh,
                                   HierTopology(*TOPO),
                                   rows._replace(key=None))
                for i, (r, e) in enumerate(zip(ef.ref, ef.err)):
                    out[f"{name}/ref/{i}"] = _np(r)
                    out[f"{name}/err/{i}"] = _np(e)
            if tag == "topk" and engine is Bucketed:
                # shard-space EF through a checkpoint of the rank grid
                path = os.path.join(ckpt_dir, f"ef-{world}")
                rows = red.state_rows(st1, p)
                # the EF mass across ranks, each shard row once; controls:
                # the rank's block alone, and every row summed over fsdp
                checks["ef_mass_mesh"] = float(gs.ef_mass(st1, mesh, rows))
                checks["ef_mass_block"] = float(gs.ef_mass(st1))
                checks["ef_mass_all_rows"] = float(gs.ef_mass(
                    st1, mesh, rows._replace(err=[True] * len(st1.err))))
                save_checkpoint(path, st1, mesh=mesh, topo=topo, rows=rows)
                back = restore_checkpoint(path, st, mesh=mesh, topo=topo,
                                          rows=rows)
                checks["ef_ckpt_bit_identical"] = all(
                    torch.equal(x, y) for x, y in
                    zip(leaves(back), leaves(st1)))
                checks["ef_ckpt_path"] = path
            if tag == "qint8" and engine is Bucketed:
                lay = red.layout_for(p)
                codec = lay.codec_view(lay.pack(p))
                wire, _ = red.inner.compress(codec, st)
                wire = [w.reshape(tuple(c.shape[:3]) + tuple(w.shape[1:]))
                        for w, c in zip(wire, codec)]
                rows = [b.shards > 1 for b in lay.buckets]
                for i, w in enumerate(gather_blocks(wire, mesh,
                                                    HierTopology(*TOPO),
                                                    rows)):
                    out[f"qint8_wire/{i}"] = w.numpy()
            if tag == "mean" and engine is Bucketed:
                # the same reduction through the masked path, all present
                full = torch.ones(TOPO, dtype=torch.bool)
                got_m, _ = reduce_with(
                    red, lambda t, c=None, s=None: average_over(
                        t, (0, 1, 2), c, s, full, mesh), p, st, cf)
                checks["mask_all_true_bit_identical"] = all(
                    torch.equal(x, y) for x, y in
                    zip(leaves(got), leaves(got_m)))
                if sp is not None:
                    # the buckets' mean by one all-reduce instead of
                    # reduce-scatter + all-gather
                    lay = red.layout_for(p)
                    wire = lay.pack(p)
                    rsag = average_over(wire, (0, 1, 2), cf,
                                        lay.bucket_shardings(), mesh=mesh)
                    ar = average_over(wire, (0, 1, 2), cf, mesh=mesh)
                    checks["rsag_vs_allreduce_max"] = max(
                        float((x - y).abs().max()) for x, y in zip(rsag, ar))
                    checks["rsag_equals_allreduce"] = all(
                        torch.equal(x, y) for x, y in zip(rsag, ar))


def _round(world, mesh, topo, p_np, batches, out, checks, ckpt_dir):
    """ROUNDS rounds of ROUND_PLANS[world] on the rank's block from the
    numpy init; the state gathered after each round."""
    sp = shard_plan(mesh)
    cf = make_constraint_fn(mesh)
    h = HierAvgParams(plan=ROUND_PLANS[world])
    opt = toptim.sgd(0.1, momentum=0.9)
    block = mesh.block_topology(topo)

    def init(_):
        return convert.tree_from_numpy(p_np, device="cpu")

    plan = th.resolve_plan(h, None, None, shards=sp)
    checks["level_group_sizes"] = {
        name: 1 if g is None else dist.get_world_size(g)
        for name, g in level_process_groups(mesh, plan).items()}
    state = th.init_state(block, init, opt, None, plan=plan, shards=sp,
                          device="cpu")
    rnd = th.make_hier_round(tres.mlp_cls_loss, opt, h, mesh=mesh,
                             constraint_fn=cf, shards=sp)
    eround = th.make_hier_round(tres.mlp_cls_loss, opt, h, mesh=mesh,
                                constraint_fn=cf, shards=sp, elastic=True)
    nd = len(h.batch_dims)
    rows = th.state_rows(state, plan)
    # the collectives a round calls, derived from the plan, its bucket
    # layouts and the mesh (the dry run's count)
    checks["derived_round_counts"] = ha.collective_counts(
        ha.round_collectives(plan, state.params, mesh,
                             steps=h.steps_per_round))
    dense = state
    for r, b in enumerate(batches):
        tb = {k: mesh.take_block(torch.from_numpy(v), dim=nd)
              for k, v in b.items()}
        collectives.reset_counts()
        state, m = rnd(state, tb)
        checks[f"round_counts_{r}"] = collectives.counts()
        out[f"round{r}/loss"] = np.asarray(
            float(collectives.world_mean(m["loss"].reshape(1))))
        whole = gather_blocks(state, mesh, topo, rows)
        for i, x in enumerate(leaves(whole.params)):
            out[f"round{r}/params/{i}"] = _np(x)
        for i, x in enumerate(leaves(whole.opt_state)):
            out[f"round{r}/opt/{i}"] = _np(x)
        for name, cs in (whole.comm_state or {}).items():
            for i, (a, e) in enumerate(zip(leaves(cs.ref), leaves(cs.err))):
                out[f"round{r}/{name}/ref/{i}"] = _np(a)
                out[f"round{r}/{name}/err/{i}"] = _np(e)
        if r == 0:
            e_state, _ = eround(dense, tb, np.ones((len(plan.levels),)
                                                   + TOPO, bool))
            checks["round_all_true_bit_identical"] = all(
                torch.equal(x, y) for x, y in
                zip(leaves(e_state), leaves(state)) if
                isinstance(x, torch.Tensor))
            m_state, _ = eround(dense, tb, masks(len(plan.levels)))
            whole = gather_blocks(m_state, mesh, topo, rows)
            for i, x in enumerate(leaves(whole.params)):
                out[f"masked/params/{i}"] = _np(x)
    path = os.path.join(ckpt_dir, f"ckpt-{world}")
    save_checkpoint(path, state, step=state.step, mesh=mesh, topo=topo,
                    rows=rows)
    back = restore_checkpoint(path, state, mesh=mesh, topo=topo, rows=rows)
    checks["ckpt_bit_identical"] = all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(leaves(back), leaves(state)))
    checks["ckpt_path"] = path


def _telemetry(world, mesh, topo, p_np, batches, checks):
    """ROUNDS rounds of TEL_PLAN with telemetry on and off from the numpy
    init: every rank's ``telemetry/*`` values per round, whether the two
    trajectories are bit for bit the same, and the telemetry-on round's
    collectives.  Then the divergence of the reduction inputs' distinct
    learners over the whole grid, across ranks and (the control) over the
    rank's block alone."""
    p = {k: mesh.take_block(v) for k, v in _t(reduction_inputs()[0]).items()}
    checks["div_mesh"] = float(gs.group_divergence(p, (0, 1, 2), mesh))
    checks["div_block"] = float(gs.group_divergence(p, (0, 1, 2)))
    sp = shard_plan(mesh)
    cf = make_constraint_fn(mesh)
    h = HierAvgParams(plan=TEL_PLAN)
    opt = toptim.sgd(0.1, momentum=0.9)
    plan = th.resolve_plan(h, None, None, shards=sp)

    def init(_):
        return convert.tree_from_numpy(p_np, device="cpu")

    states = [th.init_state(mesh.block_topology(topo), init, opt, None,
                            plan=plan, shards=sp, device="cpu")
              for _ in range(2)]
    rnds = [th.make_hier_round(tres.mlp_cls_loss, opt, h, mesh=mesh,
                               constraint_fn=cf, shards=sp, telemetry=t)
            for t in (True, None)]
    nd = len(h.batch_dims)
    same = True
    for r, b in enumerate(batches):
        tb = {k: mesh.take_block(torch.from_numpy(v), dim=nd)
              for k, v in b.items()}
        collectives.reset_counts()
        states[0], m = rnds[0](states[0], tb)
        checks[f"tel_counts_{r}"] = collectives.counts()
        states[1], _ = rnds[1](states[1], tb)
        checks[f"tel_{r}"] = {k: float(v) for k, v in m.items()
                              if k.startswith("telemetry/")}
        same = same and all(
            torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
            for x, y in zip(leaves(states[0]), leaves(states[1])))
    checks["tel_traj_bit_identical"] = same


def _probe(mesh, checks):
    """One autotune probe point measured on the ranks: its record."""
    from repro_torch.autotune import ProbePoint, measure_point
    rec = measure_point(ProbePoint("global", TOPO, "topk:0.25", 4, (16, 8)),
                        2, device="cpu", mesh=mesh)
    checks["probe"] = rec


def _ab(mesh, checks):
    """The A/B reduction of repro_torch/testing.py (24 leaves of 96 x 64,
    one bucket each), serial and pipelined: its collectives."""
    for sched in ("serial", "pipelined"):
        if mesh.shape["fsdp"] > 1:
            b = build_sharded_ab_reduction(sched, AB_SMALL_CAP, mesh=mesh)
        else:
            b = build_ab_reduction(sched, AB_SMALL_CAP, mesh=mesh,
                                   topo_shape=TOPO)
        collectives.reset_counts()
        b["fn"](b["params"], b["state"])
        checks[f"ab_{sched}"] = [b["n_buckets"], count_collective_ops()]


def _loader(mesh, topo, checks):
    """The rank's block of a round equals the one-process loader's."""
    h = HierAvgParams(plan="local@2/global@4")

    def sample(gen, n):
        return {"x": torch.randn(n, 3, generator=gen)}

    mine = HierDataLoader(sample, topo=topo, hier=h, per_learner_batch=2,
                          seed=3, mesh=mesh, device="cpu").next_round()
    whole = HierDataLoader(sample, topo=topo, hier=h, per_learner_batch=2,
                           seed=3, device="cpu").next_round()
    by_specs = HierDataLoader(
        sample, topo=topo, hier=h, per_learner_batch=2, seed=3,
        shardings=round_batch_shardings(mesh, h, whole),
        device="cpu").next_round()
    want = mesh.take_block(whole["x"], dim=len(h.batch_dims))
    checks["loader_block_equal"] = (torch.equal(mine["x"], want)
                                    and torch.equal(by_specs["x"], want))


def run(rank, world, name, out_dir, p_np, batches, tel_batches):
    torch.use_deterministic_algorithms(True)
    mesh = world_rank_mesh(MESHES[name], rank)
    topo = HierTopology(*TOPO)
    out, checks = {}, {}
    _reductions(name, mesh, topo, out, checks, out_dir)
    _round(name, mesh, topo, p_np, batches, out, checks, out_dir)
    _telemetry(name, mesh, topo, p_np, tel_batches, checks)
    _loader(mesh, topo, checks)
    _ab(mesh, checks)
    _probe(mesh, checks)
    with open(os.path.join(out_dir, f"{name}-{rank}.json"), "w") as f:
        json.dump(checks, f)
    if rank == 0:
        np.savez(os.path.join(out_dir, f"{name}.npz"), **out)
    collectives.barrier()

