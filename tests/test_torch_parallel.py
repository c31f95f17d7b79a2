"""The port's partition rules, rank mesh, shard-aware bucket layout and
billing against the JAX package's, in one process (no ranks).

Everything here is data movement or exact arithmetic on shapes, so it is
held exactly: replica groups, resolved specs and their drops, each leaf's
shard dim over the model zoo's shapes (from ``jax.eval_shape`` of every
architecture at full width), bucket slot tables and packed bytes, wire
payload bytes and the cost model's floats.  The reference's meshes are
``AbstractMesh(axis_sizes, axis_names)`` (its own tests' helper passes the
older signature first, which jax 0.9 rejects) or a stub carrying
``devices.shape`` and ``axis_names``.
"""
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import comm as jcomm  # noqa: E402
from repro.comm.reducer import serial_reduce as jserial  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.configs.resnet18_cifar import CNNConfig as JCNN  # noqa: E402
from repro.core import theory as jtheory  # noqa: E402
from repro.core.plan import ReductionPlan as JPlan  # noqa: E402
from repro.core.plan import apply_bucketing as japply  # noqa: E402
from repro.core.topology import HierTopology as JTopo  # noqa: E402
from repro.core.topology import global_average as jglobal  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import resnet as jres  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402

from repro_torch import comm as tcomm  # noqa: E402
from repro_torch.configs.base import ParallelLayout  # noqa: E402
from repro_torch.configs.resnet18_cifar import CNNConfig  # noqa: E402
from repro_torch.core import theory as ttheory  # noqa: E402
from repro_torch.core.plan import ReductionPlan as TPlan  # noqa: E402
from repro_torch.core.plan import apply_bucketing as tapply  # noqa: E402
from repro_torch.core.topology import HierTopology  # noqa: E402
from repro_torch.core.topology import global_average  # noqa: E402
from repro_torch.elastic.reshape import (CommStateDropWarning,  # noqa: E402
                                         reshape_state)
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import resnet as tres  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

HIER = ("pod", "group", "local", "fsdp", "model")


def _stub(shape, names):
    return types.SimpleNamespace(devices=np.empty(shape), axis_names=names)


def _spec(s):
    return tuple(s)


# --------------------------------------------------------------------- #
# replica groups and meshes


@pytest.mark.parametrize("axes", [("pod", "group", "local"), ("local",),
                                  ("group", "local"), ("fsdp",),
                                  ("group",), ("pod",)])
def test_replica_groups_match_reference(axes):
    """(1, 2, 2, 2, 1), as tests/test_sharded.py:286 holds it: a global
    reduction keeps fsdp, so each shard averages with its 4 peers."""
    t = tsh.RankMesh((1, 2, 2, 2, 1), HIER)
    j = _stub((1, 2, 2, 2, 1), HIER)
    assert tsh.replica_groups(t, axes) == jsh.replica_groups(j, axes)
    if axes == ("pod", "group", "local"):
        assert tsh.replica_groups(t, axes) == [[0, 2, 4, 6], [1, 3, 5, 7]]


@pytest.mark.parametrize("level", ["local", "pod", "global"])
def test_level_replica_groups_match_reference(level):
    t = tsh.RankMesh((1, 2, 2, 2, 1), HIER)
    j = _stub((1, 2, 2, 2, 1), HIER)
    assert tmesh.level_replica_groups(t, level) \
        == jmesh.level_replica_groups(j, level)


def test_hier_and_production_meshes_match_reference():
    lay = ParallelLayout(groups=4, local=2, fsdp=2, tp=16)
    t = tmesh.make_hier_mesh(lay)
    assert tuple(t.shape.items()) == (("pod", 1), ("group", 4),
                                      ("local", 2), ("fsdp", 2),
                                      ("model", 16))
    assert t.devices.shape == (1, 4, 2, 2, 16) and not t.bound
    for multi in (False, True):
        p = tmesh.make_production_mesh(multi_pod=multi)
        assert p.size == tmesh.device_count_required(multi_pod=multi) \
            == jmesh.device_count_required(multi_pod=multi)


@pytest.mark.parametrize("world,shape", [(8, (1, 2, 2, 2, 1)),
                                         (4, (1, 2, 1, 2, 1)),
                                         (1, (1, 1, 1, 1, 1)),
                                         (4, (1, 2, 2, 1, 1))])
def test_rank_mesh_lays_learners_outermost_first(world, shape):
    fsdp = shape[3]
    m = tmesh.rank_mesh(HierTopology(1, 2, 2), fsdp, world, rank=world - 1)
    assert tuple(m.shape.values()) == shape and m.bound
    block = m.block_topology(HierTopology(1, 2, 2))
    assert block.shape == tuple(n // s for n, s in zip((1, 2, 2), shape[:3]))


def test_rank_mesh_refuses_a_partial_axis_and_tensor_parallelism():
    m = tsh.RankMesh((1, 2, 2, 1, 1), HIER, rank=0)
    with pytest.raises(ValueError, match="all on ranks"):
        m.block_topology(HierTopology(1, 4, 2))
    with pytest.raises(ValueError, match="tensor parallelism"):
        tsh.RankMesh((1, 2, 1, 1, 2), HIER, rank=0)
    with pytest.raises(ValueError, match="does not hold"):
        tmesh.rank_mesh(HierTopology(1, 2, 2), 2, 6, 0)


def test_block_coordinates_and_constraint_check():
    """Rank 6 of (1, 2, 2, 2, 1) is group 1, local 1, shard 0: its block
    of a [1, 2, 2, ...] tensor is that learner; the constraint accepts a
    block leaf and refuses a leaf holding both learners of a spread
    axis."""
    m = tsh.RankMesh((1, 2, 2, 2, 1), HIER, rank=6)
    assert (m.coord("group"), m.coord("local"), m.coord("fsdp")) == (1, 1, 0)
    x = torch.arange(12.).reshape(1, 2, 2, 3)
    assert torch.equal(m.take_block(x), x[:, 1:, 1:])
    cf = tsh.make_constraint_fn(m)
    tree = {"w": torch.zeros(1, 1, 1, 3)}
    assert cf(tree) is tree
    with pytest.raises(ValueError, match="spread over"):
        cf({"w": torch.zeros(1, 2, 1, 3)})
    sp = tsh.shard_plan(m)
    assert sp.local_shards == 1 and sp.shard_index == 0
    whole = tsh.shard_plan(tsh.RankMesh((1, 2, 2, 2, 1), HIER))
    assert whole.local_shards == 2 and whole.shard_index is None
    assert tsh.shard_plan(tsh.RankMesh((1, 2, 2, 1, 1), HIER)) is None


# --------------------------------------------------------------------- #
# partition rules over the model zoo


def _zoo(arch):
    tmpl = jax.eval_shape(jbuild(jget_config(arch)).init,
                          jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(tmpl)[0]
    return [(jsh._path_str(kp), tuple(x.shape)) for kp, x in flat], tmpl


@pytest.mark.parametrize("arch", list_archs())
def test_shard_dims_and_specs_match_reference_over_the_zoo(arch):
    """Each leaf's fsdp shard dim (``ShardPlan.leaf_shard_dim``) and each
    resolved spec with its drops equal the reference's, at full width, on
    the (1, 2, 2, 2, 1) mesh and on a (1, 4, 2, 2, 16) production
    factoring (where TP-16 does not divide hymba's 25 heads)."""
    leaves_, _ = _zoo(arch)
    for sizes in ((1, 2, 2, 2, 1), (1, 4, 2, 2, 16)):
        t = tsh.ShardPlan(mesh=tsh.RankMesh(sizes, HIER))
        j = jsh.ShardPlan(mesh=AbstractMesh(sizes, HIER))
        tr, jr = tsh.PartitionRules(), jsh.PartitionRules()
        for path, shape in leaves_:
            assert t.leaf_shard_dim(path, shape) \
                == j.leaf_shard_dim(path, shape), (path, shape)
            for stacked in (False, True):
                full = (1, 2, 2) + shape if stacked else shape
                ts = tr.spec_for(path, full, stacked_learners=stacked)
                js = jr.spec_for(path, full, stacked_learners=stacked)
                assert _spec(ts) == _spec(js), (path, stacked)
                got = tsh.resolve_pspec(ts, full, t.mesh)
                want = jsh.resolve_pspec(js, full, j.mesh)
                assert (_spec(got[0]), got[1]) == (_spec(want[0]), want[1])


def test_safe_pspec_surfaces_nondividing_shapes():
    """hymba's 25 heads and seamless's 256206-token vocab against TP-16,
    as tests/test_sharded.py holds the reference: the drop warns and
    resolve_pspec names it."""
    mesh = tsh.RankMesh((2, 16), ("fsdp", "model"))
    resolved, dropped = tsh.resolve_pspec(tsh.P("model", None), (25, 128),
                                          mesh)
    assert tuple(resolved) == (None, None) and dropped == ((0, "model"),)
    with pytest.warns(tsh.PSpecDropWarning, match="25, 128"):
        assert tsh.safe_pspec(tsh.P("model", None), (25, 128), mesh) \
            == tsh.P(None, None)
    resolved, dropped = tsh.resolve_pspec(tsh.P("model", "fsdp"),
                                          (256206, 1024), mesh)
    assert tuple(resolved) == (None, "fsdp") and dropped == ((0, "model"),)
    with warnings.catch_warnings():
        warnings.simplefilter("error", tsh.PSpecDropWarning)
        assert tsh.safe_pspec(tsh.P("fsdp", "model"), (256206, 1024),
                              mesh) == tsh.P("fsdp", "model")


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b",
                                  "deepseek-v2-lite-16b"])
def test_param_and_batch_pspecs_match_reference(arch):
    _, tmpl = _zoo(arch)
    stacked = jax.tree.map(lambda x: jax.ShapeDtypeStruct((1, 4, 2)
                                                          + x.shape,
                                                          x.dtype), tmpl)
    jm = AbstractMesh((1, 4, 2, 2, 16), HIER)
    tm = tsh.RankMesh((1, 4, 2, 2, 16), HIER)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", jsh.PSpecDropWarning)
        warnings.simplefilter("ignore", tsh.PSpecDropWarning)
        want = jax.tree.leaves(jsh.param_pspecs(stacked, jm,
                                                stacked_learners=True),
                               is_leaf=lambda s: isinstance(
                                   s, jax.sharding.PartitionSpec))
        got = tsh.param_pspecs(_meta(stacked), tm, stacked_learners=True)
    assert [_spec(s) for s in leaves(got)] == [_spec(s) for s in want]
    for n in (1, 3):
        assert _spec(tsh.batch_pspec(n)) == _spec(jsh.batch_pspec(n))


@pytest.mark.parametrize("plan", ["local@2/global@4",
                                  "local@2/pod@4/global@8"])
def test_round_batch_pspecs_match_reference(plan):
    """The round batch's specs at any plan depth (the learner axes over
    the mesh's, the example dim over fsdp, divisibility-checked)."""
    from repro.configs.base import HierAvgParams as JHier
    from repro.data.loader import round_batch_pspec as jspec
    from repro_torch.configs.base import HierAvgParams
    from repro_torch.data.loader import round_batch_pspec as tspec
    dims = HierAvgParams(plan=plan).batch_dims
    assert dims == JHier(plan=plan).batch_dims
    jm = AbstractMesh((1, 2, 2, 2, 1), HIER)
    tm = tsh.RankMesh((1, 2, 2, 2, 1), HIER)
    for tail in ((4,), (3,), (4, 16), (6, 8, 3)):
        shape = dims + (1, 2, 2) + tail
        assert _spec(tspec(dims, len(shape), tm, leaf_shape=shape)) \
            == _spec(jspec(dims, len(shape), jm, leaf_shape=shape))
    with pytest.raises(ValueError, match="learner dims"):
        tspec(dims, len(dims) + 2, tm)


def _meta(jtree):
    """A reference tree of ShapeDtypeStructs as the port's tree of meta
    tensors (dicts and lists alike)."""
    if isinstance(jtree, dict):
        return {k: _meta(v) for k, v in jtree.items()}
    if isinstance(jtree, (list, tuple)):
        return type(jtree)(_meta(v) for v in jtree)
    return torch.empty(jtree.shape, device="meta")


# --------------------------------------------------------------------- #
# the shard-aware bucket layout


def _sharded(fsdp=2, shape=(1, 2, 2)):
    sizes = shape + (fsdp, 1)
    return (tsh.ShardPlan(mesh=tsh.RankMesh(sizes, HIER)),
            jsh.ShardPlan(mesh=AbstractMesh(sizes, HIER)))


def _table(lay):
    return [(b.dtype, b.size, tuple(b.shape), b.shards,
             [(s.leaf, s.offset, s.size, tuple(s.shape), s.shard_dim)
              for s in b.slots]) for b in lay.buckets]


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("cap", [0, 1 << 20, 4 << 20])
def test_resnet18_sharded_layout_matches_reference(cap, uniform):
    """Slot tables (with each slot's shard dim), per-shard runs padded to
    the learner count, from meta tensors for ResNet-18 at width 64."""
    t = tres.resnet_init(None, CNNConfig(width=64), device="meta")
    t = tree_map(lambda x: torch.empty((1, 2, 2) + tuple(x.shape),
                                       device="meta"), t)
    j = jax.eval_shape(lambda k: jres.resnet_init(k, JCNN(width=64)),
                       jax.random.PRNGKey(0))
    j = jax.tree.map(lambda x: jax.ShapeDtypeStruct((1, 2, 2) + x.shape,
                                                    x.dtype), j)
    tsp, jsp = _sharded()
    tl = tcomm.BucketLayout.build(t, bucket_bytes=cap, uniform=uniform,
                                  shards=tsp)
    jl = jcomm.BucketLayout.build(j, bucket_bytes=cap, uniform=uniform,
                                  shards=jsp)
    assert _table(tl) == _table(jl)
    assert tl.describe() == jl.describe()
    assert any(b.shards == 2 for b in tl.buckets)
    assert all(b.shape[-1] % 4 == 0 for b in tl.buckets)
    assert not tl.lead_invariant
    with pytest.raises(NotImplementedError, match="matrix-mode"):
        tcomm.BucketLayout.build(t, matrix=True, shards=tsp)


def _mixed():
    rs = np.random.RandomState(1)
    p = {"w": rs.standard_normal((1, 2, 2, 8, 6)).astype(np.float32),
         "v": rs.standard_normal((1, 2, 2, 5)).astype(np.float32),
         "u": rs.standard_normal((1, 2, 2, 4, 3)).astype(np.float32)}
    return p


@pytest.mark.parametrize("uniform", [False, True])
def test_sharded_pack_and_views_match_reference_bit_for_bit(uniform):
    """Packing permutes no value: the port's wire and codec views of the
    shard-aware layout equal the reference's bytes, and unpack inverts
    pack."""
    p = _mixed()
    tsp, jsp = _sharded()
    tt = {k: torch.from_numpy(v) for k, v in p.items()}
    jt = {k: jnp.asarray(v) for k, v in p.items()}
    tl = tcomm.BucketLayout.build(tt, bucket_bytes=64, uniform=uniform,
                                  shards=tsp)
    jl = jcomm.BucketLayout.build(jt, bucket_bytes=64, uniform=uniform,
                                  shards=jsp)
    assert _table(tl) == _table(jl)
    tw, jw = tl.pack(tt), jax.jit(jl.pack)(jt)
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tl.codec_view(tw), jl.codec_view(jw)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = tl.unpack(tl.wire_view(tl.codec_view(tw)))
    for k in tt:
        assert torch.equal(back[k], tt[k])


@pytest.mark.parametrize("spec", ["mean", "cast:bfloat16", "topk:0.25",
                                  "randk:0.25", "qint8:32",
                                  "qint8:32:twopass"])
def test_wire_payload_bytes_match_reference(spec):
    """Sharded buckets bill their 1/F shard slice (the reference's
    ``Bucketed.wire_payload_bytes``); payload bytes and messages as the
    reference counts them."""
    p = {k: v[0, 0, 0] for k, v in _mixed().items()}
    tsp, jsp = _sharded()
    tr = tcomm.Bucketed(tcomm.get_reducer(spec), 64, shards=tsp)
    jr = jcomm.Bucketed(jcomm.get_reducer(spec), 64, shards=jsp)
    tt = {k: torch.from_numpy(v) for k, v in p.items()}
    jt = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in p.items()}
    assert tr.wire_payload_bytes(tt) == jr.wire_payload_bytes(jt)
    assert tr.payload_bytes(tt) == jr.payload_bytes(jt)
    assert tr.n_messages(tt) == jr.n_messages(jt)
    assert tr.wire_payload_bytes(tt) < tr.payload_bytes(tt)


@pytest.mark.parametrize("plan", ["local@2:topk:0.05/global@8:qint8",
                                  "local@2/pod@4:cast/global@8:topk:0.01"])
def test_theory_bills_sharded_levels_as_reference(plan):
    """``level_reduction_seconds`` and ``plan_comm_per_round`` of a
    shard-aware plan equal the reference's floats (the RS+AG bill is the
    ring formula at the per-device wire bytes)."""
    tsp, jsp = _sharded(shape=(2, 2, 2))
    tp = tapply(TPlan.parse(plan), 1 << 20, True, shards=tsp)
    jp = japply(JPlan.parse(plan), 1 << 20, True, shards=jsp)
    tt = ttheory.param_template(1 << 20, n_leaves=3)
    jt = jtheory.param_template(1 << 20, n_leaves=3)
    topo_t, topo_j = HierTopology(2, 2, 2), JTopo(2, 2, 2)
    for tl, jl in zip(tp.levels, jp.levels):
        assert ttheory.level_reduction_seconds(tl, topo_t, tt) \
            == jtheory.level_reduction_seconds(jl, topo_j, jt)
    got = ttheory.plan_comm_per_round(tp, topo_t, tt)
    want = jtheory.plan_comm_per_round(jp, topo_j, jt)
    assert [(c.wire_bytes, c.seconds_per_round) for c in got] \
        == [(c.wire_bytes, c.seconds_per_round) for c in want]


# --------------------------------------------------------------------- #
# the shard-aware reduction in one process


@pytest.mark.parametrize("spec", ["mean", "cast:bfloat16", "topk:0.25",
                                  "qint8:32"])
def test_unbound_sharded_reduction_matches_reference(spec):
    """The whole (1, 2, 2, 2, 1) grid in one process: the shard-aware
    Bucketed against the reference's on the same layout by its serial
    composition, jitted.  EF state lives in the codec view [1, 2, 4, run]
    and equals the reference's (top-k supports exactly)."""
    p, a = _mixed(), {k: v * 0.5 for k, v in _mixed().items()}
    tsp, jsp = _sharded()
    tr = tcomm.Bucketed(tcomm.get_reducer(spec), 64, shards=tsp)
    jr = jcomm.Bucketed(jcomm.get_reducer(spec), 64, shards=jsp)
    tt = {k: torch.from_numpy(v) for k, v in p.items()}
    ta = {k: torch.from_numpy(v) for k, v in a.items()}
    jt = {k: jnp.asarray(v) for k, v in p.items()}
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    tst = tr.init_state(ta)
    jst = jr.init_state(ja)
    got, tst1 = tcomm.reduce_with(tr, global_average, tt, tst)
    want, jst1 = jax.jit(lambda x, s: jserial(jr, jglobal, x, s))(jt, jst)
    scale = max(float(np.abs(v).max()) for v in p.values())
    for k in p:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   rtol=0, atol=2.0 ** -7 * scale)
    if tr.stateful:
        for x, y in zip(tst1.err, jst1.err):
            assert tuple(x.shape) == y.shape and y.shape[2] in (2, 4)
            np.testing.assert_array_equal(x.numpy() == 0,
                                          np.asarray(y) == 0)
            np.testing.assert_allclose(x.numpy(), np.asarray(y), 1e-5, 1e-6)


def test_reshape_drops_shard_space_state_loudly():
    """A fleet reshape cannot re-index shard-space EF (runs padded to the
    learner count, shards merged into the codec view): it warns with
    CommStateDropWarning and re-initializes, as the reference does."""
    from repro_torch import optim as toptim
    from repro_torch.configs.base import HierAvgParams
    from repro_torch.core import hier_avg as th
    p = {k: torch.from_numpy(v[0, 0, 0]) for k, v in _mixed().items()}
    tsp, _ = _sharded()
    h = HierAvgParams(plan="local@2/global@4:topk:0.25", bucket_bytes=64)
    plan = th.resolve_plan(h, None, None, shards=tsp)
    opt = toptim.sgd(0.1)
    state = th.init_state(HierTopology(1, 2, 2), lambda g: p, opt, None,
                          plan=plan, shards=tsp, device="cpu")
    assert state.comm_state["global"].err[-1].shape[2] in (2, 4)
    with pytest.warns(CommStateDropWarning):
        reshape_state(state, HierTopology(1, 2, 2), HierTopology(1, 1, 2),
                      plan=plan)


# --------------------------------------------------------------------- #
# one channel for the mesh a reduction runs on


def test_a_bound_mesh_is_passed_explicitly():
    """A round or a grouped mean runs on a mesh of ranks only through
    ``mesh=``: shards or bucket shardings laid on a bound mesh refuse to
    run without it (they would average the rank's block alone), and the
    launcher's layouts are learners x fsdp, clusters x fsdp, or one
    rank."""
    from repro_torch import optim as toptim
    from repro_torch.configs.base import HierAvgParams
    from repro_torch.core import hier_avg as th
    from repro_torch.core.topology import average_over
    m = tsh.RankMesh((1, 2, 2, 2, 1), HIER, rank=0)
    sp = tsh.shard_plan(m)
    h = HierAvgParams(plan="local@2/global@4:topk:0.25", bucket_bytes=64)
    opt = toptim.sgd(0.1)
    with pytest.raises(ValueError, match="pass mesh="):
        th.make_hier_round(tres.mlp_cls_loss, opt, h, shards=sp)
    with pytest.raises(ValueError, match="pass mesh="):
        th.make_hier_step(tres.mlp_cls_loss, opt, h, shards=sp,
                          mesh=tsh.RankMesh((1, 2, 2, 2, 1), HIER, rank=0))
    assert th.make_hier_round(tres.mlp_cls_loss, opt, h, shards=sp, mesh=m)
    wire = [torch.zeros(1, 1, 1, 8)]
    spec = tsh.RankSharding(m, tsh.P("pod", "group", "local"))
    with pytest.raises(ValueError, match="pass mesh="):
        average_over(wire, (0, 1, 2), None, [spec])
    with pytest.raises(ValueError, match="does not hold"):
        tmesh.rank_mesh(HierTopology(1, 2, 2), 2, 2, 0)


def test_telemetry_is_refused_on_a_bound_mesh():
    """No longer refused: a round on a bound mesh takes ``telemetry=``
    (its statistics are taken across the ranks; the gloo worlds of
    tests/test_torch_distributed.py hold them), and on a world of one rank
    (nothing spread) its statistics are the one-process round's: the
    divergences, gradient norms and EF mass bit for bit (the same sums in
    the same order), the codec error within 2 (K - 1) 2^-24 (its sum runs
    per learner first)."""
    import numpy as np
    import torch

    from repro_torch import optim as toptim
    from repro_torch.configs.base import HierAvgParams
    from repro_torch.core import hier_avg as th
    from repro_torch.configs.resnet18_cifar import MLPConfig
    from repro_torch.models.resnet import mlp_cls_init
    h = HierAvgParams(plan="local@2/global@4:topk:0.25")
    opt = toptim.sgd(0.1)
    assert th.make_hier_round(
        tres.mlp_cls_loss, opt, h, telemetry=True,
        mesh=tsh.RankMesh((1, 2, 2, 1, 1), HIER, rank=1))
    topo = HierTopology(1, 2, 2)
    cfg = MLPConfig(in_dim=16, hidden=(32,), n_classes=4)
    init = lambda g: mlp_cls_init(g, cfg, device="cpu")  # noqa: E731
    g = torch.Generator().manual_seed(3)
    batch = {"x": torch.randn(h.batch_dims + topo.shape + (4, 16),
                              generator=g),
             "y": torch.randint(0, 4, h.batch_dims + topo.shape + (4,),
                                generator=g).int()}
    out = []
    for mesh in (None, tsh.RankMesh((1, 1, 1, 1, 1), HIER, rank=0)):
        st = th.init_state(topo, init, opt, torch.Generator().manual_seed(0),
                           plan=h.resolved_plan, device="cpu")
        _, m = th.make_hier_round(tres.mlp_cls_loss, opt, h, mesh=mesh,
                                  telemetry=True)(st, batch)
        out.append({k: float(v) for k, v in m.items()
                    if k.startswith("telemetry/")})
    one, ranked = out
    n_el = 16 * 32 + 32 + 32 * 4 + 4
    assert sorted(one) == sorted(ranked)
    for k, v in one.items():
        if "codec_err" in k:
            assert abs(ranked[k] - v) <= 4 * (4 * n_el - 1) * 2.0 ** -24 \
                * abs(v), k
        else:
            assert ranked[k] == v, k
    assert np.isfinite(list(one.values())).all()
