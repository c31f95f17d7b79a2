"""The port's Hier-AVG on a mesh of ``torch.distributed`` ranks (gloo on
the CPU) against the reference's replicated run under ``jax.jit``.

Three worlds run once per module (``worlds`` fixture), each every case of
``tests/_torch_worlds.py``; the tests read what they wrote.  The learner
grid is (1, 2, 2) throughout:

  a — mesh (1, 2, 2, 1, 1), 4 ranks: each learner a rank, fsdp 1;
  b — mesh (1, 2, 2, 2, 1), 8 ranks: 4 learners x fsdp 2, the shard-aware
      buckets (reduce-scatter + all-gather, the fsdp regather);
  c — mesh (1, 2, 1, 1, 1), 2 ranks: each rank a cluster, so the local
      level never leaves the rank (the paper's deployment).

The reference runs replicated in this process: the reference holds its
own sharded run to that one (``tests/test_sharded.py:162,255``), so no
forced-device JAX process is needed.  Its shard-space state comes from
its shard-aware ``BucketLayout`` on an ``AbstractMesh`` (layout and codec
are collective-free) and its serial composition, whose grouped mean is
the plain mean of the wire view.

Limits, set from their reasoning before the first run:
  * a mean of n = 4 fp32 learners in another order: each side is within
    (n - 1) u sum|x| / n of the exact mean, so the two are within
    MEAN_LIMIT = n * 2^-23 * max|x| (u = 2^-24); a control that drops one
    learner must exceed it;
  * cast:bfloat16: the port sums in fp32 and rounds once, so the two are
    within one bf16 ulp, CAST_LIMIT = 2^-7 * max|x|; the same control;
  * qint8 wire bytes and top-k supports: equal (data movement);
  * rounds: ``tests/test_torch_hier.py``'s limits (1e-5 relative plus
    1e-6 absolute), top-k supports equal at every fire;
  * all-true masks and checkpoints: bit for bit.
"""
import functools
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

import _torch_worlds as W  # noqa: E402
from repro import comm as jcomm  # noqa: E402
from repro.checkpoint import load_checkpoint as jload  # noqa: E402
from repro.comm.reducer import serial_reduce as jserial  # noqa: E402
from repro.configs.base import HierAvgParams as JHier  # noqa: E402
from repro.configs.resnet18_cifar import MLPConfig  # noqa: E402
from repro.core import hier_avg as jh  # noqa: E402
from repro.core.topology import HierTopology as JTopo  # noqa: E402
from repro.core.topology import global_average as jglobal  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.models import resnet as jres  # noqa: E402
from repro.parallel.sharding import ShardPlan as JShardPlan  # noqa: E402

from repro_torch.testing import spawn_world  # noqa: E402

MLP = MLPConfig(in_dim=16, hidden=(32,), n_classes=4)
N = 4
RTOL, ATOL = 1e-5, 1e-6
WORLD_SIZES = {"a": 4, "b": 8, "c": 2}
HIER = ("pod", "group", "local", "fsdp", "model")


def _mixture(rng, shape_lead, n_classes=4, in_dim=16):
    means = np.random.default_rng(7).standard_normal((n_classes, in_dim))
    means = 2.0 * means / np.linalg.norm(means, axis=-1, keepdims=True)
    y = rng.integers(0, n_classes, size=shape_lead).astype(np.int32)
    x = means[y] + 0.5 * rng.standard_normal(shape_lead + (in_dim,))
    return {"x": x.astype(np.float32), "y": y}


@functools.lru_cache(maxsize=None)
def _round_inputs(world):
    h = JHier(plan=W.ROUND_PLANS[world])
    p = jax.tree.map(np.asarray, jax.jit(
        lambda k: jres.mlp_cls_init(k, MLP))(jax.random.PRNGKey(0)))
    batches = [_mixture(np.random.default_rng(10 + r),
                        h.batch_dims + W.TOPO + (W.B,))
               for r in range(W.ROUNDS)]
    return p, batches


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Spawn worlds a, b and c one after another; returns each world's
    (npz of the whole grid's results, per-rank checks)."""
    d = str(tmp_path_factory.mktemp("worlds"))
    out = {}
    for name, n in WORLD_SIZES.items():
        p, batches = _round_inputs(name)
        spawn_world(W.run, n, name, d, p, batches, timeout=300)
        checks = []
        for r in range(n):
            with open(os.path.join(d, f"{name}-{r}.json")) as f:
                checks.append(json.load(f))
        out[name] = (dict(np.load(os.path.join(d, f"{name}.npz"))), checks)
    return out


# --------------------------------------------------------------------- #
# the reference, replicated, under jit


def _shards(world):
    if W.MESHES[world][3] == 1:
        return None
    return JShardPlan(mesh=AbstractMesh(W.MESHES[world], HIER))


@functools.lru_cache(maxsize=None)
def _ref_reduction(spec, world, engine="bucketed"):
    """The reference's bucketed reduction of the same inputs (shard-aware
    on world b's mesh) by its serial composition, jitted, on the
    ``engine``'s layout (the pipelined engine's uniform layout is
    bit-identical to its serial composition, the reference's own
    contract): (out, state, reducer, params)."""
    p_np, a_np = W.reduction_inputs()
    cls = jcomm.Pipelined if engine == "pipelined" else jcomm.Bucketed
    red = cls(jcomm.get_reducer(spec), W.CAP, shards=_shards(world))
    p = jax.tree.map(jnp.asarray, p_np)
    st = red.init_state(jax.tree.map(jnp.asarray, a_np))
    out, st1 = jax.jit(lambda p, s: jserial(red, jglobal, p, s))(p, st)
    return out, st1, red, p


@functools.lru_cache(maxsize=None)
def _ref_perleaf(spec):
    p_np, _ = W.reduction_inputs()
    p = jax.tree.map(jnp.asarray, p_np)
    red = jcomm.get_reducer(spec)
    out, _ = jax.jit(lambda p: jcomm.reduce_with(red, jglobal, p, ()))(p)
    return out


def _max_diff(got, want):
    return max(float(np.abs(np.asarray(got[k], np.float64)
                            - np.asarray(want[k], np.float64)).max())
               for k in want)


def _outs(npz, name):
    pre = f"{name}/out/"
    return {k[len(pre):]: v for k, v in npz.items() if k.startswith(pre)}


ENGINES = ("bucketed", "pipelined")


# --------------------------------------------------------------------- #
# reductions


@pytest.mark.parametrize("world", ["a", "b", "c"])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("spec,limit", [("mean", 2.0 ** -23 * N),
                                        ("cast", 2.0 ** -7)])
def test_mean_and_cast_match_replicated_reference(worlds, world, engine,
                                                  spec, limit):
    """The bucketed (world b: shard-aware) mean and cast on the ranks equal
    the reference's replicated per-leaf reduction within the reordering
    limit, and a control that drops one learner from the mean fails it."""
    npz, _ = worlds[world]
    p_np, _ = W.reduction_inputs()
    scale = max(float(np.abs(v).max()) for v in p_np.values())
    want = _ref_perleaf("mean" if spec == "mean" else "cast:bfloat16")
    got = _outs(npz, f"{spec}_{engine}")
    assert _max_diff(got, want) <= limit * scale
    dropped = {k: np.broadcast_to(v.reshape(-1, *v.shape[3:])[1:].mean(0),
                                  v.shape) for k, v in p_np.items()}
    assert _max_diff(dropped, want) > limit * scale


@pytest.mark.parametrize("world", ["a", "b", "c"])
def test_qint8_wire_bytes_equal_and_mean_within_limit(worlds, world):
    """The packed qint8 wire of every rank's codec rows equals the
    reference's bit for bit (shard runs on world b), and the reduction
    lands within the reordering limit of the reference's and within the
    quantizer's error of the dense mean."""
    npz, _ = worlds[world]
    out, st, red, p = _ref_reduction("qint8:32", world)
    lay = red.layout_for(p)
    codec = lay.codec_view(lay.pack(p))
    wire, _ = jax.jit(lambda c: red.inner.compress(c, ()))(codec)
    for i, (w, c) in enumerate(zip(wire, codec)):
        want = np.asarray(w).reshape(tuple(c.shape[:3]) + w.shape[1:])
        np.testing.assert_array_equal(npz[f"qint8_wire/{i}"], want)
    scale = max(float(np.abs(np.asarray(x)).max())
                for x in jax.tree.leaves(p))
    dense = _ref_perleaf("mean")
    for engine in ENGINES:
        want = jax.tree.map(np.asarray,
                            _ref_reduction("qint8:32", world, engine)[0])
        got = _outs(npz, f"qint8_{engine}")
        assert _max_diff(got, want) <= 2.0 ** -23 * N * scale
        assert _max_diff(got, dense) <= scale / 100.0


@pytest.mark.parametrize("world", ["a", "b", "c"])
@pytest.mark.parametrize("engine", ENGINES)
def test_topk_supports_and_ef_in_codec_view(worlds, world, engine):
    """Top-k on the ranks: each bucket's EF residual has the reference's
    zero pattern exactly (the coordinates sent), its values and ref within
    the round limits, in the codec view (world b: [1, 2, 4, run], a shard
    row per learner and shard); the averaged params too."""
    npz, _ = worlds[world]
    out, st, red, p = _ref_reduction("topk:0.25", world, engine)
    name = f"topk_{engine}"
    for i, (r, e) in enumerate(zip(st.ref, st.err)):
        got_e, got_r = npz[f"{name}/err/{i}"], npz[f"{name}/ref/{i}"]
        assert got_e.shape == e.shape
        if W.MESHES[world][3] > 1 and red.layout_for(p).buckets[i].shards > 1:
            assert got_e.shape[2] == 4            # S * F codec rows
        np.testing.assert_array_equal(got_e == 0, np.asarray(e) == 0)
        np.testing.assert_allclose(got_e, np.asarray(e), RTOL, ATOL)
        np.testing.assert_allclose(got_r, np.asarray(r), RTOL, ATOL)
    got = _outs(npz, name)
    for k, v in jax.tree.map(np.asarray, out).items():
        np.testing.assert_allclose(got[k], v, RTOL, ATOL)


# --------------------------------------------------------------------- #
# collectives


def test_sharded_bucket_collective_counts(worlds):
    """On world b a global mean of each sharded bucket runs one
    reduce-scatter and one all-gather per active mesh axis (group and
    local), plus one all-gather for the fsdp regather, and no all-reduce;
    a flat bucket (the (6,) leaf no rule shards) runs the same pair per
    axis and no regather."""
    _, checks = worlds["b"]
    for c in checks:
        for spec in W.SPECS:
            for engine in ENGINES:
                name = f"{spec.split(':')[0]}_{engine}"
                n, ns = c[f"n_buckets_{name}"], c[f"n_sharded_{name}"]
                assert ns == 4 and n == 5, (name, n, ns)
                assert c[f"counts_{name}"] == {
                    "all_reduce": 0, "reduce_scatter": 2 * n,
                    "all_gather": 2 * n + ns}, (name, c[f"counts_{name}"])


@pytest.mark.parametrize("world", ["a", "b", "c"])
def test_ab_builders_collective_counts(worlds, world):
    """The A/B reduction (``repro_torch.testing``, the reference's
    24-leaf shape at the 32 KiB cap: 24 buckets) on the ranks, both
    schedules: with fsdp 2 (world b) one reduce-scatter and one all-gather
    per active axis (group and local) per bucket plus the regather and no
    all-reduce, as ``tests/test_sharded.py`` counts the reference's HLO;
    with fsdp 1 one all-reduce per bucket."""
    for c in worlds[world][1]:
        for sched in ("serial", "pipelined"):
            n, counts = c[f"ab_{sched}"]
            assert n == 24
            if world == "b":
                want = {"all_reduce": 0, "reduce_scatter": 2 * n,
                        "all_gather": 3 * n}
            else:
                want = {"all_reduce": n, "reduce_scatter": 0,
                        "all_gather": 0}
            assert counts == want, (sched, counts)


@pytest.mark.parametrize("world", ["a", "c"])
def test_replicated_bucket_collective_counts(worlds, world):
    """With fsdp 1 every bucket's global mean is one all-reduce over the
    level's group; nothing is scattered or gathered."""
    _, checks = worlds[world]
    for c in checks:
        for spec in W.SPECS:
            for engine in ENGINES:
                name = f"{spec.split(':')[0]}_{engine}"
                assert c[f"counts_{name}"] == {
                    "all_reduce": c[f"n_buckets_{name}"],
                    "reduce_scatter": 0, "all_gather": 0}


def test_local_level_stays_in_rank(worlds):
    """World c: each rank is a cluster, so a round's two local fires call
    no collective; its one global fire all-reduces each bucket of the
    top-k level once (the MLP packs into one bucket)."""
    _, checks = worlds["c"]
    for c in checks:
        for r in range(W.ROUNDS):
            assert c[f"round_counts_{r}"] == {
                "all_reduce": 1, "reduce_scatter": 0, "all_gather": 0}


def test_rsag_against_allreduce_on_gloo(worlds):
    """World b: the buckets' mean by reduce-scatter + all-gather and by
    one all-reduce agree within the reordering limit (whether they agree
    bit for bit is printed: the two collectives sum in their own
    orders)."""
    p_np, _ = W.reduction_inputs()
    scale = max(float(np.abs(v).max()) for v in p_np.values())
    for c in worlds["b"][1]:
        print("rs+ag == all-reduce bit for bit:",
              c["rsag_equals_allreduce"], c["rsag_vs_allreduce_max"])
        assert c["rsag_vs_allreduce_max"] <= 2.0 ** -23 * N * scale


@pytest.mark.parametrize("world", ["a", "b", "c"])
def test_all_true_masks_equal_dense_bit_for_bit(worlds, world):
    """An all-true mask through the masked path equals the dense path bit
    for bit on the same collectives: a bucketed mean (world b: through
    reduce-scatter + all-gather) and a whole elastic round."""
    for c in worlds[world][1]:
        assert c["mask_all_true_bit_identical"]
        assert c["round_all_true_bit_identical"]


# --------------------------------------------------------------------- #
# rounds


@functools.lru_cache(maxsize=None)
def _ref_rounds(world):
    p, batches = _round_inputs(world)
    h = JHier(plan=W.ROUND_PLANS[world])
    opt = joptim.sgd(0.1, momentum=0.9)
    init = lambda k: jax.tree.map(jnp.asarray, p)  # noqa: E731
    state = jh.init_state(JTopo(*W.TOPO), init, opt, jax.random.PRNGKey(0),
                          plan=h.resolved_plan)
    rnd = jax.jit(jh.make_hier_round(jres.mlp_cls_loss, opt, h))
    erd = jax.jit(jh.make_hier_round(jres.mlp_cls_loss, opt, h,
                                     elastic=True))
    masked, _ = erd(state, jax.tree.map(jnp.asarray, batches[0]),
                    jnp.asarray(W.masks(len(h.resolved_plan.levels))))
    out = []
    for b in batches:
        state, m = rnd(state, jax.tree.map(jnp.asarray, b))
        out.append((state, m))
    return out, masked


@pytest.mark.parametrize("world", ["a", "b", "c"])
def test_round_matches_replicated_reference(worlds, world):
    """Two rounds of the world's plan on the ranks (a: local mean and a
    bucketed top-k global level; b: the 3-level bucketed mean plan at
    fsdp 2; c: a's plan with the local level in-rank) against the
    reference's replicated rounds: loss, params, momentum and EF at the
    round limits, top-k supports equal."""
    npz, _ = worlds[world]
    ref, _ = _ref_rounds(world)
    for r, (state, m) in enumerate(ref):
        np.testing.assert_allclose(npz[f"round{r}/loss"], float(m["loss"]),
                                   RTOL, ATOL)
        for i, x in enumerate(jax.tree.leaves(state.params)):
            np.testing.assert_allclose(npz[f"round{r}/params/{i}"],
                                       np.asarray(x), RTOL, ATOL)
        for i, x in enumerate(jax.tree.leaves(state.opt_state)):
            np.testing.assert_allclose(npz[f"round{r}/opt/{i}"],
                                       np.asarray(x), RTOL, ATOL)
        for name, cs in (state.comm_state or {}).items():
            for i, e in enumerate(jax.tree.leaves(cs.err)):
                got = npz[f"round{r}/{name}/err/{i}"]
                np.testing.assert_array_equal(got == 0, np.asarray(e) == 0)
                np.testing.assert_allclose(got, np.asarray(e), RTOL, ATOL)


@pytest.mark.parametrize("world", ["a", "b", "c"])
def test_masked_round_matches_reference(worlds, world):
    """One elastic round under a seeded mask (every group keeps a member)
    on the ranks against the reference's elastic round."""
    npz, _ = worlds[world]
    _, masked = _ref_rounds(world)
    for i, x in enumerate(jax.tree.leaves(masked.params)):
        np.testing.assert_allclose(npz[f"masked/params/{i}"], np.asarray(x),
                                   RTOL, ATOL)


# --------------------------------------------------------------------- #
# checkpoints and data


@pytest.mark.parametrize("world", ["a", "b", "c"])
def test_checkpoint_round_trip_bit_for_bit(worlds, world):
    """A TrainState saved from the ranks (rank 0 writes the whole grid in
    the reference's format) and restored onto them is bit for bit the
    state each rank held; the reference reads the file."""
    npz, checks = worlds[world]
    for c in checks:
        assert c["ckpt_bit_identical"]
    arrays = jload(checks[0]["ckpt_path"])
    ref, _ = _ref_rounds(world)
    state = ref[-1][0]
    for i, x in enumerate(jax.tree.leaves(state.params)):
        key = sorted(k for k in arrays if k.startswith(".params/"))[i]
        assert arrays[key].shape == np.asarray(x).shape
        np.testing.assert_array_equal(arrays[key],
                                      npz[f"round{W.ROUNDS - 1}/params/{i}"])


def test_sharded_ef_checkpoint_rows(worlds):
    """World b's top-k EF state, saved from the ranks, holds the codec
    view's shard rows ([1, 2, S*F, run]) and equals the reference's
    shard-space state."""
    npz, checks = worlds["b"]
    for c in checks:
        assert c["ef_ckpt_bit_identical"]
    arrays = jload(checks[0]["ef_ckpt_path"])
    _, st, _, _ = _ref_reduction("topk:0.25", "b")
    for i, e in enumerate(st.err):
        got = arrays[f".err/{i}"]
        assert got.shape == np.asarray(e).shape
        np.testing.assert_array_equal(got, npz[f"topk_bucketed/err/{i}"])


@pytest.mark.parametrize("world", ["a", "b", "c"])
def test_loader_block_matches_one_process_loader(worlds, world):
    """``HierDataLoader(mesh=)`` and ``(shardings=)`` give each rank its
    block of the one-process loader's round, bit for bit."""
    for c in worlds[world][1]:
        assert c["loader_block_equal"]


@pytest.mark.parametrize("world,sizes", [
    ("a", {"local": 2, "global": 4}),
    ("b", {"local": 2, "pod": 4, "global": 4}),
    ("c", {"local": 1, "global": 2})])
def test_level_process_groups(worlds, world, sizes):
    """Each plan level's process group on the rank, its size counted (1:
    the level stays inside the rank, as world c's local level does);
    world b's groups keep the fsdp axis, so a shard averages with its 4
    peers, not 8."""
    for c in worlds[world][1]:
        assert c["level_group_sizes"] == sizes
