"""The port's bucket engine (comm/bucket.py) and the trainer on it against
the JAX package's.

Layouts, packing and the bit-identity contracts of the reference
(tests/test_bucket.py) are held exactly: slot tables and bucket shapes
equal the reference's, pack/unpack and bucketed/pipelined mean and cast
are bit for bit.  Reference outputs come from ``jax.jit`` (its eager
bucket results drift by 1 ulp).  The trainer runs two rounds from one
converted state, within the tolerances of tests/test_torch_hier.py, with
two exact checks:

  * top-k: the support of every fire equals the reference's (the EF
    residual's zero pattern), with every fire's gap between the k-th and
    (k+1)-th magnitudes above GAP;
  * qint8: the local level quantizes the params themselves, with no EF,
    so an fp32 rounding difference between the packages' SGD steps can
    move x / scale across a rounding boundary.  The wire's int8 payload
    must equal the reference's except where the reference's x / scale
    lies within DELTA of a half-integer; there one step is allowed, and
    the test counts those coordinates.  Each block's fp32 scale is an
    fp32 value of the params, held within 1e-5 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import comm as jcomm  # noqa: E402
from repro.comm import quant as jquant  # noqa: E402
from repro.comm import sparse as jsparse  # noqa: E402
from repro.configs.base import HierAvgParams as JHier  # noqa: E402
from repro.configs.resnet18_cifar import CNNConfig as JCNN  # noqa: E402
from repro.configs.resnet18_cifar import MLPConfig  # noqa: E402
from repro.core import hier_avg as jh  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core.topology import HierTopology as JTopo  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.models import resnet as jres  # noqa: E402

from repro_torch import comm as tcomm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.comm import quant as tquant  # noqa: E402
from repro_torch.comm import sparse as tsparse  # noqa: E402
from repro_torch.configs.base import HierAvgParams  # noqa: E402
from repro_torch.configs.resnet18_cifar import CNNConfig  # noqa: E402
from repro_torch.core import hier_avg as th  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.core.topology import HierTopology  # noqa: E402
from repro_torch.models import resnet as tres  # noqa: E402
from repro_torch.tree import (flatten, flatten_up_to, leaves,  # noqa: E402,E501
                              tree_map)

MLP = MLPConfig(in_dim=16, hidden=(32,), n_classes=4)
B = 4
RTOL, ATOL = 1e-5, 1e-6
GAP = 1e-6
# a quantized coordinate may differ by one step only where the
# reference's x / scale lies within DELTA of a half-integer: x / scale
# moves by up to 127 times the relative difference of the two packages'
# params, so DELTA covers a difference of 8e-6, inside the RTOL the
# states are held to
DELTA = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, rtol=RTOL, atol=ATOL, what=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _raw(x):
    """A tensor or array as its raw bits (bf16 included)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    x = np.ascontiguousarray(np.asarray(x))
    return x.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[x.dtype.itemsize])


def _equal(a, b, what=""):
    a, b = _raw(a), _raw(b)
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _mixed_np(shape=(1, 2, 2), seed=0):
    """The reference's mixed tree (tests/test_bucket.py): fp32 and bf16
    leaves and a scalar."""
    import ml_dtypes
    rng = np.random.default_rng(seed)
    mk = lambda s, d=np.float32: rng.standard_normal(  # noqa: E731
        shape + s).astype(d)
    return {"w0": mk((6, 5)), "b0": mk((7,)),
            "h": mk((3, 4, 2), ml_dtypes.bfloat16), "scalar": mk(()),
            "w1": mk((8, 3), ml_dtypes.bfloat16)}


def _pair(tree_np):
    return (convert.tree_from_numpy(tree_np, device="cpu"),
            jax.tree.map(jnp.asarray, tree_np))


def _gavg(t, cf=None):
    return ttopo.average_over(t, (0, 1, 2))


def _table(lay):
    return [(b.dtype, b.size, tuple(b.shape),
             [(s.leaf, s.offset, s.size, tuple(s.shape)) for s in b.slots])
            for b in lay.buckets]


# --------------------------------------------------------------------- #
# layouts


def _resnet_shapes():
    t = tres.resnet_init(None, CNNConfig(width=64), device="meta")
    t = tree_map(lambda x: torch.empty((1, 4, 4) + tuple(x.shape),
                                       device="meta"), t)
    j = jax.eval_shape(lambda k: jres.resnet_init(k, JCNN(width=64)),
                       jax.random.PRNGKey(0))
    j = jax.tree.map(lambda x: jax.ShapeDtypeStruct((1, 4, 4) + x.shape,
                                                    x.dtype), j)
    return t, j


@pytest.mark.parametrize("matrix", [False, True])
@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("model", ["mlp", "mixed", "resnet18"])
def test_layout_matches_jax(model, matrix, uniform):
    """Slot tables (leaf, offset, size, shape) and bucket shapes, built
    from meta tensors for ResNet-18 at width 64 (nothing allocated)."""
    if model == "resnet18":
        tt, jt = _resnet_shapes()
        caps = (4 << 20,)
    elif model == "mlp":
        p = _np(jres.mlp_cls_init(jax.random.PRNGKey(0), MLP))
        tt, jt = _pair(jax.tree.map(
            lambda x: np.broadcast_to(x, (1, 2, 2) + x.shape).copy(), p))
        caps = (0, 256, 1024, 4 << 20)
    else:
        tt, jt = _pair(_mixed_np())
        caps = (0, 16, 64, 4 << 20)
    for cap in caps:
        tl = tcomm.BucketLayout.build(tt, bucket_bytes=cap, matrix=matrix,
                                      uniform=uniform)
        jl = jcomm.BucketLayout.build(jt, bucket_bytes=cap, matrix=matrix,
                                      uniform=uniform)
        assert _table(tl) == _table(jl), cap
        assert tl.describe() == jl.describe()
        for a, b in zip(tl.bucket_structs((2,)), jl.bucket_structs((2,))):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).replace("torch.", "") == b.dtype.name
    if model == "resnet18":
        # the figures the slice is planned on: 10 buckets either way, the
        # uniform layout padding every run to 2,359,296 (2.11x the model)
        assert tl.n_buckets == 10 and tl.n_leaves == 55
        sizes = [b.padded_size for b in tl.buckets]
        if uniform:
            assert sizes == [2_359_296] * 10 if not matrix \
                else all(b.shape == (1536, 1536) for b in tl.buckets)
        elif not matrix:
            assert sum(sizes) == 11_172_160


def test_pack_unpack_bit_exact_and_equal_to_jax():
    tt, jt = _pair(_mixed_np())
    for cap in (0, 16, 64):
        for matrix in (False, True):
            for uniform in (False, True):
                tl = tcomm.BucketLayout.build(tt, bucket_bytes=cap,
                                              matrix=matrix, uniform=uniform)
                jl = jcomm.BucketLayout.build(jt, bucket_bytes=cap,
                                              matrix=matrix, uniform=uniform)
                packed = tl.pack(tt)
                for a, b in zip(packed, jl.pack(jt)):
                    _equal(a, b)
                back = tl.unpack(packed)
                for k in tt:
                    assert back[k].dtype == tt[k].dtype
                    _equal(back[k], tt[k])
                    assert back[k].is_contiguous()


def test_layout_refuses_shards_and_short_leaves():
    """Shard-aware layouts are built (no longer refused): a ShardPlan
    threads into the layout and the wrapper, a replicated layout has no
    bucket shardings, and a leaf without the learner axes still raises.
    (tests/test_torch_parallel.py holds the sharded layouts against the
    reference.)"""
    from repro_torch.parallel.sharding import RankMesh, shard_plan
    tt, _ = _pair(_mixed_np())
    sp = shard_plan(RankMesh((1, 1, 1, 2, 1),
                             ("pod", "group", "local", "fsdp", "model")))
    lay = tcomm.BucketLayout.build(tt, shards=sp)
    assert lay.shards is sp and not lay.lead_invariant
    assert len(lay.bucket_shardings()) == lay.n_buckets
    assert tcomm.Bucketed(tcomm.get_reducer("mean"), shards=sp).shards is sp
    assert tcomm.BucketLayout.build(tt).bucket_shardings() is None
    with pytest.raises(ValueError, match="leading learner axes"):
        tcomm.BucketLayout.build({"x": torch.zeros(3)})


# --------------------------------------------------------------------- #
# bit-identity contracts (the reference's tests/test_bucket.py:138,406,
# 604,628)


@pytest.mark.parametrize("spec", ["mean", "cast:bfloat16"])
def test_bucketed_and_pipelined_mean_cast_bit_identical_to_perleaf(spec):
    tt, jt = _pair(_mixed_np(seed=1))
    per_leaf, _ = tcomm.reduce_with(tcomm.get_reducer(spec), _gavg, tt, ())
    for red in (tcomm.Bucketed(tcomm.get_reducer(spec)),
                tcomm.Bucketed(tcomm.get_reducer(spec), 64),
                tcomm.Pipelined(tcomm.get_reducer(spec), 64)):
        out, _ = tcomm.reduce_with(red, _gavg, tt, ())
        for k in tt:
            assert out[k].dtype == per_leaf[k].dtype
            _equal(out[k], per_leaf[k], f"{red} {k}")
    # and all of them agree with the reference's per-leaf path under jit
    want, _ = jax.jit(lambda t: jcomm.reduce_with(
        jcomm.get_reducer(spec), jtopo.global_average, t, ()))(jt)
    for k in tt:
        _close(per_leaf[k].float(), np.asarray(want[k], np.float32),
               rtol=1e-2 if per_leaf[k].dtype == torch.bfloat16 else RTOL)


@pytest.mark.parametrize("spec", ["mean", "cast:bfloat16", "qint8:32",
                                  "topk:0.3", "randk:0.3", "powersgd:2"])
def test_pipelined_bit_identical_to_serial_on_one_layout(spec):
    """The same uniform layout, serial (Bucketed.reduce) against the
    pipelined loop: outputs and the carried state bit for bit, and the
    stateful codecs' state is not trivial."""
    tt, _ = _pair(_mixed_np(seed=2))
    f32 = {k: v for k, v in tt.items() if v.dtype == torch.float32}
    red = tcomm.Pipelined(tcomm.get_reducer(spec), 64)
    assert red.layout_for(f32).n_buckets >= 2
    st0 = red.init_state({k: torch.zeros_like(v) for k, v in f32.items()}) \
        if red.stateful else ()
    if red.stateful:
        assert red.inner.split_bucket_states(st0, red.layout_for(f32)
                                             .n_buckets) is not None
    ser, ser_st = tcomm.Bucketed.reduce(red, _gavg, f32, st0)
    pip, pip_st = tcomm.reduce_with(red, _gavg, f32, st0)
    for k in f32:
        assert torch.equal(pip[k], ser[k]), k
    assert len(leaves(pip_st)) == len(leaves(ser_st))
    for a, b in zip(leaves(pip_st), leaves(ser_st)):
        assert torch.equal(a, b)
    if red.stateful:
        assert any(float(x.abs().max()) > 0 for x in leaves(pip_st.err))


def test_bucketed_topk_equals_flat_k_of_the_model():
    """Global k: the bucketed top-k payload is the top-k of each learner's
    whole flattened model (the reference's lax.top_k oracle)."""
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((1, 1, 4, 9, 3)).astype(np.float32),
            "b": rng.standard_normal((1, 1, 4, 17)).astype(np.float32)}
    tt, _ = _pair(tree)
    red = tcomm.Bucketed(tcomm.get_reducer("topk:0.25"))
    st = red.init_state({k: torch.zeros_like(v) for k, v in tt.items()})
    (vals, idx), = red.compress(tt, st)[0]
    n = 9 * 3 + 17
    k = max(1, round(0.25 * n))
    assert vals.shape == (4, k)
    flat = np.concatenate([tree["a"].reshape(4, -1),
                           tree["b"].reshape(4, -1)], axis=-1)
    want_vals, want_idx = jax.lax.top_k(jnp.abs(jnp.asarray(flat)), k)
    for r in range(4):
        assert sorted(idx[r].tolist()) == sorted(
            np.asarray(want_idx)[r].tolist())
        np.testing.assert_array_equal(np.sort(np.abs(vals[r].numpy())),
                                      np.sort(np.asarray(want_vals)[r]))


# --------------------------------------------------------------------- #
# carried state


def _mlp_init_np(seed=0):
    return _np(jres.mlp_cls_init(jax.random.PRNGKey(seed), MLP))


@pytest.mark.parametrize("kw", [
    dict(plan="local@2:topk:0.5/global@4:topk:0.25"),
    dict(plan="local@2:topk:0.5/global@4:topk:0.25", bucket_bytes=256),
    dict(plan="local@2:topk:0.5/global@4:topk:0.25", bucket_bytes=256,
         overlap=False),
    dict(plan="local@2:randk:0.5/global@4:powersgd:2:bucketed",
         bucket_bytes=1024),
    dict(plan="local@2:qint8/global@4:powersgd:2"),
])
def test_init_state_matches_jax(kw):
    """EF / PowerSGD state structure and shapes equal the reference's, for
    serial and uniform layouts, from a spec string with the hier's
    bucket_bytes / overlap."""
    p_np = _mlp_init_np()
    jopt, topt = joptim.sgd(0.1), toptim.sgd(0.1)
    init_kw = {k: v for k, v in kw.items() if k != "plan"}
    js = jh.init_state(JTopo(1, 2, 2), lambda k: jax.tree.map(
        jnp.asarray, p_np), jopt, jax.random.PRNGKey(0), plan=kw["plan"],
        **init_kw)
    ts = th.init_state(HierTopology(1, 2, 2),
                       lambda g: convert.tree_from_numpy(p_np, device="cpu"),
                       topt, None, plan=kw["plan"], device="cpu", **init_kw)
    assert sorted(ts.comm_state or {}) == sorted(js.comm_state or {})
    for name, jst in (js.comm_state or {}).items():
        tst = ts.comm_state[name]
        assert type(tst).__name__ == type(jst).__name__
        for part in ("ref", "err"):
            assert [tuple(x.shape) for x in leaves(getattr(tst, part))] \
                == [x.shape for x in jax.tree.leaves(getattr(jst, part))]
        if hasattr(jst, "q"):
            tq, jq = _q_lists(ts, js, name)
            assert [() if isinstance(x, tuple) else tuple(x.shape)
                    for x in tq] == [() if isinstance(x, tuple) else x.shape
                                     for x in jq]
    # the round built from the same hier accepts the state
    h = HierAvgParams(**kw)
    rnd = th.make_hier_round(tres.mlp_cls_loss, topt, h)
    batch = _round_batch(h.batch_dims, (1, 2, 2), 3)
    ts, m = rnd(ts, {k: _t(v) for k, v in batch.items()})
    assert np.isfinite(float(m["loss"]))


def test_mismatched_state_fails_loudly():
    """Per-leaf EF state into a bucketed round, and serial-layout state
    into a pipelined multi-bucket round, raise instead of misaligning."""
    p_np = _mlp_init_np()
    topt = toptim.sgd(0.1)
    init = lambda g: convert.tree_from_numpy(p_np, device="cpu")  # noqa: E731
    batch = _round_batch((2, 2), (1, 2, 2), 4)
    batch = {k: _t(v) for k, v in batch.items()}
    for good, bad in (
            (dict(k1=2, k2=4, reducer="topk:0.25"),
             dict(k1=2, k2=4, reducer="topk:0.25", bucket_bytes=0)),
            (dict(k1=2, k2=4, reducer="topk:0.25", bucket_bytes=72),
             dict(k1=2, k2=4, reducer="topk:0.25", bucket_bytes=72,
                  overlap=False))):
        h = HierAvgParams(**good)
        state = th.init_state(HierTopology(1, 2, 2), init, topt, None,
                              plan=HierAvgParams(**bad).resolved_plan,
                              device="cpu")
        with pytest.raises(ValueError, match="bucket layout"):
            th.make_hier_round(tres.mlp_cls_loss, topt, h)(state, batch)


# --------------------------------------------------------------------- #
# the trainer against the reference under jit


def _mixture(rng, shape_lead, n_classes=4, in_dim=16):
    means = np.random.default_rng(7).standard_normal((n_classes, in_dim))
    means = 2.0 * means / np.linalg.norm(means, axis=-1, keepdims=True)
    y = rng.integers(0, n_classes, size=shape_lead).astype(np.int32)
    x = means[y] + 0.5 * rng.standard_normal(shape_lead + (in_dim,))
    return {"x": x.astype(np.float32), "y": y}


def _round_batch(batch_dims, shape, seed):
    return _mixture(np.random.default_rng(seed), batch_dims + shape + (B,))


def _record_port(monkeypatch):
    """Every top-k input and every qint8 pack (input, wire) of the port."""
    fires, packs = [], []
    real_topk, real_pack = tsparse.ops.topk_compress, tquant.ops.qint8_pack

    def topk(x, k, **kw):
        fires.append((x.detach().clone(), k))
        return real_topk(x, k, **kw)

    def pack(x, block, **kw):
        w = real_pack(x, block, **kw)
        packs.append((x.detach().numpy().copy(), w.numpy().copy()))
        return w

    monkeypatch.setattr(tsparse.ops, "topk_compress", topk)
    monkeypatch.setattr(tquant.ops, "qint8_pack", pack)
    return fires, packs


def _record_jax_packs(monkeypatch):
    """Every qint8 pack (input, wire) of the reference, in execution order,
    from inside its jitted round (an ordered debug callback)."""
    packs = []
    real = jquant.ops.qint8_pack

    def pack(x, block, **kw):
        w = real(x, block, **kw)
        jax.debug.callback(
            lambda xx, ww: packs.append((np.asarray(xx), np.asarray(ww))),
            x, w, ordered=True)
        return w

    monkeypatch.setattr(jquant.ops, "qint8_pack", pack)
    return packs


def _check_wires(tpacks, jpacks, block):
    """The hazard rule of the module docstring; returns how many
    coordinates lay within DELTA of a half-integer."""
    assert len(tpacks) == len(jpacks) and tpacks
    near = total = 0
    for (tx, tw), (jx, jw) in zip(tpacks, jpacks):
        _close(tx, jx, what="pack input")
        assert tw.shape == jw.shape
        ts = tw[..., block:].copy().view(np.float32)
        js = jw[..., block:].copy().view(np.float32)
        _close(ts, js, rtol=RTOL, atol=0, what="block scales")
        rows, nb = jw.shape[:2]
        xb = np.zeros((rows, nb * block), np.float32)
        xb[:, :jx.shape[1]] = jx
        ratio = xb.reshape(rows, nb, block).astype(np.float64) / js
        frac = np.abs(ratio - np.floor(ratio) - 0.5)
        flagged = frac < DELTA
        diff = np.abs(tw[..., :block].astype(np.int32)
                      - jw[..., :block].astype(np.int32))
        assert (diff[~flagged] == 0).all(), "q differs off a rounding tie"
        assert (diff[flagged] <= 1).all()
        near += int(flagged.sum())
        total += flagged.size
    # about a 2 * DELTA share of uniform ratios lies that close to a tie;
    # a rule that flagged far more would hold the wire to nothing
    assert near <= 4 * DELTA * total, (near, total)
    return near


def _compare_states(ts, js, what):
    assert ts.step == int(js.step), what
    for a, b in zip(leaves(ts.params), jax.tree.leaves(js.params)):
        _close(a, b, what=f"{what} params")
    for a, b in zip(leaves(ts.opt_state), jax.tree.leaves(js.opt_state)):
        _close(a, b, what=f"{what} opt_state")
    jcs = js.comm_state or {}
    assert sorted(ts.comm_state or {}) == sorted(jcs), what
    for name, jst in jcs.items():
        tst = ts.comm_state[name]
        assert type(tst).__name__ == type(jst).__name__
        for part in ("ref", "err"):
            got, want = leaves(getattr(tst, part)), \
                jax.tree.leaves(getattr(jst, part))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                _close(a, b, what=f"{what} {name} {part}")
                if part == "err" and isinstance(jst, jsparse.EFState):
                    # the coordinates sent at the last fire are exactly
                    # the zeros of the residual
                    np.testing.assert_array_equal(
                        a.numpy() == 0, np.asarray(b) == 0,
                        err_msg=f"{what} {name} support")


def _q_lists(tstate, jstate, name):
    """Per-leaf (or per-bucket) warm-start Qs of both packages, in leaf
    order."""
    tq = flatten_up_to(flatten(tstate.params)[1], tstate.comm_state[name].q)\
        if isinstance(tstate.comm_state[name].q, dict) \
        else tstate.comm_state[name].q
    jq = jax.tree.structure(jstate.params).flatten_up_to(
        jstate.comm_state[name].q) \
        if isinstance(jstate.comm_state[name].q, dict) \
        else jstate.comm_state[name].q
    return tq, jq


_TRAIN = [
    ("local@2:qint8/global@4:topk:0.25", {}),
    ("local@2:qint8/global@4:topk:0.25", {"bucket_bytes": 256}),
    ("global@4:powersgd:2", {}),
    ("local@2/global@4:powersgd:2:bucketed", {}),
    ("local@2/global@4:powersgd:2:bucketed", {"bucket_bytes": 1024}),
]


@pytest.mark.parametrize("spec,kw", _TRAIN)
def test_trainer_matches_jax(spec, kw, monkeypatch):
    """Two rounds from one converted TrainState on the same numpy
    batches, with the default bucketing (overlap on) unless a smaller cap
    makes the layout multi-bucket."""
    fires, tpacks = _record_port(monkeypatch)
    jpacks = _record_jax_packs(monkeypatch)
    shape = (1, 2, 2)
    jhier, thier = JHier(plan=spec, **kw), HierAvgParams(plan=spec, **kw)
    assert thier.resolved_plan.describe() == jhier.resolved_plan.describe()
    jopt, topt = joptim.sgd(0.1, momentum=0.9), toptim.sgd(0.1, momentum=0.9)
    p_np = _mlp_init_np(1)
    jstate = jh.init_state(JTopo(*shape), lambda k: jax.tree.map(
        jnp.asarray, p_np), jopt, jax.random.PRNGKey(0), plan=spec, **kw)
    tstate = convert.train_state_from_jax(_np(jstate), device="cpu")
    _compare_states(tstate, jstate, "init")
    jround = jax.jit(jh.make_hier_round(jres.mlp_cls_loss, jopt, jhier))
    tround = th.make_hier_round(tres.mlp_cls_loss, topt, thier)
    for r in range(2):
        batch = _round_batch(thier.batch_dims, shape, seed=20 + r)
        jstate, jm = jround(jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        tstate, tm = tround(tstate, {k: _t(v) for k, v in batch.items()})
        _close(tm["loss"], jm["loss"], what=f"round {r} loss")
        _compare_states(tstate, jstate, f"round {r}")
    jax.effects_barrier()
    if "powersgd" in spec:
        for name in jstate.comm_state:
            for a, b in zip(*_q_lists(tstate, jstate, name)):
                if isinstance(b, tuple):
                    assert a == ()
                    continue
                # LAPACK (the reference's CPU QR) and CGS2 fix column
                # signs differently
                a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
                s = np.sign(np.sum(a * b, axis=-2, keepdims=True))
                _close(a * s, b, rtol=0, atol=RTOL * np.abs(b).max())
    if "qint8" in spec:
        near = _check_wires(tpacks, jpacks, 256)
        # local fires per round: 2, each over the layout's buckets
        assert len(tpacks) % 4 == 0
        print(f"qint8 coordinates within {DELTA} of a rounding tie: {near}")
    else:
        assert not tpacks
    if "topk" in spec:
        assert fires
        for delta, k in fires:
            mags = torch.sort(delta.abs(), dim=-1, descending=True).values
            if k < mags.shape[1]:
                # a k-th magnitude of exactly 0 is a tie among the zero
                # padding of a uniform bucket, broken by index in both
                # packages, which no rounding can move
                kth = mags[:, k - 1]
                assert ((kth - mags[:, k] > GAP) | (kth == 0)).all()
    else:
        assert not fires


@pytest.mark.parametrize("kw", [dict(reducer="topk:0.05"),
                                dict(reducer="qint8"),
                                dict(plan="local@2/global@8:powersgd:2"
                                          ":bucketed")])
def test_default_hier_params_train(kw):
    """Configs the port refused before it had the bucket engine build and
    train with the default bucket_bytes (pipelined), the eval loss
    falling."""
    from repro_torch.core.simulator import Simulator
    from repro_torch.data.synthetic import make_classification_task
    hier = HierAvgParams(**kw)
    assert hier.bucket_bytes == tcomm.DEFAULT_BUCKET_BYTES
    assert type(hier.resolved_plan.levels[-1].reducer).__name__ \
        == "Pipelined"
    sample = make_classification_task(16, 4, seed=11, noise=0.5,
                                      device="cpu")
    sim = Simulator(tres.mlp_cls_loss,
                    lambda g: tres.mlp_cls_init(g, MLP, device="cpu"),
                    sample, topo=HierTopology(1, 2, 2), hier=hier,
                    per_learner_batch=8, device="cpu",
                    eval_batch=sample(torch.Generator().manual_seed(1), 128))
    res = sim.run(4)
    assert np.isfinite(res.eval_losses).all()
    assert res.eval_losses[-1] < res.eval_losses[0]
