"""The port's Hier-AVG trainer against the JAX package's.

Every comparison starts both packages from the same numpy state and feeds
them the same numpy batches; reference outputs come from ``jax.jit`` (the
reference's own bit-identity contracts hold only under jit).  The port
runs on the CPU, where the sparse reducer's top-k takes its plain version.

Tolerances, fp32: model outputs, losses and gradients within 1e-5 of the
reference relative to the largest magnitude of each tensor (the two
frameworks sum in another order; ~1e-7 is what that costs).  Trained
params, optimizer and EF state within 1e-5 relative plus 1e-6 absolute
after the rounds compared.  Top-k selections have no tolerance: the zero
pattern of the EF residual (exactly the coordinates sent at the last
fire) must be identical after every fire, and every fire's gap between
the k-th and (k+1)-th magnitudes is asserted to be far above the noise,
so that a flipped index reads as a fault and not as rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import HierAvgParams as JHier  # noqa: E402
from repro.configs.resnet18_cifar import (CNNConfig,  # noqa: E402
                                          MLPConfig)
from repro.core import hier_avg as jh  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core.simulator import Simulator as JSimulator  # noqa: E402
from repro.core.topology import HierTopology as JTopo  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro import comm as jcomm  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.models import resnet as jres  # noqa: E402

from repro_torch import comm as tcomm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.comm import sparse as tsparse  # noqa: E402
from repro_torch.configs.base import HierAvgParams  # noqa: E402
from repro_torch.core import hier_avg as th  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.core.simulator import Simulator  # noqa: E402
from repro_torch.core.topology import HierTopology  # noqa: E402
from repro_torch.data.synthetic import make_classification_task  # noqa: E402
from repro_torch.models import resnet as tres  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

MLP = MLPConfig(in_dim=16, hidden=(32,), n_classes=4)
B = 4                                  # examples per learner per step
RTOL, ATOL = 1e-5, 1e-6
# every top-k fire's gap between the k-th and (k+1)-th magnitudes must
# exceed GAP; the round tests also assert that the packages' deltas differ
# by under GAP / 10, so a flipped index cannot be rounding
GAP = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, rtol=RTOL, atol=ATOL, what=""):
    a = np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


def _close_rel(a, b, rel=1e-5, what=""):
    """Within ``rel`` of the largest magnitude of the reference tensor."""
    b = np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    _close(a, b, rtol=0.0, atol=rel * scale, what=what)


def _mixture(rng, shape_lead, n_classes=4, in_dim=16):
    means = np.random.default_rng(7).standard_normal((n_classes, in_dim))
    means = 2.0 * means / np.linalg.norm(means, axis=-1, keepdims=True)
    y = rng.integers(0, n_classes, size=shape_lead).astype(np.int32)
    x = means[y] + 0.5 * rng.standard_normal(shape_lead + (in_dim,))
    return {"x": x.astype(np.float32), "y": y}


def _round_batch(batch_dims, shape, seed):
    return _mixture(np.random.default_rng(seed), batch_dims + shape + (B,))


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch_batch(b):
    return {k: _t(v) for k, v in b.items()}


_MLP_INIT = jax.jit(lambda k: jres.mlp_cls_init(k, MLP))


def _mlp_np_params(seed=0):
    return _np(_MLP_INIT(jax.random.PRNGKey(seed)))


# --------------------------------------------------------------------- #
# models


@pytest.mark.parametrize("width", [4, 6])
def test_resnet_matches_jax(width):
    """Logits, loss and every gradient leaf at depth (1, 1) on 8x8 inputs:
    stage 1 opens with a stride-2 block, so XLA's (0, 1) "SAME" padding is
    covered; width 6 makes GroupNorm lower its groups (8 -> 6 at 12
    channels)."""
    cfg = CNNConfig(width=width, depth_blocks=(1, 1), image_size=8)
    p_np = convert.tree_to_numpy(tres.resnet_init(
        torch.Generator().manual_seed(1), cfg, device="cpu"))
    rng = np.random.default_rng(2)
    batch = {"x": rng.standard_normal((3, 8, 8, 3)).astype(np.float32),
             "y": np.array([0, 3, 9], np.int32)}
    jp, jb = jax.tree.map(jnp.asarray, p_np), _jax_batch(batch)
    tp, tb = convert.tree_from_numpy(p_np, device="cpu"), _torch_batch(batch)

    logits = jax.jit(lambda p, x: jres.resnet_apply(p, x, cfg))(jp, jb["x"])
    _close_rel(tres.resnet_apply(tp, tb["x"], cfg), logits)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jres.resnet_loss(p, b, cfg), has_aux=True))(jp, jb)
    tg, tm = torch.func.grad(lambda p, b: tres.resnet_loss(p, b, cfg),
                             has_aux=True)(tp, tb)
    _close_rel(tm["loss"], jl)
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    jgl, tgl = jax.tree.leaves(jg), leaves(tg)
    assert len(jgl) == len(tgl) == len(jax.tree.leaves(jp))
    for i, (a, b) in enumerate(zip(tgl, jgl)):
        assert tuple(a.shape) == b.shape
        _close_rel(a, b, what=f"grad leaf {i}")


def test_resnet18_has_the_reference_leaves():
    """Full width: 55 leaves, 11,172,160 parameters, in the reference's
    leaf order and shapes (compared on shapes, nothing is run)."""
    cfg = CNNConfig(width=64)
    jshapes = [x.shape for x in jax.tree.leaves(jax.eval_shape(
        lambda k: jres.resnet_init(k, cfg), jax.random.PRNGKey(0)))]
    tp = tres.resnet_init(None, cfg, device="meta")
    tshapes = [tuple(x.shape) for x in leaves(tp)]
    assert tshapes == jshapes
    assert len(tshapes) == 55
    assert sum(int(np.prod(s)) for s in tshapes) == 11_172_160


def test_mlp_matches_jax():
    p_np = _mlp_np_params()
    batch = _mixture(np.random.default_rng(3), (6,))
    jp, jb = jax.tree.map(jnp.asarray, p_np), _jax_batch(batch)
    tp, tb = convert.tree_from_numpy(p_np, device="cpu"), _torch_batch(batch)
    _close_rel(tres.mlp_cls_apply(tp, tb["x"]),
               jax.jit(jres.mlp_cls_apply)(jp, jb["x"]))
    (jl, _), jg = jax.jit(jax.value_and_grad(
        jres.mlp_cls_loss, has_aux=True))(jp, jb)
    tg, tm = torch.func.grad(tres.mlp_cls_loss, has_aux=True)(tp, tb)
    _close_rel(tm["loss"], jl)
    for a, b in zip(leaves(tg), jax.tree.leaves(jg)):
        _close_rel(a, b)


# --------------------------------------------------------------------- #
# optimizers, schedules, clipping


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", {"momentum": 0.9}),
    ("sgd", {"momentum": 0.9, "nesterov": True, "weight_decay": 1e-2}),
    ("adamw", {"weight_decay": 1e-2})])
def test_optimizer_matches_jax(name, kw):
    p_np = _mlp_np_params()
    rng = np.random.default_rng(4)
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), p_np) for _ in range(3)]
    jopt = getattr(joptim, name)(0.05, **kw)
    topt = getattr(toptim, name)(0.05, **kw)
    jp, tp = jax.tree.map(jnp.asarray, p_np), \
        convert.tree_from_numpy(p_np, device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    upd = jax.jit(jopt.update)
    for step, g in enumerate(grads):
        jp, js = upd(jax.tree.map(jnp.asarray, g), jp, js,
                     jnp.asarray(step, jnp.int32))
        tp, ts = topt.update(convert.tree_from_numpy(g, device="cpu"), tp,
                             ts, step)
    for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
        _close(a, b)
    for a, b in zip(leaves(ts), jax.tree.leaves(js)):
        _close(a, b)


def test_schedules_and_clip_match_jax():
    pairs = [
        (joptim.constant_lr(0.1), toptim.constant_lr(0.1)),
        (joptim.step_decay_lr(0.1, [3, 6], [0.1, 0.01]),
         toptim.step_decay_lr(0.1, [3, 6], [0.1, 0.01])),
        (joptim.cosine_lr(0.1, 10), toptim.cosine_lr(0.1, 10)),
        (joptim.warmup_cosine_lr(0.1, 3, 10),
         toptim.warmup_cosine_lr(0.1, 3, 10))]
    for jf, tf in pairs:
        for step in range(12):
            want = float(jax.jit(jf)(jnp.asarray(step, jnp.int32)))
            assert tf(step) == pytest.approx(want, rel=1e-6, abs=1e-9)
    p_np = _mlp_np_params()
    jc, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, p_np), 0.5)
    tc, tn = toptim.clip_by_global_norm(
        convert.tree_from_numpy(p_np, device="cpu"), 0.5)
    _close(tn, jn)
    for a, b in zip(leaves(tc), jax.tree.leaves(jc)):
        _close(a, b)


# --------------------------------------------------------------------- #
# topology, reducers, plans


def test_topology_means_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 2, 5)).astype(np.float32)
    mask = rng.random((2, 3, 2)) < 0.6
    mask[1, 2] = False                      # a group with no survivor
    for axes in ((2,), (1, 2), (0, 1, 2)):
        want = jax.jit(lambda a, m: jtopo.average_over(
            {"w": a}, axes, mask=m)["w"])(jnp.asarray(x), jnp.asarray(mask))
        got = ttopo.average_over({"w": _t(x)}, axes, mask=_t(mask))["w"]
        _close(got, want)
        _close(ttopo.average_over({"w": _t(x)}, axes)["w"],
               jtopo.average_over({"w": jnp.asarray(x)}, axes)["w"])
    new, old = _t(x), _t(-x)
    sel = ttopo.where_active(_t(mask), {"w": new, "k": _t(np.ones(2))},
                             {"w": old, "k": _t(np.zeros(2))})
    want = jtopo.where_active(jnp.asarray(mask),
                              {"w": jnp.asarray(x), "k": jnp.ones(2)},
                              {"w": jnp.asarray(-x), "k": jnp.zeros(2)})
    _close(sel["w"], want["w"], rtol=0, atol=0)
    _close(sel["k"], want["k"], rtol=0, atol=0)


def test_stack_like_materialises_each_learner():
    """The reference's broadcast is a value; the port's copy must not be
    a view shared by the learners.  stack_distinct draws each learner's
    init in turn from one generator."""
    topo = HierTopology(1, 2, 2)
    s = ttopo.stack_like(topo, {"w": torch.ones(3)})["w"]
    assert s.shape == (1, 2, 2, 3) and s.stride()[2] != 0
    s[0, 0, 0].add_(1.0)
    assert float(s[0, 1, 1].sum()) == 3.0
    d = ttopo.stack_distinct(
        topo, lambda g: {"w": torch.randn(3, generator=g)},
        torch.Generator().manual_seed(0))["w"]
    g = torch.Generator().manual_seed(0)
    want = torch.stack([torch.randn(3, generator=g) for _ in range(4)])
    assert torch.equal(d, want.reshape(1, 2, 2, 3))


def test_round_batch_helpers_match_jax():
    topo, jt = HierTopology(2, 1, 2), JTopo(2, 1, 2)
    h, jhp = HierAvgParams(plan="local@2/pod@4/global@8"), \
        JHier(plan="local@2/pod@4/global@8")
    assert th.round_batch_shape(h, topo, 3) == \
        jh.round_batch_shape(jhp, jt, 3)
    flat = np.arange(8 * 4 * 3 * 2, dtype=np.float32).reshape(-1, 2)
    got = th.shard_round_batch({"x": _t(flat)}, h, topo)["x"]
    want = jh.shard_round_batch({"x": jnp.asarray(flat)}, jhp, jt)["x"]
    _close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("spec", [
    "mean", "cast", "cast:float16", "topk:0.05", "topk:0.1:perleaf",
    "topk:0.25:perleaf:serial", "mean:serial",
    "randk:0.1", "qint8", "powersgd:2", "topk:0.1:bucketed",
    "topk:0.1:pipelined"])
def test_reducer_specs_match_jax(spec):
    jr, tr = jcomm.get_reducer(spec), tcomm.get_reducer(spec)
    assert type(tr).__name__ == type(jr).__name__
    assert tr.describe() == jr.describe()
    assert tcomm.get_reducer(tr.describe()).describe() == jr.describe()
    for attr in ("stateful", "bucket_by_default", "bucket_opt_out",
                 "overlap_opt_out", "has_codec", "wants_matrix",
                 "codec_name"):
        assert getattr(tr, attr) == getattr(jr, attr), attr
    p_np = _mlp_np_params()
    tp = convert.tree_from_numpy(p_np, device="cpu")
    jp = jax.tree.map(jnp.asarray, p_np)
    for fn in ("payload_bytes", "wire_payload_bytes", "n_messages"):
        assert getattr(tr, fn)(tp) == getattr(jr, fn)(jp), fn
    inner = getattr(tr, "inner", tr)
    if spec.startswith("topk"):
        for n in (1, 3, 10, 50, 64, 1728, 2359296):
            assert inner.k_for(n) == getattr(jr, "inner", jr).k_for(n)


@pytest.mark.parametrize("spec", [
    "local@2/global@4", "local@2/pod@4/global@8",
    "local@4:cast:bfloat16:perleaf/pod@8/global@16:topk:0.05:perleaf",
    "global@3:topk:0.1:perleaf"])
def test_plan_parse_matches_jax(spec):
    jp, tp = jplan.ReductionPlan.parse(spec), tplan.ReductionPlan.parse(spec)
    assert tp.describe() == jp.describe()
    assert tp.batch_dims == jp.batch_dims
    assert tp.counts_per_round() == jp.counts_per_round()
    assert [lv.axes for lv in tp.levels] == [lv.axes for lv in jp.levels]
    h, jhp = HierAvgParams(plan=spec), JHier(plan=spec)
    assert (h.k1, h.k2, h.batch_dims) == (jhp.k1, jhp.k2, jhp.batch_dims)


def test_plan_backfills_k1_k2_and_refuses_the_bucket_engine():
    """The name predates the bucket engine: plans the reference buckets
    now resolve to the reference's engines (auto-wrapping, the pins, the
    demotion under overlap=False); only shards= still raises."""
    h = HierAvgParams(plan="local@2/pod@4/global@8")
    assert (h.k1, h.k2, h.beta, h.batch_dims) == (2, 8, 4, (2, 2, 2))
    cases = [dict(reducer="topk:0.05"), dict(reducer="qint8"),
             dict(plan="local@2/global@8:topk:0.05"),
             dict(plan="local@2/global@8:powersgd:2:bucketed"),
             dict(reducer="topk:0.05", bucket_bytes=0),
             dict(reducer="topk:0.05:perleaf"),
             dict(plan="local@2:qint8/global@8:topk:0.05", overlap=False),
             dict(plan="local@2:cast:serial/global@8:topk:0.05:pipelined",
                  overlap=False),
             dict(reducer="topk:0.05:bucketed", bucket_bytes=64)]
    for kw in cases:
        tp, jp = HierAvgParams(**kw).resolved_plan, JHier(**kw).resolved_plan
        assert tp.describe() == jp.describe(), kw
        assert tplan.resolve_plan(HierAvgParams(**kw)).describe() \
            == jplan.resolve_plan(JHier(**kw)).describe(), kw
        for a, b in zip(tp.levels, jp.levels):
            assert type(a.reducer).__name__ == type(b.reducer).__name__, kw
            assert getattr(a.reducer, "effective_bucket_bytes", None) \
                == getattr(b.reducer, "effective_bucket_bytes", None), kw
    for overlap in (True, False):
        resolved = tplan.resolve_plan(HierAvgParams(reducer="topk:0.25",
                                                    bucket_bytes=72))
        demoted = tplan.apply_bucketing(resolved, 72, overlap=overlap)
        jres_ = jplan.apply_bucketing(jplan.resolve_plan(
            JHier(reducer="topk:0.25", bucket_bytes=72)), 72,
            overlap=overlap)
        assert [type(lv.reducer).__name__ for lv in demoted.levels] \
            == [type(lv.reducer).__name__ for lv in jres_.levels]
    with pytest.raises(ValueError):
        HierAvgParams(plan="local@3/global@8")
    # a ShardPlan threads into every bucket engine (no longer refused)
    sp = _whole_grid_shards()
    sharded = tplan.apply_bucketing(h.resolved_plan, 64, shards=sp)
    assert all(lv.reducer.shards is sp for lv in sharded.levels
               if isinstance(lv.reducer, tcomm.Bucketed))
    assert tplan.apply_shards(sharded, None) is sharded


def _whole_grid_shards():
    from repro_torch.parallel.sharding import RankMesh, shard_plan
    return shard_plan(RankMesh((1, 2, 2, 2, 1), ("pod", "group", "local",
                                                 "fsdp", "model")))


def test_unported_trainer_options_raise():
    """``shards=`` and ``constraint_fn=`` are ported: on the whole
    (1, 2, 2, 2, 1) grid in one process (an unbound mesh) a mean round and
    a step through them equal the plain ones bit for bit (the learner mean
    is elementwise, so shard runs change nothing)."""
    from repro_torch.parallel.sharding import make_constraint_fn
    h = HierAvgParams(plan="local@2:mean:bucketed/global@4:mean:bucketed")
    loss, opt = tres.mlp_cls_loss, toptim.sgd(0.1)
    sp = _whole_grid_shards()
    topo = HierTopology(1, 2, 2)
    p_np = _mlp_np_params(1)
    init = lambda g: convert.tree_from_numpy(p_np, device="cpu")  # noqa
    batch = _torch_batch(_round_batch(h.batch_dims, topo.shape, seed=2))
    step_batch = tree_map(lambda x: x[0, 0], batch)
    plain = th.init_state(topo, init, opt, None, device="cpu")
    want, _ = th.make_hier_round(loss, opt, h)(plain, batch)
    want_s, _ = th.make_hier_step(loss, opt, h)(plain, step_batch)
    for kw in ({"shards": sp}, {"mesh": sp.mesh,
                                "constraint_fn": make_constraint_fn(sp.mesh)}):
        got, _ = th.make_hier_round(loss, opt, h, **kw)(plain, batch)
        got_s, _ = th.make_hier_step(loss, opt, h, **kw)(plain, step_batch)
        for a, b in zip(leaves(got.params), leaves(want.params)):
            assert torch.equal(a, b), kw
        for a, b in zip(leaves(got_s.params), leaves(want_s.params)):
            assert torch.equal(a, b), kw


@pytest.mark.parametrize("option", ["elastic", "telemetry", "faults",
                                    "sim_telemetry", "metrics",
                                    "comm_model"])
def test_trainer_options_run(option):
    """The round and Simulator options that came with elastic membership
    and telemetry: each runs on the CPU and shows in its output."""
    from repro_torch.core.theory import CommModel
    from repro_torch.telemetry import MetricsLogger
    topo = HierTopology(1, 2, 2)
    h = HierAvgParams(plan="local@2/global@4:topk:0.25", bucket_bytes=0)
    opt, loss = toptim.sgd(0.1), tres.mlp_cls_loss
    p_np = _mlp_np_params(6)
    init = lambda g: convert.tree_from_numpy(p_np, device="cpu")  # noqa
    batch = _torch_batch(_round_batch(h.batch_dims, topo.shape, seed=8))
    if option in ("elastic", "telemetry"):
        kw = {option: True}
        rnd = th.make_hier_round(loss, opt, h, **kw)
        s = th.init_state(topo, init, opt, None, plan=h.resolved_plan,
                          device="cpu")
        active = np.ones((2,) + topo.shape, bool)
        active[:, 0, 0, 0] = False
        s, m = rnd(s, batch, active) if option == "elastic" \
            else rnd(s, batch)
        if option == "elastic":
            assert float(m["active_frac/global"]) == 0.75
        else:
            assert "telemetry/div_pre/global" in m
        assert np.isfinite(float(m["loss"]))
        return
    sample = make_classification_task(16, 4, seed=11, noise=0.5,
                                      device="cpu")
    kw = {"faults": {"faults": "flaky:0.5"},
          "sim_telemetry": {"telemetry": True},
          "metrics": {"metrics": MetricsLogger()},
          "comm_model": {"comm_model": CommModel(fast_bw=1e9),
                         "faults": "straggler:0.5"}}[option]
    sim = Simulator(loss, init, sample, topo=topo, hier=h,
                    per_learner_batch=B, device="cpu", **kw)
    res = sim.run(2)
    assert np.isfinite(res.losses).all()
    if option == "faults":
        assert res.active_fracs.shape == (2, 2)
    elif option == "sim_telemetry":
        assert res.stats["telemetry/grad_sq_norm"].shape == (2,)
    elif option == "metrics":
        rows = list(kw["metrics"].rows("train_round"))
        assert [r["round"] for r in rows] == [0, 1]
        assert (res.measured_wall_s > 0).all()
    else:
        default = Simulator(loss, init, sample, topo=topo, hier=h,
                            faults="straggler:0.5", device="cpu")
        assert sim.faults.deadlines["global"] \
            > default.faults.deadlines["global"]
        assert sim.round_wall_estimate((1.0, 1.0)) \
            > default.round_wall_estimate((1.0, 1.0))


# --------------------------------------------------------------------- #
# the round


def _record_fires(monkeypatch):
    """Record every top-k call of the port's sparse reducer."""
    fires = []
    real = tsparse.ops.topk_compress

    def recording(x, k, **kw):
        fires.append((x.detach().clone(), k))
        return real(x, k, **kw)

    monkeypatch.setattr(tsparse.ops, "topk_compress", recording)
    return fires


def _assert_gaps(fires):
    """Each fire's k-th magnitude stands clear of the (k+1)-th."""
    assert fires
    for delta, k in fires:
        mags = torch.sort(delta.abs(), dim=-1, descending=True).values
        if k == mags.shape[1]:
            continue
        gap = mags[:, k - 1] - mags[:, k]
        assert (gap > GAP).all(), (gap, k)


def _compare_states(ts, js, what):
    assert ts.step == int(js.step), what
    for a, b in zip(leaves(ts.params), jax.tree.leaves(js.params)):
        _close(a, b, what=f"{what} params")
    for a, b in zip(leaves(ts.opt_state), jax.tree.leaves(js.opt_state)):
        _close(a, b, what=f"{what} opt_state")
    jcs = js.comm_state or {}
    assert sorted(ts.comm_state or {}) == sorted(jcs), what
    for name in jcs:
        tef, jef = ts.comm_state[name], jcs[name]
        for a, b in zip(leaves(tef.ref), jax.tree.leaves(jef.ref)):
            _close(a, b, what=f"{what} {name} ref")
        for a, b in zip(leaves(tef.err), jax.tree.leaves(jef.err)):
            _close(a, b, what=f"{what} {name} err")
            # the coordinates sent at the last fire: exactly the zeros;
            # the others hold the fire's delta, which must agree far
            # inside the gap every fire is held to
            np.testing.assert_array_equal(a.numpy() == 0,
                                          np.asarray(b) == 0,
                                          err_msg=f"{what} {name} support")
            assert np.abs(a.numpy() - np.asarray(b)).max() < GAP / 10


_PLANS = [
    ("plan", "local@2/global@4"),
    ("legacy", (2, 4)),
    ("plan", "local@2/pod@4/global@8"),
    ("plan", "local@2/global@4:topk:0.25"),
]


def _hier(pkg_hier, kind, spec):
    if kind == "legacy":
        return pkg_hier(k1=spec[0], k2=spec[1], bucket_bytes=0)
    return pkg_hier(plan=spec, bucket_bytes=0)


@pytest.mark.parametrize("shape", [(2, 1, 2), (1, 2, 2)])
@pytest.mark.parametrize("kind,spec", _PLANS)
def test_round_matches_jax(kind, spec, shape, monkeypatch):
    """Two rounds from the same converted TrainState on the same numpy
    round batches: metrics, params, momentum and EF ref/err agree; top-k
    supports agree exactly at every fire."""
    fires = _record_fires(monkeypatch)
    jhier, thier = _hier(JHier, kind, spec), _hier(HierAvgParams, kind, spec)
    jopt, topt = joptim.sgd(0.1, momentum=0.9), toptim.sgd(0.1, momentum=0.9)
    jstate = jh.init_state(JTopo(*shape),
                           lambda k: jres.mlp_cls_init(k, MLP), jopt,
                           jax.random.PRNGKey(0),
                           plan=None if kind == "legacy" else spec,
                           bucket_bytes=0)
    tstate = convert.train_state_from_jax(_np(jstate), device="cpu")
    _compare_states(tstate, jstate, "init")
    jround = jax.jit(jh.make_hier_round(jres.mlp_cls_loss, jopt, jhier))
    tround = th.make_hier_round(tres.mlp_cls_loss, topt, thier)
    n_fires = 0
    for r in range(2):
        batch = _round_batch(thier.batch_dims, shape, seed=10 + r)
        jstate, jm = jround(jstate, _jax_batch(batch))
        tstate, tm = tround(tstate, _torch_batch(batch))
        _close(tm["loss"], jm["loss"], what=f"round {r} loss")
        _close(tm["accuracy"], jm["accuracy"], what=f"round {r} accuracy")
        _compare_states(tstate, jstate, f"round {r}")
        if "topk" in str(spec):
            assert len(fires) == n_fires + 4    # one fire, four leaves
            n_fires = len(fires)
    if "topk" in str(spec):
        _assert_gaps(fires)
    else:
        assert not fires


@pytest.mark.parametrize("spec", ["local@2/global@4",
                                  "local@2/pod@4/global@8"])
def test_step_api_matches_round_api(spec):
    topo = HierTopology(2, 1, 2)
    h = HierAvgParams(plan=spec)
    opt = toptim.sgd(0.05)
    p_np = _mlp_np_params(3)
    init = lambda g: convert.tree_from_numpy(p_np, device="cpu")  # noqa: E731
    sa = th.init_state(topo, init, opt, None, device="cpu")
    sb = th.init_state(topo, init, opt, None, device="cpu")
    batch = _torch_batch(_round_batch(h.batch_dims, topo.shape, seed=4))
    sa, _ = th.make_hier_round(tres.mlp_cls_loss, opt, h)(sa, batch)
    step = th.make_hier_step(tres.mlp_cls_loss, opt, h)
    flat = tree_map(lambda x: x.reshape((h.steps_per_round,) + topo.shape
                                        + tuple(x.shape[len(h.batch_dims)
                                                        + 3:])), batch)
    for t in range(h.steps_per_round):
        sb, _ = step(sb, tree_map(lambda x: x[t], flat))
    assert sa.step == sb.step == h.steps_per_round
    for a, b in zip(leaves(sa.params), leaves(sb.params)):
        _close(a, b.numpy(), rtol=1e-5, atol=1e-5)


def test_microbatch_accumulation_matches_one_shot():
    topo = HierTopology(1, 2, 2)
    opt = toptim.sgd(0.1)
    p_np = _mlp_np_params(4)
    init = lambda g: convert.tree_from_numpy(p_np, device="cpu")  # noqa: E731
    s0 = th.init_state(topo, init, opt, None, device="cpu")
    batch = _torch_batch(_mixture(np.random.default_rng(6),
                                  topo.shape + (8,)))
    a, ma = th.make_sgd_step(tres.mlp_cls_loss, opt)(s0, batch)
    b, mb = th.make_sgd_step(tres.mlp_cls_loss, opt, microbatch=4)(s0, batch)
    _close(mb["loss"], ma["loss"].numpy())
    for x, y in zip(leaves(a.params), leaves(b.params)):
        _close(x, y.numpy())


# --------------------------------------------------------------------- #
# the simulator, the slice as a whole


def _injected(n_rounds, n, seed):
    """Round batches made with numpy, handed out in call order."""
    rng = np.random.default_rng(seed)
    return [_mixture(rng, (n,)) for _ in range(n_rounds)]


@pytest.mark.parametrize("algo,hier_kw,reducer", [
    ("hier", {"plan": "local@2/global@4:topk:0.25", "bucket_bytes": 0},
     None),
    ("kavg", {"k1": 2, "k2": 4}, "topk:0.25:perleaf"),
    ("hier", {"k1": 2, "k2": 4}, None),
    ("sync", {"k1": 2, "k2": 4}, None),
])
def test_simulator_matches_jax(algo, hier_kw, reducer, monkeypatch):
    fires = _record_fires(monkeypatch)
    shape, n_rounds = (1, 2, 2), 3
    p_np = _mlp_np_params(5)
    n = 4 * 4 * B
    eval_np = _mixture(np.random.default_rng(99), (64,))
    jb = iter(_injected(n_rounds, n, 9))
    tb = iter(_injected(n_rounds, n, 9))
    jsim = JSimulator(
        jres.mlp_cls_loss, lambda k: jax.tree.map(jnp.asarray, p_np),
        lambda k, m: _jax_batch(next(jb)), topo=JTopo(*shape),
        hier=JHier(**hier_kw), optimizer=joptim.sgd(0.1), algo=algo,
        per_learner_batch=B, eval_batch=_jax_batch(eval_np),
        reducer=reducer)
    tsim = Simulator(
        tres.mlp_cls_loss,
        lambda g: convert.tree_from_numpy(p_np, device="cpu"),
        lambda g, m: _torch_batch(next(tb)), topo=HierTopology(*shape),
        hier=HierAvgParams(**hier_kw), optimizer=toptim.sgd(0.1), algo=algo,
        per_learner_batch=B, eval_batch=_torch_batch(eval_np),
        reducer=reducer, device="cpu")
    assert tsim.plan.describe() == jsim.plan.describe()
    jr, tr = jsim.run(n_rounds), tsim.run(n_rounds)
    for f in ("losses", "accs", "eval_losses", "eval_accs"):
        _close(getattr(tr, f), getattr(jr, f), what=f)
    _close(tr.grad_sq_norms, jr.grad_sq_norms, rtol=1e-4, what="grad_sq")
    _compare_states(tr.state, jr.state, "final")
    assert tr.eval_losses[-1] < tr.eval_losses[0]
    if fires:
        _assert_gaps(fires)
    assert bool(fires) == (algo == "kavg" or "topk" in str(hier_kw))


def test_simulator_samples_from_its_generator_on_cpu():
    sample = make_classification_task(16, 4, seed=11, noise=0.5,
                                      device="cpu")
    b = sample(torch.Generator().manual_seed(0), 10)
    assert b["x"].shape == (10, 16) and b["x"].dtype == torch.float32
    assert b["y"].shape == (10,) and int(b["y"].max()) < 4
    sim = Simulator(tres.mlp_cls_loss,
                    lambda g: tres.mlp_cls_init(g, MLP, device="cpu"),
                    sample, topo=HierTopology(1, 2, 2),
                    hier=HierAvgParams(k1=2, k2=4), per_learner_batch=B,
                    eval_batch=sample(torch.Generator().manual_seed(1), 64),
                    device="cpu")
    a, b = sim.run(2), sim.run(2)
    np.testing.assert_array_equal(a.losses, b.losses)   # seeded
    assert np.isfinite(a.eval_losses).all()


def test_train_state_round_trip_is_exact():
    jstate = jh.init_state(JTopo(1, 2, 2),
                           lambda k: jres.mlp_cls_init(k, MLP),
                           joptim.sgd(0.1, momentum=0.9),
                           jax.random.PRNGKey(2),
                           plan="local@2/global@4:topk:0.25", bucket_bytes=0)
    np_state = _np(jstate)
    back = convert.train_state_to_numpy(
        convert.train_state_from_jax(np_state, device="cpu"))
    assert back.step == np_state.step
    for part in ("params", "opt_state"):
        for a, b in zip(jax.tree.leaves(getattr(back, part)),
                        jax.tree.leaves(getattr(np_state, part))):
            np.testing.assert_array_equal(a, b)
    ef, jef = back.comm_state["global"], np_state.comm_state["global"]
    for a, b in zip(jax.tree.leaves((ef.ref, ef.err)),
                    jax.tree.leaves((jef.ref, jef.err))):
        np.testing.assert_array_equal(a, b)
    # ref is its own buffer, never the params'
    ts = convert.train_state_from_jax(np_state, device="cpu")
    for p, r in zip(leaves(ts.params), leaves(ts.comm_state["global"].ref)):
        assert p.data_ptr() != r.data_ptr()


def test_ef_finalize_never_aliases_params():
    red = tsparse.TopKReducer(0.5)
    params = {"w": torch.randn(1, 2, 2, 6)}
    st = red.init_state(params)
    out, st = tcomm.reduce_with(
        red, lambda t, cf=None: ttopo.average_over(t, (0, 1, 2)), params, st)
    assert out["w"].data_ptr() != st.ref["w"].data_ptr()
