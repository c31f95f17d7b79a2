"""The port's elastic membership and checkpoints against the JAX package's.

Masked means, elastic rounds and steps, fault schedules, checkpoints and
fleet reshape.  Reference outputs come from ``jax.jit`` on the same numpy
states, batches and masks.

Exact (bit for bit): fault masks and their sha256 (across processes
too), straggler deadlines, an all-true mask against the dense round (per
leaf, bucketed and pipelined), a bucket's masked mean against its
leaves', an absent learner's params and EF across a missed fire, an
all-absent round against plain local SGD, checkpoints saved by either
package and loaded by the other (bf16 included), and reshape survivors.
At the trainer's fp32 tolerance (1e-5 relative plus 1e-6 absolute, as in
tests/test_torch_hier.py): elastic rounds, steps and Simulator runs under
random masks; top-k supports (the EF residual's zero pattern) exactly.
The port's pipelined rounds are held against the reference's serial
``Bucketed`` on the same uniform layout, since the reference's own
masked pipelined round fails its full-participation test.
"""
import hashlib
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import comm as jcomm  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.checkpoint import checkpoint as jck  # noqa: E402
from repro.configs.base import HierAvgParams as JHier  # noqa: E402
from repro.configs.resnet18_cifar import CNNConfig, MLPConfig  # noqa: E402
from repro.core import hier_avg as jh  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core.simulator import Simulator as JSimulator  # noqa: E402
from repro.core.theory import param_template as jtemplate  # noqa: E402
from repro.core.topology import HierTopology as JTopo  # noqa: E402
from repro import elastic as jel  # noqa: E402
from repro.models import resnet as jres  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.checkpoint import checkpoint as tck  # noqa: E402
from repro_torch.comm.bucket import BucketLayout  # noqa: E402
from repro_torch.comm.sparse import EFState  # noqa: E402
from repro_torch.configs.base import HierAvgParams  # noqa: E402
from repro_torch.core import hier_avg as th  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.core.simulator import (Simulator,  # noqa: E402
                                        run_algo_comparison)
from repro_torch.core.theory import param_template as ttemplate  # noqa: E402
from repro_torch.core.topology import HierTopology  # noqa: E402
from repro_torch import elastic as tel  # noqa: E402
from repro_torch.models import resnet as tres  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

MLP = MLPConfig(in_dim=16, hidden=(32,), n_classes=4)
B = 4
RTOL, ATOL = 1e-5, 1e-6
_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, what=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _equal_trees(a, b, what=""):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        assert torch.equal(x, y), what


def _mixture(rng, lead):
    means = np.random.default_rng(7).standard_normal((4, 16))
    means = 2.0 * means / np.linalg.norm(means, axis=-1, keepdims=True)
    y = rng.integers(0, 4, size=lead).astype(np.int32)
    x = means[y] + 0.5 * rng.standard_normal(lead + (16,))
    return {"x": x.astype(np.float32), "y": y}


def _mlp_np(seed=0):
    return _np(jax.jit(lambda k: jres.mlp_cls_init(k, MLP))(
        jax.random.PRNGKey(seed)))


def _masks(rng, n_levels, shape, p=0.35):
    """Random participation masks with a fully absent cluster when the
    grid has more than one."""
    m = rng.random((n_levels,) + shape) > p
    if shape[1] > 1:
        m[:, 0, -1] = False
    return m


# --------------------------------------------------------------------- #
# the masked mean


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_all_true_masked_mean_is_the_dense_mean_bit_for_bit(dtype):
    g = torch.Generator().manual_seed(0)
    shape = (2, 3, 3)
    tree = {"w": torch.randn(shape + (5, 7), generator=g).to(dtype),
            "b": torch.randn(shape + (11,), generator=g).to(dtype),
            "s": torch.randn(shape, generator=g).to(dtype)}
    ones = torch.ones(shape, dtype=torch.bool)
    for axes in ((2,), (1, 2), (0, 1, 2)):
        _equal_trees(ttopo.average_over(tree, axes, mask=ones),
                     ttopo.average_over(tree, axes), str(axes))


def test_a_buckets_masked_mean_equals_its_leaves_bit_for_bit():
    g = torch.Generator().manual_seed(1)
    shape = (1, 2, 4)
    tree = {"a": torch.randn(shape + (3, 5), generator=g),
            "b": torch.randn(shape + (7,), generator=g),
            "c": torch.randn(shape + (2, 2), generator=g)}
    mask = torch.tensor([[[1, 0, 1, 1], [0, 0, 0, 0]]], dtype=torch.bool)
    for uniform in (False, True):
        lay = BucketLayout.build(tree, bucket_bytes=64, lead_axes=3,
                                 uniform=uniform)
        assert lay.n_buckets > 1
        for axes in ((2,), (0, 1, 2)):
            per_leaf = ttopo.average_over(tree, axes, mask=mask)
            bucketed = lay.unpack(ttopo.average_over(lay.pack(tree), axes,
                                                     mask=mask))
            _equal_trees(bucketed, per_leaf, f"{axes} uniform={uniform}")


def test_masked_mean_matches_the_reference_and_its_edge_cases():
    rng = np.random.default_rng(2)
    shape = (2, 2, 3)
    x = rng.standard_normal(shape + (6,)).astype(np.float32)
    for trial in range(4):
        m = rng.random(shape) > 0.4
        m[1, 0] = False                         # a group with no survivor
        for axes in ((2,), (1, 2), (0, 1, 2)):
            want = jax.jit(lambda a, mm: jtopo.average_over(
                {"x": a}, axes, mask=mm)["x"])(jnp.asarray(x),
                                               jnp.asarray(m))
            got = ttopo.average_over({"x": _t(x)}, axes, mask=_t(m))["x"]
            _close(got, want, f"trial {trial} axes {axes}")
    # one survivor: exactly its values; no survivor: exactly 0, never NaN
    m = np.zeros(shape, bool)
    m[0, 1, 2] = True
    got = ttopo.average_over({"x": _t(x)}, (1, 2), mask=_t(m))["x"].numpy()
    np.testing.assert_array_equal(got[0], np.broadcast_to(x[0, 1, 2],
                                                          (2, 3, 6)))
    np.testing.assert_array_equal(got[1], 0.0)


def test_where_active_matches_the_reference():
    m = np.ones((1, 2, 2), bool)
    m[0, 0, 1] = False
    new = {"ef": np.arange(24, dtype=np.float32).reshape(1, 2, 4, 3),
           "p": np.arange(12, dtype=np.float32).reshape(1, 2, 2, 3),
           "key": np.array([1, 2], np.int64)}
    old = {"ef": np.zeros((1, 2, 4, 3), np.float32),
           "p": -np.ones((1, 2, 2, 3), np.float32),
           "key": np.array([9, 9], np.int64)}
    got = ttopo.where_active(_t(m), tree_map(_t, new), tree_map(_t, old))
    want = jtopo.where_active(jnp.asarray(m), new, old)
    for k in new:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# --------------------------------------------------------------------- #
# fault schedules

_DL = {"local": 0.5, "pod": 1.0, "global": 2.0}
_SPECS = ["crash:0.2", "flaky:0.3", "flaky:group:0.4:2", "flaky:pod:0.5:3",
          "straggler:0.5:1.0", "straggler:0.7:0.5@local",
          "flaky:1.0@global", "crash:0.1/flaky:pod:0.3:2/straggler:0.5:1.0"]


@pytest.mark.parametrize("spec", _SPECS)
def test_fault_masks_equal_the_reference(spec):
    levels = ("local", "pod", "global")
    for topo, seed in [((2, 2, 2), 3), ((1, 4, 4), 0), ((3, 1, 2), 11)]:
        t = tel.FaultSchedule(spec, HierTopology(*topo), levels, seed=seed,
                              deadlines=_DL)
        j = jel.FaultSchedule(spec, JTopo(*topo), levels, seed=seed,
                              deadlines=_DL)
        assert t.describe() == j.describe()
        for r in (7, 0, 3, 12, 0):
            a, b = t.active(r), j.active(r)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(t.active_frac(r), j.active_frac(r))
    assert [vars(c) for c in tel.parse_faults(spec)] \
        == [vars(c) for c in jel.parse_faults(spec)]


def test_fault_spec_errors_match_the_reference():
    for bad in ("bogus:0.5", "crash:1.5", "crash:-0.1", "crash", "",
                "flaky:0.2:0", "flaky:tower:0.2", "straggler"):
        with pytest.raises(ValueError):
            tel.parse_faults(bad)
        with pytest.raises(ValueError):
            jel.parse_faults(bad)
    with pytest.raises(ValueError, match="names level"):
        tel.FaultSchedule("crash:0.1@nosuch", HierTopology(1, 2, 2),
                          ("local", "global"))


_SHA_SPEC = "crash:0.1/flaky:pod:0.3:2/straggler:0.5:1.0"
_SHA_DL = {"local": 0.5, "global": 2.0}


def _sha(pkg):
    mod = tel if pkg == "port" else jel
    topo = (HierTopology if pkg == "port" else JTopo)(2, 2, 2)
    fs = mod.FaultSchedule(_SHA_SPEC, topo, ("local", "global"), seed=11,
                           deadlines=_SHA_DL)
    return hashlib.sha256(
        b"".join(fs.active(r).tobytes() for r in range(6))).hexdigest()


def test_mask_stream_sha256_equals_the_reference_across_processes():
    here = _sha("port")
    assert here == _sha("reference")
    child = (
        "import hashlib, json, sys\n"
        "from repro_torch.core.topology import HierTopology\n"
        "from repro_torch.elastic import FaultSchedule\n"
        "fs = FaultSchedule(%r, HierTopology(2, 2, 2),\n"
        "                   ('local', 'global'), seed=11, deadlines=%r)\n"
        "h = hashlib.sha256(\n"
        "    b''.join(fs.active(r).tobytes() for r in range(6)))\n"
        "print(json.dumps({'sha': h.hexdigest(),\n"
        "                  'jax': 'jax' in sys.modules}))\n"
        % (_SHA_SPEC, _SHA_DL))
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(_REPO, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", child], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out == {"sha": here, "jax": False}


@pytest.mark.parametrize("spec", ["local@2/global@8:topk:0.05",
                                  "local@2:qint8/pod@4/global@8:topk:0.05"])
def test_level_deadlines_equal_the_reference(spec):
    for bb, ov in ((0, True), (4096, True), (4096, False)):
        tp = tplan.apply_bucketing(tplan.ReductionPlan.parse(spec), bb, ov)
        jp = jplan.apply_bucketing(jplan.ReductionPlan.parse(spec), bb, ov)
        for shape in ((1, 4, 4), (2, 2, 2)):
            assert tel.level_deadlines(
                tp, HierTopology(*shape), ttemplate(1 << 18, "float32", 5)) \
                == jel.level_deadlines(
                    jp, JTopo(*shape), jtemplate(1 << 18, "float32", 5))


# --------------------------------------------------------------------- #
# elastic rounds and steps


def _serial_uniform(jp):
    """The reference's plan with every pipelined level on the serial
    ``Bucketed`` engine over the same uniform layout."""
    levels = []
    for lv in jp.levels:
        red = lv.reducer
        if type(red).__name__ == "Pipelined":
            red = jcomm.Bucketed(red.inner, red.bucket_bytes)
            red.uniform_layout = True
        levels.append(jplan.ReductionLevel(lv.name, lv.axes, lv.period, red))
    return jplan.ReductionPlan(tuple(levels))


def _compare_states(ts, js, what):
    assert ts.step == int(js.step), what
    for a, b in zip(leaves(ts.params), jax.tree.leaves(js.params)):
        _close(a, b, f"{what} params")
    for a, b in zip(leaves(ts.opt_state), jax.tree.leaves(js.opt_state)):
        _close(a, b, f"{what} opt_state")
    for name in sorted(js.comm_state or {}):
        tef, jef = ts.comm_state[name], js.comm_state[name]
        for a, b in zip(leaves(tef.ref), jax.tree.leaves(jef.ref)):
            _close(a, b, f"{what} {name} ref")
        for a, b in zip(leaves(tef.err), jax.tree.leaves(jef.err)):
            _close(a, b, f"{what} {name} err")
            np.testing.assert_array_equal(a.numpy() == 0, np.asarray(b) == 0,
                                          err_msg=f"{what} {name} support")


_ELASTIC = [
    ("local@2/global@4:topk:0.25", {"bucket_bytes": 0}, (1, 2, 2), False),
    ("local@2/global@4:topk:0.25", {"bucket_bytes": 512, "overlap": False},
     (1, 2, 2), False),
    ("local@2/global@4:topk:0.25", {"bucket_bytes": 512}, (1, 2, 2), False),
    ("local@2:qint8/global@4:topk:0.25", {"bucket_bytes": 512}, (1, 2, 2),
     False),
    ("local@2/pod@4/global@8", {}, (2, 2, 2), True),
]


@pytest.mark.parametrize("spec,kw,shape,sync", _ELASTIC)
def test_elastic_round_matches_the_reference(spec, kw, shape, sync):
    """Two masked rounds from one converted state (momentum, and with
    ``sync_opt_state`` the optimizer state masked too): metrics,
    params, momentum and EF against the reference under jit."""
    rng = np.random.default_rng(3)
    jhier, thier = JHier(plan=spec, **kw), HierAvgParams(plan=spec, **kw)
    jp = _serial_uniform(jhier.resolved_plan)
    jopt, topt = joptim.sgd(0.1, momentum=0.9), toptim.sgd(0.1, momentum=0.9)
    p_np = _mlp_np(1)
    jstate = jh.init_state(JTopo(*shape), lambda k: jax.tree.map(
        jnp.asarray, p_np), jopt, jax.random.PRNGKey(0), plan=jp)
    tstate = convert.train_state_from_jax(_np(jstate), device="cpu")
    jround = jax.jit(jh.make_hier_round(jres.mlp_cls_loss, jopt, jhier,
                                        plan=jp, elastic=True,
                                        sync_opt_state=sync))
    tround = th.make_hier_round(tres.mlp_cls_loss, topt, thier, elastic=True,
                                sync_opt_state=sync)
    n_levels = len(jp.levels)
    for r in range(2):
        batch = _mixture(rng, thier.batch_dims + shape + (B,))
        m = _masks(rng, n_levels, shape)
        jstate, jm = jround(jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()},
                            jnp.asarray(m))
        tstate, tm = tround(tstate, {k: _t(v) for k, v in batch.items()}, m)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            _close(tm[k], jm[k], f"round {r} {k}")
        _compare_states(tstate, jstate, f"round {r}")


def test_elastic_round_on_a_small_resnet_matches_the_reference():
    cfg = CNNConfig(width=4, depth_blocks=(1, 1), image_size=8)
    shape, spec = (1, 2, 2), "local@2/global@4:topk:0.25"
    rng = np.random.default_rng(4)
    p_np = _np(jax.jit(lambda k: jres.resnet_init(k, cfg))(
        jax.random.PRNGKey(2)))
    jhier, thier = (JHier(plan=spec, bucket_bytes=0),
                    HierAvgParams(plan=spec, bucket_bytes=0))
    jstate = jh.init_state(JTopo(*shape), lambda k: jax.tree.map(
        jnp.asarray, p_np), joptim.sgd(0.05), jax.random.PRNGKey(0),
        plan=spec, bucket_bytes=0)
    tstate = convert.train_state_from_jax(_np(jstate), device="cpu")
    jround = jax.jit(jh.make_hier_round(
        lambda p, b: jres.resnet_loss(p, b, cfg), joptim.sgd(0.05), jhier,
        elastic=True))
    tround = th.make_hier_round(lambda p, b: tres.resnet_loss(p, b, cfg),
                                toptim.sgd(0.05), thier, elastic=True)
    lead = thier.batch_dims + shape + (2,)
    batch = {"x": rng.standard_normal(lead + (8, 8, 3)).astype(np.float32),
             "y": rng.integers(0, cfg.n_classes, lead).astype(np.int32)}
    m = _masks(rng, 2, shape, p=0.4)
    jstate, jm = jround(jstate, jax.tree.map(jnp.asarray, batch),
                        jnp.asarray(m))
    tstate, tm = tround(tstate, tree_map(_t, batch), _t(m))
    _close(tm["loss"], jm["loss"], "loss")
    _compare_states(tstate, jstate, "resnet")


_FULL = [("local@2/global@4:topk:0.25", {"bucket_bytes": 0}, False),
         ("local@2/global@4:topk:0.25", {"bucket_bytes": 512,
                                         "overlap": False}, False),
         ("local@2:qint8/global@4:topk:0.25", {"bucket_bytes": 512}, False),
         ("local@2:cast:bfloat16/global@4:randk:0.25", {"bucket_bytes": 512},
          False),
         ("local@2/global@4:powersgd:2", {}, True)]


@pytest.mark.parametrize("spec,kw,sync", _FULL)
def test_all_true_elastic_round_is_the_dense_round_bit_for_bit(spec, kw,
                                                               sync):
    """Per leaf, serial buckets and pipelined buckets (qint8, cast bf16,
    random-k, PowerSGD): losses, params, momentum and every comm-state
    leaf bit for bit.  Control: one learner out must differ."""
    shape = (1, 2, 2)
    hier = HierAvgParams(plan=spec, **kw)
    opt = toptim.sgd(0.1, momentum=0.9)
    p_np = _mlp_np(2)

    def init():
        return th.init_state(HierTopology(*shape), lambda g: convert
                             .tree_from_numpy(p_np, device="cpu"), opt, None,
                             plan=hier.resolved_plan, device="cpu")

    dense = th.make_hier_round(tres.mlp_cls_loss, opt, hier,
                               sync_opt_state=sync)
    masked = th.make_hier_round(tres.mlp_cls_loss, opt, hier, elastic=True,
                                sync_opt_state=sync)
    rng = np.random.default_rng(5)
    batches = [tree_map(_t, _mixture(rng, hier.batch_dims + shape + (B,)))
               for _ in range(2)]
    ones = np.ones((len(hier.resolved_plan.levels),) + shape, bool)
    out = {}
    for name, fn, mask in [("dense", dense, None), ("all", masked, ones),
                           ("one_out", masked, ~np.eye(1, ones.size,
                                                       dtype=bool)
                            .reshape(ones.shape))]:
        s, losses = init(), []
        for b in batches:
            s, m = fn(s, b) if mask is None else fn(s, b, mask)
            losses.append(m["loss"])
        out[name] = (s, torch.stack(losses))
    (sd, ld), (sa, la), (so, lo) = out["dense"], out["all"], out["one_out"]
    assert torch.equal(ld, la)
    _equal_trees((sd.params, sd.opt_state, sd.comm_state),
                 (sa.params, sa.opt_state, sa.comm_state), spec)
    assert not all(torch.equal(a, b) for a, b in
                   zip(leaves(sd.params), leaves(so.params)))


def test_all_absent_round_is_local_sgd_and_ef_survives_a_missed_fire():
    shape = (1, 2, 2)
    opt = toptim.sgd(0.05)
    p_np = _mlp_np(3)
    init = lambda g: convert.tree_from_numpy(p_np, device="cpu")  # noqa
    rng = np.random.default_rng(6)
    batch = tree_map(_t, _mixture(rng, (2,) + shape + (8,)))
    # all absent: per-learner SGD, bit for bit, and active_frac 0
    h = HierAvgParams(plan="global@2:mean")
    rnd = th.make_hier_round(tres.mlp_cls_loss, opt, h, elastic=True)
    s = th.init_state(HierTopology(*shape), init, opt, None,
                      plan=h.resolved_plan, device="cpu")
    out, m = rnd(s, batch, np.zeros((1,) + shape, bool))
    assert float(m["active_frac/global"]) == 0.0
    step = th.make_sgd_step(tres.mlp_cls_loss, opt)
    ref = s
    for t in range(2):
        ref, _ = step(ref, tree_map(lambda x: x[t], batch))
    _equal_trees(out.params, ref.params, "all-absent != local SGD")
    # one learner misses the fire: its EF and params are exactly local
    h = HierAvgParams(plan="global@2:topk:0.25", bucket_bytes=0)
    rnd = th.make_hier_round(tres.mlp_cls_loss, opt, h, elastic=True)
    s = th.init_state(HierTopology(*shape), init, opt, None,
                      plan=h.resolved_plan, device="cpu")
    active = np.ones((1,) + shape, bool)
    active[0, 0, 0, 0] = False
    out, _ = rnd(s, batch, active)
    changed = False
    for b4, af in zip(leaves(s.comm_state["global"].err),
                      leaves(out.comm_state["global"].err)):
        assert torch.equal(af[0, 0, 0], b4[0, 0, 0])
        changed = changed or not torch.equal(af[0, 0, 1], b4[0, 0, 1])
    assert changed
    for p_out, p_ref in zip(leaves(out.params), leaves(ref.params)):
        assert torch.equal(p_out[0, 0, 0], p_ref[0, 0, 0])
        assert torch.equal(p_out[0, 0, 1], p_out[0, 1, 1])


def test_elastic_step_matches_the_reference():
    shape, spec = (1, 2, 2), "local@2/global@4:topk:0.25"
    rng = np.random.default_rng(7)
    p_np = _mlp_np(4)
    jstate = jh.init_state(JTopo(*shape), lambda k: jax.tree.map(
        jnp.asarray, p_np), joptim.sgd(0.1), jax.random.PRNGKey(0),
        plan=spec, bucket_bytes=0)
    tstate = convert.train_state_from_jax(_np(jstate), device="cpu")
    jstep = jax.jit(jh.make_hier_step(
        jres.mlp_cls_loss, joptim.sgd(0.1),
        JHier(plan=spec, bucket_bytes=0), elastic=True))
    tstep = th.make_hier_step(tres.mlp_cls_loss, toptim.sgd(0.1),
                              HierAvgParams(plan=spec, bucket_bytes=0),
                              elastic=True)
    for t in range(5):
        b = _mixture(rng, shape + (B,))
        m = _masks(rng, 2, shape)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b),
                           jnp.asarray(m))
        tstate, tm = tstep(tstate, tree_map(_t, b), _t(m))
        _close(tm["loss"], jm["loss"], f"step {t}")
        _compare_states(tstate, jstate, f"step {t}")
    with pytest.raises(ValueError, match="active mask"):
        tstep(tstate, tree_map(_t, b))


def test_simulator_with_faults_matches_the_reference():
    shape, n_rounds = (1, 2, 2), 4
    hier_kw = {"plan": "local@2/global@4:topk:0.25", "bucket_bytes": 0}
    spec = "crash:0.2/flaky:group:0.3:2/straggler:0.5:1.5"
    p_np = _mlp_np(5)
    n = 4 * 4 * B
    batches = [_mixture(np.random.default_rng(9 + r), (n,))
               for r in range(n_rounds)]
    jb, tb = iter(batches), iter(batches)
    jsim = JSimulator(jres.mlp_cls_loss, lambda k: jax.tree.map(
        jnp.asarray, p_np), lambda k, m: jax.tree.map(jnp.asarray, next(jb)),
        topo=JTopo(*shape), hier=JHier(**hier_kw),
        optimizer=joptim.sgd(0.1), per_learner_batch=B, faults=spec)
    tsim = Simulator(tres.mlp_cls_loss, lambda g: convert.tree_from_numpy(
        p_np, device="cpu"), lambda g, m: tree_map(_t, next(tb)),
        topo=HierTopology(*shape), hier=HierAvgParams(**hier_kw),
        optimizer=toptim.sgd(0.1), per_learner_batch=B, faults=spec,
        device="cpu")
    assert tsim.faults.deadlines == jsim.faults.deadlines
    jr, tr = jsim.run(n_rounds), tsim.run(n_rounds)
    np.testing.assert_array_equal(tr.active_fracs, jr.active_fracs)
    np.testing.assert_array_equal(tr.round_wall_s, jr.round_wall_s)
    assert (tr.active_fracs < 1).any() and (tr.active_fracs > 0).any()
    _close(tr.losses, jr.losses, "losses")
    _compare_states(tr.state, jr.state, "final")
    with pytest.raises(ValueError, match="elastic"):
        Simulator(tres.mlp_cls_loss, None, None, topo=HierTopology(*shape),
                  hier=HierAvgParams(), algo="kavg", faults=spec,
                  device="cpu")
    res = run_algo_comparison(
        tres.mlp_cls_loss, lambda g: convert.tree_from_numpy(
            p_np, device="cpu"),
        lambda g, m: tree_map(_t, _mixture(np.random.default_rng(1), (m,))),
        None, variants={"faulty": {"topo": HierTopology(*shape),
                                   "hier": HierAvgParams(**hier_kw),
                                   "faults": spec}},
        n_rounds=2, per_learner_batch=B, device="cpu")
    np.testing.assert_array_equal(res["faulty"].active_fracs,
                                  jr.active_fracs[:2])


# --------------------------------------------------------------------- #
# checkpoints


def _bits(x):
    """A saved array's bytes, whatever numpy made of its dtype."""
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.uint8).tobytes()


def _mixed_tree_np():
    rng = np.random.default_rng(8)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "h": {"bf": rng.standard_normal((5,)).astype(np.float32),
                  "i": np.arange(6, dtype=np.int32).reshape(2, 3)},
            "seq": [rng.standard_normal((2,)).astype(np.float32),
                    np.array(7, np.int32)]}


def test_checkpoints_cross_load_between_packages(tmp_path):
    """A tree with fp32, bf16 and int32 leaves in dicts and lists:
    the reference's save loads in the port and the port's in the
    reference, bit for bit, with identical manifests.  (The reference's
    own restore refuses its bf16 leaves, so the reference side reads
    them through load_checkpoint.)"""
    t_np = _mixed_tree_np()
    jtree = jax.tree.map(jnp.asarray, t_np)
    jtree["h"]["bf"] = jtree["h"]["bf"].astype(jnp.bfloat16)
    ttree = convert.tree_from_numpy(t_np, device="cpu")
    ttree["h"]["bf"] = ttree["h"]["bf"].to(torch.bfloat16)
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jck.save_checkpoint(jdir, jtree, step=3, metadata={"a": 1})
    tck.save_checkpoint(tdir, ttree, step=3, metadata={"a": 1})
    with open(os.path.join(jdir, "manifest.json")) as f:
        jman = json.load(f)
    with open(os.path.join(tdir, "manifest.json")) as f:
        tman = json.load(f)
    assert tman == jman
    assert tck.checkpoint_step(jdir) == jck.checkpoint_step(tdir) == 3
    ja, ta = jck.load_checkpoint(jdir), tck.load_checkpoint(tdir)
    assert sorted(ja) == sorted(ta)
    for k in ja:
        assert ja[k].shape == ta[k].shape and _bits(ja[k]) == _bits(ta[k]), k
    # the port restores both, bf16 included
    for d in (jdir, tdir):
        got = tck.restore_checkpoint(d, ttree)
        _equal_trees(got, ttree, d)
        assert got["h"]["bf"].dtype == torch.bfloat16
    # the reference restores the port's fp32/int tree
    del t_np["h"]["bf"], jtree["h"]["bf"], ttree["h"]["bf"]
    tck.save_checkpoint(tdir + "2", ttree, step=1)
    got = jck.restore_checkpoint(tdir + "2", jtree)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("spec", ["local@2/global@4", "global@4:topk:0.25"])
def test_train_state_checkpoints_cross_load(spec, tmp_path):
    """A whole TrainState (momentum, step, EF state): the same leaf paths
    (``.params/...``, ``.comm_state/global/.err/0``) and arrays in both
    packages' files.  Dense states restore across in both directions; an
    EF state's RNG carry is the port's own (int64[3] against a JAX key),
    so there only the arrays are compared."""
    shape = (1, 2, 2)
    jopt = joptim.sgd(0.1, momentum=0.9)
    js = jh.init_state(JTopo(*shape), lambda k: jres.mlp_cls_init(k, MLP),
                       jopt, jax.random.PRNGKey(1), plan=spec,
                       bucket_bytes=0)
    js = js._replace(step=jnp.int32(5))
    ts = convert.train_state_from_jax(_np(js), device="cpu")
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jck.save_checkpoint(jdir, js, step=5)
    tck.save_checkpoint(tdir, ts, step=5)
    ja, ta = jck.load_checkpoint(jdir), tck.load_checkpoint(tdir)
    assert sorted(ja) == sorted(ta)
    assert ".step" in ta and ".params/w/0" in ta
    for k in ja:
        if k.endswith("/.key"):
            continue
        assert ja[k].dtype == ta[k].dtype and _bits(ja[k]) == _bits(ta[k]), k
    if "topk" in spec:
        assert ".comm_state/global/.err/w/0" in ta
        return
    back = tck.restore_checkpoint(jdir, ts)
    assert back.step == 5
    _equal_trees((back.params, back.opt_state), (ts.params, ts.opt_state))
    jback = jck.restore_checkpoint(tdir, js)
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_restore_refuses_drift_and_names_elastic_restore(tmp_path):
    topo = HierTopology(1, 2, 2)
    opt = toptim.sgd(0.05)
    init = lambda g: tres.mlp_cls_init(g, MLP, device="cpu")  # noqa: E731
    g = torch.Generator().manual_seed(0)
    state = th.init_state(topo, init, opt, g, device="cpu")
    d = str(tmp_path / "ck")
    tel.save_elastic_checkpoint(d, state, topo)
    like = th.init_state(HierTopology(1, 3, 2), init, opt, g, device="cpu")
    with pytest.raises(ValueError, match="learner-count mismatch") as ei:
        tck.restore_checkpoint(d, like)
    msg = str(ei.value)
    assert "(1, 2, 2)" in msg and "(1, 3, 2)" in msg
    assert "4 learners" in msg and "elastic_restore" in msg
    bad = state._replace(params=tree_map(lambda x: x.double(), state.params))
    with pytest.raises(ValueError, match="dtype mismatch"):
        tck.restore_checkpoint(d, bad)
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    man["entries"][0]["shape"] = [9]
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match="corrupt checkpoint"):
        tck.restore_checkpoint(d, state)


# --------------------------------------------------------------------- #
# fleet reshape


def test_learner_index_map_equals_the_reference():
    old, new = (1, 2, 2), (1, 3, 2)
    for a, b, kw in [(old, new, {}), (new, old, {}),
                     (old, new, {"survivors": [3, 1], "donor": 3})]:
        got = tel.learner_index_map(HierTopology(*a), HierTopology(*b), **kw)
        want = jel.learner_index_map(JTopo(*a), JTopo(*b), **kw)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
    for bad in ({"survivors": [0, 0]}, {"survivors": [7]},
                {"survivors": list(range(5))}, {"survivors": []}):
        with pytest.raises(ValueError):
            tel.learner_index_map(HierTopology(*old), HierTopology(*old),
                                  **bad)


def test_checkpointed_reshape_round_trip_bit_preserves(tmp_path):
    """Grow 4 -> 6 learners and shrink back: survivors' params and EF
    bit for bit, joiners clone the donor with a zero residual."""
    old_topo, new_topo = HierTopology(1, 2, 2), HierTopology(1, 3, 2)
    hier = HierAvgParams(plan="global@2:topk:0.25", bucket_bytes=0)
    sample = lambda g, n: tree_map(  # noqa: E731
        _t, _mixture(np.random.default_rng(int(n)), (n,)))
    init = lambda g: tres.mlp_cls_init(g, MLP, device="cpu")  # noqa: E731
    sim = Simulator(tres.mlp_cls_loss, init, sample, topo=old_topo,
                    hier=hier, optimizer=toptim.sgd(0.05), seed=13,
                    per_learner_batch=8, device="cpu")
    state = sim.run(2).state
    d4 = str(tmp_path / "fleet4")
    tel.save_elastic_checkpoint(d4, state, old_topo, step=2, plan=sim.plan)
    assert tel.checkpoint_topology(d4) == old_topo
    like6 = th.init_state(new_topo, init, toptim.sgd(0.05),
                          torch.Generator().manual_seed(9),
                          plan=sim.plan, device="cpu")
    got6 = tel.elastic_restore(d4, like6, new_topo=new_topo)
    for o, n in zip(leaves(state.params), leaves(got6.params)):
        o, n = o.reshape((4,) + o.shape[3:]), n.reshape((6,) + n.shape[3:])
        assert torch.equal(n[:4], o) and torch.equal(n[4], o[0])
    for e4, e6 in zip(leaves(state.comm_state["global"].err),
                      leaves(got6.comm_state["global"].err)):
        e4, e6 = e4.reshape((4,) + e4.shape[3:]), \
            e6.reshape((6,) + e6.shape[3:])
        assert torch.equal(e6[:4], e4) and not e6[4:].any()
    d6 = str(tmp_path / "fleet6")
    tel.save_elastic_checkpoint(d6, got6, new_topo, step=2, plan=sim.plan)
    like4 = th.init_state(old_topo, init, toptim.sgd(0.05),
                          torch.Generator().manual_seed(8), plan=sim.plan,
                          device="cpu")
    back = tel.elastic_restore(d6, like4, new_topo=old_topo)
    _equal_trees((back.params, back.comm_state),
                 (state.params, state.comm_state), "round trip")
    # in memory: the same gather
    mem = tel.reshape_state(state, old_topo, new_topo, plan=sim.plan)
    _equal_trees(mem.params, got6.params)
    _equal_trees(mem.comm_state["global"].err, got6.comm_state["global"].err)


def test_elastic_restore_of_a_reference_checkpoint(tmp_path):
    """The reference saves a 4-learner state; both packages restore it
    onto 6 learners and onto (1, 1, 2) with chosen survivors, equally."""
    old_topo = (1, 2, 2)
    jopt = joptim.sgd(0.1, momentum=0.9)
    js = jh.init_state(JTopo(*old_topo), lambda k: jres.mlp_cls_init(k, MLP),
                       jopt, jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    js = js._replace(params=jax.tree.map(lambda x: x + jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32)), js.params))
    d = str(tmp_path / "ref")
    jel.save_elastic_checkpoint(d, js, JTopo(*old_topo), step=4)
    for new, kw in [((1, 3, 2), {}), ((1, 1, 2), {"survivors": [2, 0]})]:
        jlike = jh.init_state(JTopo(*new), lambda k: jres.mlp_cls_init(
            k, MLP), jopt, jax.random.PRNGKey(4))
        tlike = convert.train_state_from_jax(_np(jlike), device="cpu")
        want = jel.elastic_restore(d, jlike, new_topo=JTopo(*new), **kw)
        got = tel.elastic_restore(d, tlike, new_topo=HierTopology(*new),
                                  **kw)
        for a, b in zip(leaves((got.params, got.opt_state)),
                        jax.tree.leaves((want.params, want.opt_state))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_reshape_drops_codec_view_state_with_a_warning():
    old_topo, new_topo = HierTopology(1, 2, 2), HierTopology(1, 3, 2)
    cs = {"global": EFState(ref=[torch.ones(1, 2, 4, 7)],
                            err=[torch.zeros(1, 2, 4, 7)],
                            key=torch.zeros(3, dtype=torch.int64))}
    src, joiner = tel.learner_index_map(old_topo, new_topo)
    with pytest.warns(tel.CommStateDropWarning, match="global"):
        out = tel.reshape_comm_state(cs, old_topo, new_topo, src, joiner)
    assert out["global"] == ()
    ok = {"global": EFState(ref=[torch.ones(1, 2, 2, 7)],
                            err=[torch.ones(1, 2, 2, 7)],
                            key=torch.zeros(3, dtype=torch.int64))}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = tel.reshape_comm_state(ok, old_topo, new_topo, src, joiner)
    assert out["global"].err[0].shape == (1, 3, 2, 7)
    assert not out["global"].err[0][0, 2].any()
