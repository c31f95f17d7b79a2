"""The port's theory, schedules and cost model against the JAX package's.

Everything here is plain float arithmetic on the same inputs, so the
comparison is exact: every bound, every LevelCost field and every
modeled wall must equal the reference's to the last bit.  Templates are
the port's meta tensors against the reference's ShapeDtypeStructs.
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import HierAvgParams as JHier  # noqa: E402
from repro.configs.resnet18_cifar import MLPConfig  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core import schedules as jsch  # noqa: E402
from repro.core import theory as jth  # noqa: E402
from repro.core.simulator import Simulator as JSimulator  # noqa: E402
from repro.core.topology import HierTopology as JTopo  # noqa: E402
from repro.models import resnet as jres  # noqa: E402

from repro_torch.configs.base import HierAvgParams  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import schedules as tsch  # noqa: E402
from repro_torch.core import theory as tth  # noqa: E402
from repro_torch.core.simulator import Simulator, init_template  # noqa: E402
from repro_torch.core.topology import HierTopology  # noqa: E402
from repro_torch.models import resnet as tres  # noqa: E402

MLP = MLPConfig(in_dim=16, hidden=(32,), n_classes=4)

_PLANS = [
    "local@2/global@8",
    "local@2:cast:bfloat16/global@8:topk:0.05",
    "local@2:qint8/global@8:topk:0.05",
    "local@2/global@8:powersgd:2",
    "local@2/global@8:powersgd:2:bucketed",
    "local@2/global@8:randk:0.1",
    "local@4:cast:bfloat16/pod@8/global@16:topk:0.05",
]
_SHAPES = [(1, 4, 4), (2, 2, 2), (1, 1, 1)]


def test_theorem_functions_equal_the_reference():
    grid = itertools.product((0.5, 5.0), (1.0, 2.5), (0.01, 0.05),
                             (1, 4, 16), (1, 4), (2, 16))
    for F, L, gamma, K2, K1, S in grid:
        P, B, T, N = 16, 32, 1 << 20, 64
        for name, args in [
                ("thm31_bound", (F, L, 1.0, 0.5, gamma, K2, P, B, T)),
                ("thm31_rate_at_optimum", (F, L, 1.0, 0.5, P, B, T)),
                ("third_term_poly", (K2, K1, S)),
                ("thm32_bound", (F, L, 1.0, gamma, K1, K2, S, P, B, N)),
                ("thm32_condition", (L, gamma, K2)),
                ("thm34_terms", (F, L, 1.0, gamma, T, P, B)),
                ("thm34_condition", (F, L, 1.0, gamma, T, P, B, S)),
                ("thm34_objective", (K2, K1, S, F, 0.1 * L, gamma)),
                ("optimal_k2", (K1, S, F, 0.1 * L, gamma)),
                ("thm36_hier_bound", (K2, 0.5, F, gamma)),
                ("thm36_kavg_bound", (K2, F, gamma)),
                ("comm_per_k2_steps", (4e6 * F, K1, K2 * K1, P, S)),
                ("comm_advantage", (4e6 * F, K2, 0.5, P, S))]:
            assert getattr(tth, name)(*args) == getattr(jth, name)(*args), \
                (name, args)
    for n, p in itertools.product((1, 2, 8, 16), (-0.5, 0.0, 0.3, 1.0, 2.0)):
        assert tth.effective_participants(n, p) \
            == jth.effective_participants(n, p)
    for args in [(0.5, 0.25, 1, False), (0.5, 0.25, 4, True),
                 (0.1, 0.9, 7, True), (0.1, 0.9, 7, False)]:
        assert tth.scheduled_wall(*args) == jth.scheduled_wall(*args)
    for axes, pods in [((0, 1, 2), 2), ((0, 1, 2), 1), ((1, 2), 2), ((2,), 4)]:
        assert tth.tier_for(axes, pods) == jth.tier_for(axes, pods)


def test_comm_model_defaults_and_codec_rates_equal_the_reference():
    assert dataclasses.asdict(tth.CommModel()) \
        == dataclasses.asdict(jth.CommModel())
    kw = {"codec_bw": [["topk", 3e10], ["qint8", 9e10]], "fast_bw": 1e11}
    t, j = tth.CommModel(**kw), jth.CommModel(**kw)
    assert t.codec_bw == j.codec_bw
    for codec in ("topk", "qint8", "powersgd", "", None):
        assert t.compress_bw_for(codec) == j.compress_bw_for(codec)
    for b, n in [(1e6, 1), (1e6, 4), (3.3e7, 2.5), (8.0, 16)]:
        assert t.allreduce_time(b, n, 2.5e9) == j.allreduce_time(b, n, 2.5e9)


def test_param_template_is_meta_with_the_reference_shapes():
    for n, dtype, leaves_ in [(1 << 16, "bfloat16", 1), (1000, "float32", 3),
                              (12345, "float32", 4)]:
        t = tth.param_template(n, dtype, n_leaves=leaves_)
        j = jth.param_template(n, dtype, n_leaves=leaves_)
        assert sorted(t) == sorted(j)
        for k in t:
            assert t[k].device.type == "meta"
            assert tuple(t[k].shape) == tuple(j[k].shape)
            assert str(t[k].dtype).replace("torch.", "") == str(j[k].dtype)


def _templates():
    """(name, port template, reference template) pairs: synthetic
    matrices and the MLP's real parameter tree."""
    out = [(f"synthetic{n}", tth.param_template(1 << 16, "float32", n),
            jth.param_template(1 << 16, "float32", n)) for n in (1, 4)]
    out.append(("mlp", init_template(
        lambda g: tres.mlp_cls_init(g, MLP, device="cpu"), "cpu"),
        jax.eval_shape(lambda k: jres.mlp_cls_init(k, MLP),
                       jax.ShapeDtypeStruct((2,), jnp.uint32))))
    return out


@pytest.mark.parametrize("spec", _PLANS)
def test_plan_comm_per_round_equals_the_reference(spec):
    """Every LevelCost field of every level, over topologies, templates,
    bucketing (off, serial, pipelined), drop probabilities and a
    calibrated model: equal to the reference's bit for bit."""
    cms = [None, (tth.CommModel(fast_bw=1e11, codec_bw=(("topk", 3e10),)),
                  jth.CommModel(fast_bw=1e11, codec_bw=(("topk", 3e10),)))]
    for (name, ttmpl, jtmpl), shape, (bb, ov), cm, drop in itertools.product(
            _templates(), _SHAPES, [(0, True), (1 << 12, False),
                                    (1 << 12, True)],
            cms, (0.0, 0.3, {"global": 0.5})):
        tp = tplan.apply_bucketing(tplan.ReductionPlan.parse(spec), bb, ov)
        jp = jplan.apply_bucketing(jplan.ReductionPlan.parse(spec), bb, ov)
        assert tp.describe() == jp.describe()
        tc, jc = (cm if cm else (None, None))
        got = tth.plan_comm_per_round(tp, HierTopology(*shape), ttmpl, tc,
                                      drop_prob=drop)
        want = jth.plan_comm_per_round(jp, JTopo(*shape), jtmpl, jc,
                                       drop_prob=drop)
        assert [dataclasses.asdict(c) for c in got] \
            == [dataclasses.asdict(c) for c in want], (name, shape, bb, ov)
        for tl, jl in zip(tp.levels, jp.levels):
            assert tth.level_reduction_seconds(
                tl, HierTopology(*shape), ttmpl, tc, drop_prob=0.25) \
                == jth.level_reduction_seconds(
                    jl, JTopo(*shape), jtmpl, jc, drop_prob=0.25)


def test_schedules_equal_the_reference():
    for T, P, B in itertools.product((1 << 10, 1 << 20, 1 << 30), (1, 16),
                                     (8, 32)):
        assert tsch.thm31_k2(T, P, B) == jsch.thm31_k2(T, P, B)
        assert tsch.thm31_gamma(P, B, T) == jsch.thm31_gamma(P, B, T)
    losses = [2.0, 1.9, 1.2, 0.9, 0.51, 0.3, 0.12, 0.05, 0.01, 1e-12]
    for spec, outer_min in [("local@2/global@32", None),
                            ("local@2/pod@4/global@64", 8),
                            ("global@16", None)]:
        t, j = tsch.AdaptivePlan(spec, outer_min), \
            jsch.AdaptivePlan(spec, outer_min)
        assert (t.outer_max, t.inner, t.outer_min) \
            == (j.outer_max, j.inner, j.outer_min)
        for loss in losses:
            assert t.plan_for(loss).describe() == j.plan_for(loss).describe()
            base = HierAvgParams(bucket_bytes=0, overlap=False)
            jbase = JHier(bucket_bytes=0, overlap=False)
            assert dataclasses.asdict(t.params_for(loss, base)) \
                == dataclasses.asdict(j.params_for(loss, jbase))
        t.reset()
        j.reset()
        assert t.outer_for(0.5) == j.outer_for(0.5)
    for k1, k2_max, k2_min in [(2, 32, None), (3, 31, 7), (4, 4, None)]:
        t, j = tsch.AdaptiveK2(k1, k2_max, k2_min), \
            jsch.AdaptiveK2(k1, k2_max, k2_min)
        assert [t.k2_for(x) for x in losses] == [j.k2_for(x) for x in losses]
        assert dataclasses.asdict(t.params_for(0.3)) \
            == dataclasses.asdict(j.params_for(0.3))
    with pytest.raises(ValueError):
        tsch.AdaptivePlan("local@4/global@16", outer_min=6)


@pytest.mark.parametrize("spec", ["local@2/global@4:topk:0.25",
                                  "local@2:qint8/global@4:powersgd:2",
                                  "local@2/pod@4/global@8"])
def test_simulator_cost_methods_equal_the_reference(spec):
    """payload_bytes_per_reduction, payload_bytes_per_level and
    round_wall_estimate (memoized) on the MLP, built without allocating
    a parameter."""
    topo = (2, 2, 2)
    jsim = JSimulator(jres.mlp_cls_loss, lambda k: jres.mlp_cls_init(k, MLP),
                      None, topo=JTopo(*topo), hier=JHier(plan=spec))
    tsim = Simulator(tres.mlp_cls_loss,
                     lambda g: tres.mlp_cls_init(g, MLP, device="cpu"),
                     None, topo=HierTopology(*topo),
                     hier=HierAvgParams(plan=spec), device="cpu")
    assert tsim.payload_bytes_per_reduction() \
        == jsim.payload_bytes_per_reduction()
    assert tsim.payload_bytes_per_level() == jsim.payload_bytes_per_level()
    n = len(tsim.plan.levels)
    for fracs in [(1.0,) * n, (0.5,) * n, tuple(np.linspace(0.25, 1, n)),
                  (1.0,) * n]:
        assert tsim.round_wall_estimate(fracs) \
            == jsim.round_wall_estimate(fracs)
    assert len(tsim._wall_cache) == 3
