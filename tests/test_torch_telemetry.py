"""The port's telemetry against the JAX package's.

Row schemas and the JSONL sink are copies and must write what the
reference writes; the Chrome-trace export carries the profiler's time
origin, and the round's spans (telemetry/spans.py) nest as the round
runs and change nothing.  The device-side statistics
(gradstats) are held to the reference under ``jax.jit`` exactly on
integer inputs in [-2, 2] over power-of-two learner groups (every sum,
mean and square is then exact in fp32, in any order) and within 1e-6
relative on Gaussian ones (the two frameworks sum in another order).  Telemetry is a
pure observer: a telemetry-on round equals the telemetry-off round bit
for bit in losses, params and EF state, on every engine.
"""
import gzip
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro import telemetry as jtel  # noqa: E402
from repro.comm.sparse import EFState as JEF  # noqa: E402
from repro.configs.base import HierAvgParams as JHier  # noqa: E402
from repro.configs.resnet18_cifar import MLPConfig  # noqa: E402
from repro.core import hier_avg as jh  # noqa: E402
from repro.core.simulator import Simulator as JSimulator  # noqa: E402
from repro.core.topology import HierTopology as JTopo  # noqa: E402
from repro.models import resnet as jres  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch import telemetry as ttel  # noqa: E402
from repro_torch.comm.sparse import EFState  # noqa: E402
from repro_torch.configs.base import HierAvgParams  # noqa: E402
from repro_torch.core import hier_avg as th  # noqa: E402
from repro_torch.core.simulator import Simulator  # noqa: E402
from repro_torch.core.topology import HierTopology  # noqa: E402
from repro_torch.models import resnet as tres  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

MLP = MLPConfig(in_dim=16, hidden=(32,), n_classes=4)
B = 4


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mixture(rng, lead):
    means = np.random.default_rng(7).standard_normal((4, 16))
    means = 2.0 * means / np.linalg.norm(means, axis=-1, keepdims=True)
    y = rng.integers(0, 4, size=lead).astype(np.int32)
    x = means[y] + 0.5 * rng.standard_normal(lead + (16,))
    return {"x": x.astype(np.float32), "y": y}


def _mlp_np(seed=0):
    return _np(jax.jit(lambda k: jres.mlp_cls_init(k, MLP))(
        jax.random.PRNGKey(seed)))


# --------------------------------------------------------------------- #
# rows and spans


def test_row_schemas_equal_the_reference():
    assert ttel.SCHEMA_VERSION == jtel.SCHEMA_VERSION == 1
    assert ttel.ROW_SCHEMAS == jtel.ROW_SCHEMAS


def _log(mod, path):
    with mod.MetricsLogger(path, ring=4, flush_every=2) as m:
        for r in range(5):
            m.log_row("train_round", round=r, loss=float("nan") if r == 1
                      else 0.5 / (r + 1), wall_s=0.01 * r,
                      extra=np.float32(3.0), active_frac={"global": 0.5})
            m.count("train/rounds")
            m.histogram("train/round_wall_s", 0.01 * r)
        m.log_row("serve_summary", engine="paged", requests=1, tokens=2,
                  decode_steps=1, wall_s=0.1, tokens_per_s=20.0,
                  wasted_ratio=0.0, refill_events=0, peak_pages_in_use=0)
        m.gauge("train/loss", 0.25)
        rows = [r["round"] for r in m.rows("train_round")]
        return m.snapshot(), rows


def test_metrics_logger_writes_the_references_jsonl(tmp_path):
    tp, jp = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    assert _log(ttel, tp) == _log(jtel, jp)
    with open(tp) as a, open(jp) as b:
        assert a.read() == b.read()
    assert ttel.validate_jsonl(jp) == jtel.validate_jsonl(tp)
    with pytest.raises(ValueError, match="missing required keys"):
        ttel.MetricsLogger().log_row("train_round", round=0)
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        f.write(json.dumps({"subsystem": "train_round",
                            "schema_version": 1, "round": 0}) + "\n")
    with pytest.raises(ValueError, match="missing"):
        ttel.validate_jsonl(bad)


def test_chrome_trace_nests_and_the_profiler_writes_its_trace(tmp_path):
    prof = str(tmp_path / "prof")
    tracer = ttel.SpanTracer(profile_dir=prof)
    tracer.start_profiler()
    x = torch.ones(8, 8)
    for r in range(2):
        with tracer.span(f"round[{r}]"):
            with tracer.span("device", cat="device"):
                y = (x * x).sum()
                tracer.fence({"y": y})
            with tracer.span("host_sync"):
                float(y)
    tracer.stop_profiler()
    path = str(tmp_path / "trace.json")
    tracer.export_chrome_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert len(events) == 6
    rounds = [e for e in events if e["name"].startswith("round")]
    assert rounds[0]["ts"] <= rounds[1]["ts"]
    for c in events:
        if c not in rounds:
            assert any(p["ts"] <= c["ts"]
                       and c["ts"] + c["dur"] <= p["ts"] + p["dur"] + 1
                       for p in rounds), c
    # measured spans only
    assert {e["cat"] for e in events} == {"host", "device"}
    # the profiler's own trace, with the span annotations in it, on the
    # same time origin
    with gzip.open(os.path.join(prof, "trace.json.gz"), "rt") as fh:
        pdoc = json.load(fh)
    names = {e.get("name") for e in pdoc["traceEvents"]}
    assert {"round[0]", "round[1]", "device", "host_sync"} <= names
    assert doc["baseTimeNanoseconds"] == pdoc["baseTimeNanoseconds"]


# --------------------------------------------------------------------- #
# spans inside the round

_SPAN_PLAN = "local@2/global@4:topk:0.1"
_SPAN_ENGINES = {"perleaf": {"bucket_bytes": 0},
                 "pipelined": {"bucket_bytes": 512, "overlap": True}}
_SHAPE = (1, 2, 2)


def _span_setup(engine):
    """A two-level top-k round on the MLP, its state and two batches."""
    hier = HierAvgParams(plan=_SPAN_PLAN, **_SPAN_ENGINES[engine])
    opt = toptim.sgd(0.1, momentum=0.9)
    params = convert.tree_from_numpy(_mlp_np(3), device="cpu")
    state = th.init_state(HierTopology(*_SHAPE), lambda g: params, opt,
                          None, plan=hier.resolved_plan, device="cpu")
    rng = np.random.default_rng(4)
    batches = [tree_map(_t, _mixture(rng, hier.batch_dims + _SHAPE + (B,)))
               for _ in range(2)]
    return hier, opt, state, batches


def _run(rnd, state, batches):
    for b in batches:
        state, _ = rnd(state, b)
    return state


def _annotations(prof, tmp_path):
    """(name, start, end) in us of the profiler's user annotations."""
    path = str(tmp_path / "prof.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(child, parents):
    return [p for p in parents
            if p[1] <= child[1] and child[2] <= p[2] + 1e-2]


def _profiled(engine, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    hier, opt, state, batches = _span_setup(engine)
    rnd = th.make_hier_round(tres.mlp_cls_loss, opt, hier)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state = _run(rnd, state, batches[:1])
    state = _run(rnd, state, batches[1:])
    return hier, state, _annotations(prof, tmp_path)


@pytest.mark.parametrize("engine", sorted(_SPAN_ENGINES))
def test_round_spans_nest_under_the_profiler(engine, tmp_path):
    """One round under a CPU profiler session: one ``hier.round``, a
    ``hier.step`` a step, the plan's count of fires a level, every step
    and fire inside the round and every codec stage inside a fire; the
    pipelined engine opens the stages once a bucket."""
    hier, _, spans = _profiled(engine, tmp_path)
    by = {}
    for s in spans:
        by.setdefault(s[0], []).append(s)
    assert len(by["hier.round"]) == 1
    assert len(by["hier.step"]) == hier.steps_per_round == 4
    assert len(by["hier.fire.local"]) == 2
    assert len(by["hier.fire.global"]) == 1
    fires = by["hier.fire.local"] + by["hier.fire.global"]
    for s in by["hier.step"] + fires:
        assert _inside(s, by["hier.round"]), s
    stages = ("comm.compress", "comm.decompress", "comm.mean",
              "comm.finalize")
    assert set(by) == {"hier.round", "hier.step", "hier.fire.local",
                       "hier.fire.global"} | set(stages)
    for name in stages:
        for s in by[name]:
            assert len(_inside(s, fires)) == 1, s
    # the local mean: one serial pass a fire; the global top-k: one a
    # fire per leaf, one a bucket pipelined
    glob = hier.resolved_plan.levels[1].reducer
    units = 1
    if engine == "pipelined":
        units = glob.layout_for(_span_setup(engine)[2].params).n_buckets
        assert units > 2
    for name in stages:
        got = [s for s in by[name] if _inside(s, by["hier.fire.global"])]
        assert len(got) == units, (name, len(got))
        assert len(by[name]) == units + 2


class _Forbidden:
    def __init__(self, *a, **k):
        raise AssertionError("record_function entered with no profiler")


@pytest.mark.parametrize("engine", sorted(_SPAN_ENGINES))
def test_spans_cost_no_record_function_and_change_nothing(engine, tmp_path,
                                                          monkeypatch):
    """With no profiler session and no tracer the round enters no
    ``record_function``, and neither does an installed tracer without a
    session; both rounds equal the profiled one bit for bit, and the
    tracer records the profiler's spans."""
    from repro_torch.telemetry import spans as tspans
    hier, want, annotated = _profiled(engine, tmp_path)
    monkeypatch.setattr(torch.profiler, "record_function", _Forbidden)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _Forbidden)
    _, opt, state, batches = _span_setup(engine)
    rnd = th.make_hier_round(tres.mlp_cls_loss, opt, hier)
    bare = _run(rnd, state, batches)
    tracer = ttel.SpanTracer()
    with tspans.installed(tracer):
        traced = _run(rnd, state, batches[:1])
    traced = _run(rnd, traced, batches[1:])
    assert tspans._TRACER is None
    for got in (bare, traced):
        for x, y in zip(leaves((want.params, want.opt_state,
                                want.comm_state)),
                        leaves((got.params, got.opt_state, got.comm_state))):
            assert torch.equal(x, y)
    assert sorted(s["name"] for s in tracer.spans) \
        == sorted(s[0] for s in annotated)


def test_step_api_fires_carry_the_level_name():
    """``make_hier_step`` opens the same fire spans as the round (a
    level fires alone when the next one does not), each around its
    codec stages."""
    from repro_torch.telemetry import spans as tspans
    hier, opt, state, batches = _span_setup("perleaf")
    step = th.make_hier_step(tres.mlp_cls_loss, opt, hier)
    tracer = ttel.SpanTracer()
    flat = tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])),
                    batches[0])
    with tspans.installed(tracer):
        for t in range(4):
            state, _ = step(state, tree_map(lambda x: x[t], flat))
    fires = [s for s in tracer.spans if s["name"].startswith("hier.fire")]
    assert [s["name"] for s in fires] == ["hier.fire.local",
                                          "hier.fire.global"]
    assert all(s["depth"] == 0 for s in fires)
    stages = [s for s in tracer.spans if s["name"].startswith("comm.")]
    assert len(stages) == 8 and all(s["depth"] == 1 for s in stages)


def test_tracer_and_profiler_spans_share_a_clock(tmp_path):
    """A tracer span and the profiler's annotation of it start within
    1 ms of each other in the two exported files."""
    prof = str(tmp_path / "prof")
    tracer = ttel.SpanTracer(profile_dir=prof)
    tracer.start_profiler()
    x = torch.ones(64, 64)
    for _ in range(3):
        with tracer.span("probe"):
            (x @ x).sum()
    tracer.stop_profiler()
    path = str(tmp_path / "trace.json")
    tracer.export_chrome_trace(path)
    with open(path) as fh:
        mine = [e["ts"] for e in json.load(fh)["traceEvents"]
                if e.get("name") == "probe"]
    with gzip.open(os.path.join(prof, "trace.json.gz"), "rt") as fh:
        theirs = [e["ts"] for e in json.load(fh)["traceEvents"]
                  if e.get("name") == "probe"
                  and e.get("cat") == "user_annotation"]
    assert len(mine) == len(theirs) == 3
    for a, b in zip(sorted(mine), sorted(theirs)):
        assert abs(a - b) < 1e3, (a, b)


# --------------------------------------------------------------------- #
# gradstats


class _Lvl:
    def __init__(self, name, axes, stateful):
        self.name, self.axes = name, axes
        self.reducer = type("R", (), {"stateful": stateful})()


def _inputs(kind, seed):
    rng = np.random.default_rng(seed)
    shape = (2, 2, 2)

    def draw(s):
        if kind == "integer":
            return rng.integers(-2, 3, size=s).astype(np.float32)
        return rng.standard_normal(s).astype(np.float32)

    return {"w": draw(shape + (3, 5)), "b": draw(shape + (7,)),
            "s": draw(shape)}


@pytest.mark.parametrize("kind", ["integer", "gaussian"])
def test_gradstats_equal_the_reference(kind):
    pre, post = _inputs(kind, 0), _inputs(kind, 1)
    err = _inputs(kind, 2)
    levels = [_Lvl("local", (2,), True), _Lvl("pod", (1, 2), False),
              _Lvl("global", (0, 1, 2), True)]
    cfg_t, cfg_j = ttel.TelemetryConfig(), jtel.TelemetryConfig()
    key = np.array([1, 2], np.uint32)
    j_cs = {lv.name: JEF(ref=pre, err=err, key=key) for lv in levels}
    t_cs = {lv.name: EFState(ref=tree_map(_t, pre), err=tree_map(_t, err),
                             key=torch.zeros(3, dtype=torch.int64))
            for lv in levels}
    got, want = {}, {}
    for lv in levels:
        got.update(ttel.level_stats(cfg_t, lv, tree_map(_t, pre),
                                    tree_map(_t, post), t_cs))
        want.update(jax.jit(lambda a, b, c, lv=lv: jtel.level_stats(
            cfg_j, lv, a, b, c))(pre, post, j_cs))
    got.update(ttel.make_grad_observer(cfg_t, levels)(tree_map(_t, pre)))
    want.update(jax.jit(jtel.make_grad_observer(cfg_j, levels))(pre))
    assert sorted(got) == sorted(want) and len(got) == 3 * 3 + 2 + 1 + 3
    # a state without .err: its float leaves count, its int leaves not
    st = {"q": _t(pre["w"]), "n": torch.arange(3)}
    got["ef_mass"] = ttel.ef_mass(st)
    want["ef_mass"] = jtel.ef_mass({"q": jnp.asarray(pre["w"]),
                                    "n": jnp.arange(3)})
    for k in want:
        g, w = float(got[k]), float(want[k])
        if kind == "integer":
            assert g == w, (k, g, w)
        else:
            assert abs(g - w) <= 1e-6 * max(abs(w), 1e-30), (k, g, w)
    assert ttel.make_grad_observer(ttel.TelemetryConfig(grad_var=False),
                                   levels) is None


def test_resolve_telemetry():
    assert ttel.resolve_telemetry(None) is None
    assert ttel.resolve_telemetry(False) is None
    assert ttel.resolve_telemetry(True) == ttel.TelemetryConfig()
    cfg = ttel.TelemetryConfig(divergence=False)
    assert ttel.resolve_telemetry(cfg) is cfg
    with pytest.raises(TypeError):
        ttel.resolve_telemetry("yes")


# --------------------------------------------------------------------- #
# telemetry in the round


_ENGINES = [("local@2/pod@4/global@8:topk:0.25", {"bucket_bytes": 0}),
            ("local@2/pod@4/global@8:topk:0.25",
             {"bucket_bytes": 512, "overlap": False}),
            ("local@2:qint8/global@4:topk:0.25", {"bucket_bytes": 512}),
            ("local@2/global@4:powersgd:2", {})]


@pytest.mark.parametrize("spec,kw", _ENGINES)
def test_telemetry_on_is_bit_identical_and_matches_the_reference(spec, kw):
    """Per leaf, serial and pipelined buckets, PowerSGD, dense and
    elastic: losses, params, momentum and EF with telemetry on equal
    telemetry off bit for bit; the stats match the reference's under
    jit."""
    shape = (2, 2, 2) if "pod" in spec else (1, 2, 2)
    thier, jhier = HierAvgParams(plan=spec, **kw), JHier(plan=spec, **kw)
    topt, jopt = toptim.sgd(0.1, momentum=0.9), joptim.sgd(0.1, momentum=0.9)
    p_np = _mlp_np(1)
    jstate = jh.init_state(JTopo(*shape), lambda k: jax.tree.map(
        jnp.asarray, p_np), jopt, jax.random.PRNGKey(0),
        plan=jhier.resolved_plan)
    rng = np.random.default_rng(2)
    batches = [_mixture(rng, thier.batch_dims + shape + (B,))
               for _ in range(2)]
    n_levels = len(thier.resolved_plan.levels)
    masks = [rng.random((n_levels,) + shape) > 0.3 for _ in batches]
    for elastic in (False, True):
        runs = {}
        for tel in (None, True):
            rnd = th.make_hier_round(tres.mlp_cls_loss, topt, thier,
                                     telemetry=tel, elastic=elastic)
            s = convert.train_state_from_jax(_np(jstate), device="cpu")
            out = []
            for b, m in zip(batches, masks):
                args = (m,) if elastic else ()
                s, met = rnd(s, tree_map(_t, b), *args)
                out.append(met)
            runs[tel] = (s, out)
        (s0, m0), (s1, m1) = runs[None], runs[True]
        for a, b in zip(m0, m1):
            assert torch.equal(a["loss"], b["loss"])
            assert not [k for k in a if k.startswith("telemetry/")]
        for x, y in zip(leaves((s0.params, s0.opt_state, s0.comm_state)),
                        leaves((s1.params, s1.opt_state, s1.comm_state))):
            assert torch.equal(x, y)
        if elastic:
            continue
        jround = jax.jit(jh.make_hier_round(jres.mlp_cls_loss, jopt, jhier,
                                            telemetry=True))
        js = jstate
        for b, tm in zip(batches, m1):
            js, jm = jround(js, jax.tree.map(jnp.asarray, b))
            assert sorted(tm) == sorted(jm)
            for k in jm:
                g, w = float(tm[k]), float(jm[k])
                assert abs(g - w) <= 1e-5 * abs(w) + 1e-6, (k, g, w)


def test_simulator_telemetry_rows_and_stats_match_the_reference(tmp_path):
    shape, n_rounds = (1, 2, 2), 3
    hier_kw = {"plan": "local@2/global@4:topk:0.25", "bucket_bytes": 0}
    spec = "flaky:group:0.4/straggler:0.5:1.5"
    p_np = _mlp_np(5)
    n = 4 * 4 * B
    batches = [_mixture(np.random.default_rng(9 + r), (n,))
               for r in range(n_rounds)]
    jb, tb = iter(batches), iter(batches)
    jlog = jtel.MetricsLogger(str(tmp_path / "j.jsonl"))
    tlog = ttel.MetricsLogger(str(tmp_path / "t.jsonl"))
    jr = JSimulator(jres.mlp_cls_loss, lambda k: jax.tree.map(
        jnp.asarray, p_np), lambda k, m: jax.tree.map(jnp.asarray, next(jb)),
        topo=JTopo(*shape), hier=JHier(**hier_kw),
        optimizer=joptim.sgd(0.1), per_learner_batch=B, faults=spec,
        telemetry=True, metrics=jlog).run(n_rounds)
    tr = Simulator(tres.mlp_cls_loss, lambda g: convert.tree_from_numpy(
        p_np, device="cpu"), lambda g, m: tree_map(_t, next(tb)),
        topo=HierTopology(*shape), hier=HierAvgParams(**hier_kw),
        optimizer=toptim.sgd(0.1), per_learner_batch=B, faults=spec,
        telemetry=True, metrics=tlog, device="cpu").run(n_rounds)
    jlog.close()
    tlog.close()
    assert sorted(tr.stats) == sorted(jr.stats)
    for k in jr.stats:
        np.testing.assert_allclose(tr.stats[k], jr.stats[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert tr.measured_wall_s.shape == (n_rounds,)
    trows = ttel.validate_jsonl(str(tmp_path / "t.jsonl"))
    jrows = jtel.validate_jsonl(str(tmp_path / "j.jsonl"))
    assert len(trows) == len(jrows) == n_rounds
    for a, b in zip(trows, jrows):
        assert sorted(a) == sorted(b)
        assert a["active_frac"] == b["active_frac"]
        assert a["modeled_wall_s"] == b["modeled_wall_s"]
    assert tlog.counters == {"train/rounds": n_rounds}
    with pytest.raises(ValueError, match="telemetry"):
        Simulator(tres.mlp_cls_loss, None, None, topo=HierTopology(*shape),
                  hier=HierAvgParams(), algo="sync", telemetry=True,
                  device="cpu")
