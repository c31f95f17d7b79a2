"""The port's autotune loop and analytic roofline against the reference's
(``repro_torch.autotune``, ``repro_torch.launch.analytic`` vs
``repro.autotune``, ``repro.launch.analytic``), on the same numpy-made
samples, topologies and calibrations, on the CPU.

What is compared, and how close:
  * the fit (``fit_comm_model``): fitted fields equal, values within
    1e-9 relative (both solve the same least squares in float64 numpy);
  * the artifact: written by either package, read by the other, the same
    model and fields;
  * the plan search, the controller and the analytic roofline: plain
    Python arithmetic on the same shapes, so equal to 1e-12 relative
    (each side sizes payloads from its own parameter templates: the
    reference's ``ShapeDtypeStruct`` trees, the port's meta tensors);
  * a probe point's record: every field but the timings equal;
  * ``--autotune`` on the CPU: the ranked plans the reference's search
    gives over the same model, and losses bit for bit those of
    ``--plan <ranked[0]>`` (under deterministic algorithms: the CPU's
    threaded embedding backward sums in another order from run to run).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import autotune as jat  # noqa: E402
from repro.configs.base import HierAvgParams as JHier  # noqa: E402
from repro.core import theory as jtheory  # noqa: E402
from repro.core.topology import HierTopology as JTopo  # noqa: E402
from repro.launch import analytic as jan  # noqa: E402

from repro_torch import autotune as tat  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import HierAvgParams as THier  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.core import theory as ttheory  # noqa: E402
from repro_torch.core.topology import HierTopology as TTopo  # noqa: E402
from repro_torch.launch import analytic as tan  # noqa: E402

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
REL = 1e-12


def _models(**kw):
    return jtheory.CommModel(**kw), ttheory.CommModel(**kw)


TRUE = dict(fast_bw=2.0e8, slow_bw=1.0e7, latency=3.0e-4,
            compress_bw=5.0e8)
BALANCED = dict(fast_bw=5.0e10, slow_bw=2.5e10)
SKEWED = dict(fast_bw=5.0e10, slow_bw=2.5e8)


def _synth(model, *, noise=0.0, seed=0, codecs=False):
    """Probe-shaped samples made from a known model (the reference's
    ``tests/test_autotune.py`` grids), timed by the reference's
    ``predict_seconds``."""
    rng = np.random.default_rng(seed)
    out = []
    tiers = (("ici", 8), ("ici", 4), ("dci", 8))
    mixes = ((1, False, ""), (8, False, ""), (1, True, ""))
    if codecs:
        tiers = (("ici", 8), ("dci", 8))
        mixes = ((1, False, ""), (8, False, ""), (1, True, "topk"),
                 (1, True, "qint8"), (1, True, "powersgd"))
    for tier, n in tiers:
        for v in (1 << 17, 1 << 20, 1 << 22):
            for m, has, codec in mixes:
                s = dict(level="global", tier=tier, n=n, payload_bytes=v,
                         dense_bytes=4 * v, messages=m, has_codec=has,
                         codec=codec, spec="synth")
                t = jat.predict_seconds(model, s)
                s["min_us"] = t * (1.0 + noise * rng.standard_normal()) * 1e6
                out.append(s)
    return out


def _close(a, b, rel):
    return abs(a - b) <= rel * max(abs(a), abs(b))


def _same_model(tm, jm, rel):
    td, jd = dataclasses.asdict(tm), dataclasses.asdict(jm)
    assert set(td) == set(jd)
    for k in ("fast_bw", "slow_bw", "latency", "compress_bw"):
        assert _close(float(td[k]), float(jd[k]), rel), (k, td[k], jd[k])
    tc, jc = dict(td["codec_bw"] or ()), dict(jd["codec_bw"] or ())
    assert set(tc) == set(jc)
    for k in tc:
        assert _close(tc[k], jc[k], rel), (k, tc[k], jc[k])


# --------------------------------------------------------------------- #
# calibration


@pytest.mark.parametrize("case", ["exact", "noisy", "ici_only", "codecs"])
def test_fit_matches_reference(case):
    """``fit_comm_model`` on the same samples: the same fitted fields, the
    values and diagnostics within 1e-9 relative."""
    true = jtheory.CommModel(**TRUE)
    if case == "codecs":
        true = dataclasses.replace(
            true, codec_bw=(("powersgd", 1.0e8), ("qint8", 2.0e9)))
    samples = _synth(true, noise=0.05 if case == "noisy" else 0.0, seed=3,
                     codecs=case == "codecs")
    if case == "ici_only":
        samples = [s for s in samples if s["tier"] == "ici"]
    want = jat.fit_comm_model(samples)
    got = tat.fit_comm_model(samples)
    assert got.fitted == want.fitted
    assert got.n_samples == want.n_samples
    _same_model(got.model, want.model, 1e-9)
    for k in ("median_rel_err", "max_rel_err"):
        assert abs(getattr(got, k) - getattr(want, k)) <= 1e-9 * max(
            1.0, abs(getattr(want, k)))
    for s in samples:
        assert _close(tat.predict_seconds(got.model, s),
                      jat.predict_seconds(want.model, s), 1e-9)
    assert tat.CPU_MEDIAN_REL_ERR == jat.CPU_MEDIAN_REL_ERR


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_calibration_artifact_crosses_packages(writer, tmp_path,
                                               monkeypatch):
    """An artifact written by either package loads in the other (per-codec
    rates included), and ``$REPRO_CALIBRATION`` resolves it in both."""
    true = dataclasses.replace(jtheory.CommModel(**TRUE),
                               codec_bw=(("qint8", 2.0e9),))
    samples = _synth(true, codecs=True)
    path = str(tmp_path / "calib.json")
    src, dst = (jat, tat) if writer == "reference" else (tat, jat)
    cal = src.fit_comm_model(samples, source="synth")
    cal.save(path)
    back = dst.Calibration.load(path)
    assert back.fitted == cal.fitted and back.n_samples == cal.n_samples
    _same_model(back.model, cal.model, 0.0)
    monkeypatch.setenv("REPRO_CALIBRATION", path)
    for pkg in (jat, tat):
        assert pkg.resolve_calibration().fitted == cal.fitted
    with open(path) as f:
        d = json.load(f)
    assert set(d) >= {"comm_model", "fitted", "diagnostics", "source"}
    monkeypatch.setenv("REPRO_CALIBRATION", str(tmp_path / "typo.json"))
    with pytest.raises(FileNotFoundError, match="typo.json"):
        tat.resolve_comm_model()
    with pytest.raises(ValueError, match="calibration artifact"):
        bad = tmp_path / "records.json"
        bad.write_text(json.dumps({"foo": 1}))
        tat.Calibration.load(str(bad))


# --------------------------------------------------------------------- #
# search


def _same_ranking(got, want):
    assert [g.spec for g in got] == [w.spec for w in want]
    for g, w in zip(got, want):
        assert (g.outer, g.inner, g.feasible) == (w.outer, w.inner,
                                                  w.feasible)
        for k in ("comm_s_per_step", "sec_per_step", "objective", "score"):
            assert _close(getattr(g, k), getattr(w, k), REL), (g.spec, k)


@pytest.mark.parametrize("case", ["skewed", "balanced", "codec_bound",
                                  "drop_prob", "space_two_level"])
def test_search_matches_reference(case):
    """``search_plans`` over the reference's test topology (2, 2, 2) and
    calibrations: the same ranking, scores and feasibility flags."""
    kw = {"skewed": SKEWED, "drop_prob": SKEWED, "balanced": BALANCED,
          "space_two_level": SKEWED,
          "codec_bound": dict(fast_bw=1e13, slow_bw=1e13,
                              compress_bw=1e6)}[case]
    jm, tm = _models(**kw)
    extra = {}
    if case == "drop_prob":
        extra = {"drop_prob": {"global": 0.2}, "step_s": 1e-3}
    if case == "space_two_level":
        spaces = [pkg.SearchSpace(levels=("local", "global"),
                                  periods={"local": (1, 2),
                                           "global": (4, 8, 16)},
                                  reducers={"local": ("mean",),
                                            "global": ("mean", "topk:0.05",
                                                       "qint8:128")})
                  for pkg in (jat, tat)]
    else:
        spaces = [None, None]
    want = jat.search_plans(JTopo(2, 2, 2), jm, space=spaces[0],
                            template=jtheory.param_template(1 << 22,
                                                            n_leaves=8),
                            **extra)
    got = tat.search_plans(TTopo(2, 2, 2), tm, space=spaces[1],
                           template=ttheory.param_template(1 << 22,
                                                           n_leaves=8),
                           **extra)
    _same_ranking(got, want)
    assert list(tat.enumerate_specs(tat.SearchSpace())) == \
        list(jat.enumerate_specs(jat.SearchSpace()))
    assert tat.recommend_plan(
        TTopo(2, 2, 2), tm, space=spaces[1],
        template=ttheory.param_template(1 << 22, n_leaves=8),
        **extra).spec == want[0].spec


# --------------------------------------------------------------------- #
# controller


@pytest.mark.parametrize("plan,kw", [
    ("local@2/pod@8/global@32", SKEWED),
    ("local@2/pod@8/global@32", BALANCED),
    ("local@4/global@64", BALANCED)])
def test_controller_matches_reference(plan, kw):
    """``CostAwarePlan``: level costs, periods and plans down the loss
    ladder, ``params_for``, then the same ``train_round`` rows observed:
    the observed wall, participation, modeled wall and ``wall_bias``."""
    jm, tm = _models(**kw)
    j = jat.CostAwarePlan(plan, JTopo(2, 2, 2), jm,
                          template=jtheory.param_template(1 << 22,
                                                          n_leaves=8),
                          drop_prob={"global": 0.1})
    t = tat.CostAwarePlan(plan, TTopo(2, 2, 2), tm,
                          template=ttheory.param_template(1 << 22,
                                                          n_leaves=8),
                          drop_prob={"global": 0.1})
    assert len(t.level_costs) == len(j.level_costs)
    for a, b in zip(t.level_costs, j.level_costs):
        assert _close(a, b, REL)
    for loss in (10.0, 5.0, 1.0, 0.01, 1e-5):
        assert t.periods_for(loss) == j.periods_for(loss)
        assert t.plan_for(loss).describe() == j.plan_for(loss).describe()
        assert t.params_for(loss).plan == j.params_for(loss).plan
    base = dict(k1=2, k2=8, bucket_bytes=123 << 10, overlap=False)
    assert t.params_for(1.0, THier(**base)).plan == \
        j.params_for(1.0, JHier(**base)).plan
    t.reset()
    j.reset()
    assert t.observed_wall_s is None and t.wall_bias() is None
    rows = [{"round": r, "wall_s": w,
             "active_frac": {"local": 1.0, "global": f}}
            for r, (w, f) in enumerate([(0.9, 1.0), (0.31, 0.75),
                                        (0.3, 0.5), (0.0, 1.0)])]
    for row in rows:
        t.observe(row)
        j.observe(row)
        assert t.observed_wall_s == j.observed_wall_s
        assert t.observed_active_frac == j.observed_active_frac
    assert _close(t.modeled_round_wall_s, j.modeled_round_wall_s, REL)
    assert _close(t.wall_bias(), j.wall_bias(), REL)


# --------------------------------------------------------------------- #
# probe


def test_default_grid_is_the_reference_grid():
    for smoke in (True, False):
        got, want = tat.default_grid(smoke), jat.default_grid(smoke)
        assert [dataclasses.asdict(p) for p in got] == \
            [dataclasses.asdict(p) for p in want]
    pt = tat.ProbePoint("pod", (2, 2, 2), "topk:0.05", 4, (32, 32), 1 << 15)
    assert tat.ProbePoint.from_json(pt.to_json()) == pt
    assert pt.describe() == jat.ProbePoint(**dataclasses.asdict(
        pt)).describe()


PROBE_POINTS = [
    tat.ProbePoint("global", (1, 2, 2), "mean", 4, (16, 16), 2048),
    tat.ProbePoint("local", (1, 2, 2), "topk:0.05", 4, (16, 16)),
    tat.ProbePoint("global", (2, 1, 2), "qint8:128", 2, (32, 16)),
    tat.ProbePoint("global", (1, 2, 2), "powersgd:2", 4, (32, 32)),
    tat.ProbePoint("pod", (2, 1, 2), "cast:bfloat16", 3, (16, 8)),
]
TIMING = ("compile_s", "warm_us", "min_us")


def _reference_records(points):
    """The reference's ``measure_point`` of each point, in one child
    process with 4 forced host devices (its A/B harness places the learners
    on devices)."""
    code = ("import json, sys\n"
            "from repro.autotune.probe import ProbePoint, measure_point\n"
            "pts = [ProbePoint.from_json(s) for s in json.loads(sys.argv[1])]"
            "\nprint(json.dumps([measure_point(p, 1) for p in pts]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run(
        [sys.executable, "-c", code,
         json.dumps([p.to_json() for p in points])],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_measure_point_record_matches_reference():
    """A CPU ``measure_point`` (top-k, qint8, PowerSGD and cast codecs, a
    many-bucket mean, local, pod and 2-pod global levels): every field of
    the record but the timings equals the reference's."""
    want = _reference_records(PROBE_POINTS)
    for pt, w in zip(PROBE_POINTS, want):
        got = tat.measure_point(pt, 1, device="cpu")
        assert got["reps"] == 1 and got["min_us"] > 0.0
        for k in TIMING:
            got.pop(k)
            w.pop(k)
        got = json.loads(json.dumps(got))
        assert got == w, pt.describe()


def test_probe_refuses_without_the_card(tmp_path):
    """The probe's entry points run on the card unless the CPU is asked
    for; without CUDA they refuse, naming the CPU option."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal does not apply")
    pt = PROBE_POINTS[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tat.measure_point(pt, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tat.run_probe([pt], reps=1)
    out = str(tmp_path / "probe.json")
    samples = tat.run_probe([pt], reps=2, out=out, device="cpu")
    assert tat.load_samples(out) == json.loads(json.dumps(samples))


@pytest.mark.slow
def test_probe_calibrate_roundtrip_on_cpu(tmp_path):
    """The measured path on the CPU: the smoke grid's samples, their ICI
    subset fitted (in one process no sample crosses a slower link), and
    the calibrated model within the reference's CPU tolerance.  The grid
    runs once untimed first: the first second of a fresh CPU process
    reads its reductions ~100x slower (where the reference starts a
    fresh subprocess a point and keeps the fastest repetition)."""
    tat.run_probe(tat.default_grid(smoke=True), reps=1, device="cpu")
    samples = tat.run_probe(tat.default_grid(smoke=True), reps=5,
                            device="cpu")
    ici = [s for s in samples if s["tier"] == "ici"]
    cal = tat.fit_comm_model(ici)
    assert cal.fitted and "slow_bw" not in cal.fitted
    assert cal.median_rel_err <= tat.CPU_MEDIAN_REL_ERR, cal


# --------------------------------------------------------------------- #
# analytic roofline


def _roofline_pairs():
    for arch in ALL_ARCHS:
        for shape in INPUT_SHAPES:
            yield arch, shape


def _same_roofline(got, want):
    assert got.bottleneck == want.bottleneck
    for k in ("compute_s", "memory_s", "collective_s",
              "model_flops_per_device"):
        assert _close(getattr(got, k), getattr(want, k), REL), k
    for a, b in ((got.collective_parts, want.collective_parts),
                 (got.details, want.details)):
        assert set(a) == set(b)
        for k in a:
            assert _close(a[k], b[k], REL), k


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_analytic_roofline_matches_reference(arch, monkeypatch):
    """Every arch x shape (single and multi-pod, the legacy K1/K2 and a
    3-level compressed plan): with the reference module's constants
    patched to the port's H100 ones in this test, the two rooflines are
    the same arithmetic; a calibration displaces the same constants in
    both."""
    from repro.configs import get_config as jget
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW", "DCI_BW"):
        monkeypatch.setattr(jan, name, getattr(tan, name))
    monkeypatch.delenv("REPRO_CALIBRATION", raising=False)
    plan = "local@2:cast:bfloat16/pod@4/global@8:topk:0.05"
    cal = {p: p.Calibration(model=p_model, fitted=("fast_bw",),
                            n_samples=4, median_rel_err=0.1,
                            max_rel_err=0.2)
           for p, p_model in ((jat, jtheory.CommModel(fast_bw=1e10)),
                              (tat, ttheory.CommModel(fast_bw=1e10)))}
    for shape in INPUT_SHAPES:
        for multi in (False, True):
            for spec in (None, plan):
                jh, th_ = JHier(k1=4, k2=8, plan=spec), \
                    THier(k1=4, k2=8, plan=spec)
                for comm in ((None, None), (cal[jat], cal[tat])):
                    try:
                        want = jan.analytic_roofline(
                            jget(arch), shape, multi_pod=multi, hier=jh,
                            comm_model=comm[0])
                    except Exception as e:   # the port must refuse too
                        with pytest.raises(type(e)):
                            tan.analytic_roofline(
                                get_config(arch), shape, multi_pod=multi,
                                hier=th_, comm_model=comm[1])
                        continue
                    got = tan.analytic_roofline(
                        get_config(arch), shape, multi_pod=multi,
                        hier=th_, comm_model=comm[1])
                    _same_roofline(got, want)


def test_analytic_constants_are_the_h100s(tmp_path, monkeypatch):
    """The port's per-device constants are the H100 SXM5's (datasheet,
    700 W): dense bf16 989 TFLOP/s, HBM3 3.35 TB/s, NVLink 4 450 GB/s a
    direction, a 400 Gb/s InfiniBand port 50 GB/s; each is named beside
    its value.  An ICI-only calibration displaces only the fast tier."""
    assert (tan.PEAK_FLOPS, tan.HBM_BW, tan.LINK_BW, tan.DCI_BW) == \
        (989e12, 3.35e12, 450e9, 50e9)
    with open(tan.__file__) as f:
        text = f.read()
    head = text[:text.index("BF16 = 2")]
    assert "H100" in head and "700 W" in head
    for word in ("bf16", "HBM3", "NVLink", "InfiniBand"):
        assert word in head, word
    cfg = get_config("yi-34b")
    monkeypatch.delenv("REPRO_CALIBRATION", raising=False)
    base = tan.analytic_roofline(cfg, "train_4k", multi_pod=True)
    ici_only = tat.Calibration(
        model=dataclasses.replace(ttheory.CommModel(), fast_bw=1.0e9),
        fitted=("fast_bw",), n_samples=4, median_rel_err=0.1,
        max_rel_err=0.2)
    p = str(tmp_path / "ici.json")
    ici_only.save(p)
    monkeypatch.setenv("REPRO_CALIBRATION", p)
    part = tan.analytic_roofline(cfg, "train_4k", multi_pod=True)
    assert part.collective_parts["global_avg"] == \
        base.collective_parts["global_avg"]
    assert part.collective_parts["local_avg"] > \
        base.collective_parts["local_avg"]


# --------------------------------------------------------------------- #
# --autotune


def test_autotune_cli_trains_the_reference_ranking(tmp_path, capsys):
    """``launch.train --autotune`` on the CPU: the three plans it prints
    are the reference's search over the same reduced model (its
    ``jax.eval_shape`` tree against the port's meta template), and its
    losses are bit for bit those of ``--plan <ranked[0]>``; the
    controller reports measured against modeled walls."""
    from repro.models import build as jbuild
    from repro_torch.launch import train as ttrain
    cal = jat.Calibration(model=jtheory.CommModel(**SKEWED),
                          fitted=("fast_bw", "slow_bw"), n_samples=6,
                          median_rel_err=0.1, max_rel_err=0.2)
    path = str(tmp_path / "calib.json")
    cal.save(path)
    cli = ["--arch", "rwkv6-1.6b", "--rounds", "2", "--learners", "4",
           "--s", "2", "--batch", "2", "--seq", "8", "--device", "cpu"]
    from repro.configs import get_config as jget
    jcfg = jget("rwkv6-1.6b").reduced()
    template = jax.eval_shape(jbuild(jcfg).init,
                              jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = jat.search_plans(JTopo(1, 2, 2), cal, template=template, B=2,
                            T_ref=2 * JHier(k1=2, k2=4).steps_per_round,
                            top=3)
    rows = [str(tmp_path / "auto.jsonl"), str(tmp_path / "plan.jsonl")]
    # one thread: the parallel test run's workers share the cores, and a
    # thread pool per worker on top of them slows every test many times
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    try:
        ttrain.main(cli + ["--autotune", path, "--metrics-out", rows[0]])
        auto = capsys.readouterr().out
        ttrain.main(cli + ["--plan", want[0].spec, "--metrics-out",
                           rows[1]])
        capsys.readouterr()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.set_num_threads(threads)
    ranked = [ln.split()[1] for ln in auto.splitlines()
              if ln.startswith("  #")]
    assert ranked == [w.spec for w in want]
    for ln, w in zip([ln for ln in auto.splitlines()
                      if ln.startswith("  #")], want):
        score = float(ln.split("score=")[1].split()[0])
        assert _close(score, w.score, 1e-3)     # printed to 4 digits

    def losses(path):
        with open(path) as f:
            return [json.loads(ln)["loss"] for ln in f]

    assert len(losses(rows[0])) == 2
    assert losses(rows[0]) == losses(rows[1])
    line = [ln for ln in auto.splitlines() if ln.startswith("controller:")]
    assert line and "wall_bias=" in line[0]


def test_autotune_ranks_must_agree_on_the_plan(monkeypatch):
    """Under torchrun the launcher gathers every rank's plan hash before
    any process group is made: one plan passes, two fail loudly (a world
    on different plans would hang in its collectives)."""
    import torch.distributed as dist

    from repro_torch.launch import train as ttrain
    from repro_torch.parallel import collectives
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    for other, ok in (("local@2/global@4", True),
                      ("local@2/global@8", False)):
        mine = ttrain._plan_hash("local@2/global@4")
        monkeypatch.setattr(collectives, "all_gather", lambda x, g, n: (
            torch.tensor([mine, ttrain._plan_hash(other)])))
        if ok:
            ttrain._same_plan_on_every_rank("local@2/global@4", "cpu")
        else:
            with pytest.raises(RuntimeError, match="different plans"):
                ttrain._same_plan_on_every_rank("local@2/global@4", "cpu")
