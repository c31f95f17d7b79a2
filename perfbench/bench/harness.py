"""One run of one training cell: set-up, the measured window, with
``trace`` the per-layer readings, then the check against the plain
reference.

Set-up, in order: the kernels the cell needs are loaded (built by nvcc
into the program's fixed build directory on the first run of a
checkout); the weights are made on the device from the seed and loaded
into the program's parameter tree by leaf name; the round
(``make_hier_round``) and its state (``init_state``) are built, each
top-k level's error feedback carrying a residual made from the seed (as
after earlier fires: the round then uses it, and leaves its own); then
the checked round, round 0, runs through that same round on the feed's
first batch.  It warms up every shape the window uses and gives the
program's readings for the check.  The window calls the round on the
following batches until ``seconds`` have passed, and ends at a round
boundary behind a synchronize.  Nothing is evaluated inside it.  With
``trace``, one more round runs under ``torch.profiler``, then each
level's fire alone ``FIRE_REPS`` times.
"""
from __future__ import annotations

import gc
import math
import os
import statistics
import tempfile
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import torch

from perfbench.bench import check, trace as tr, weights, yardstick
from perfbench.bench.feed import Feed, per_step
from perfbench.bench.spec import Spec

WINDOW = "perfbench.window"
FIRE = "perfbench.fire."
# fires of each level timed alone in a traced run (their median is read)
FIRE_REPS = 5


def process_start() -> float:
    """This process's start on the epoch clock (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f
                    if line.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def set_precision(prec: Dict) -> None:
    torch.backends.cuda.matmul.allow_tf32 = bool(prec["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(prec["tf32"])
    torch.backends.cudnn.deterministic = bool(prec["cudnn_deterministic"])
    torch.backends.cudnn.benchmark = False


def event(device):
    """A CUDA event recorded now on the current stream (None off the
    card): the window's round boundaries, read after it closes."""
    if torch.device(device).type != "cuda":
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class GradTap:
    """The program's optimizer with a tap: the first update records each
    leaf's gradient norm over all learners, as the optimizer gets it."""

    def __init__(self, inner):
        from repro_torch.optim import Optimizer
        self.inner = inner
        self.norms: Optional[List[float]] = None
        self.optimizer = Optimizer(inner.init, self._update)

    def _update(self, grads, params, state, step):
        if self.norms is None:
            from repro_torch.tree import leaves
            self.norms = [float(torch.linalg.vector_norm(g.double()))
                          for g in leaves(grads)]
        return self.inner.update(grads, params, state, step)


def program_tree(template, w0: Dict[str, torch.Tensor]):
    """The program's parameter tree, leaf by leaf from ``w0`` by path."""
    from repro_torch.tree import flatten, leaf_paths, unflatten
    flat, treedef = flatten(template)
    paths = leaf_paths(template)
    if sorted(paths) != sorted(w0):
        raise ValueError(f"the program's leaves {sorted(set(paths) ^ set(w0))}"
                         f" differ from the configuration's")
    for p, t in zip(paths, flat):
        if tuple(t.shape) != tuple(w0[p].shape):
            raise ValueError(f"leaf {p}: program {tuple(t.shape)}, "
                             f"configuration {tuple(w0[p].shape)}")
    return unflatten(treedef, [w0[p] for p in paths]), paths


def wall_ms(fn: Callable, device, reps: int = 3) -> float:
    """Mean wall of ``fn`` across a synchronize, after one warm-up."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(device)
    return (time.perf_counter() - t0) * 1e3 / reps


class Program:
    """The system under test as a cell runs it."""

    def __init__(self, cfg: Dict, traffic: Dict, adapter, w0, device,
                 wrap_round: Optional[Callable] = None, impl: str = "auto"):
        from repro_torch.configs.base import HierAvgParams
        from repro_torch.core.hier_avg import init_state, make_hier_round
        from repro_torch.core.topology import HierTopology
        from repro_torch.optim import sgd
        opt = cfg["optimizer"]
        if opt["name"] != "sgd":
            raise ValueError(f"optimizer {opt['name']!r} is not wired")
        self.lr = float(opt["lr"])
        self.hier = HierAvgParams(plan=traffic["plan"],
                                  bucket_bytes=traffic["bucket_bytes"],
                                  overlap=traffic["overlap"])
        self.loss_fn, template = adapter.program(cfg, device, impl)
        tree, self.paths = program_tree(template, w0)
        self.tap = GradTap(sgd(self.lr))
        rnd = make_hier_round(self.loss_fn, self.tap.optimizer, self.hier)
        self.round = wrap_round(rnd) if wrap_round else rnd
        self.topo = tuple(cfg["topology"])
        self.state = init_state(HierTopology(*self.topo),
                                lambda g: tree, self.tap.optimizer, None,
                                plan=self.hier.resolved_plan, device=device)

    def _ef_levels(self):
        """The levels whose reducer carries error feedback."""
        return [lvl for lvl in self.hier.resolved_plan.levels
                if hasattr((self.state.comm_state or {}).get(lvl.name),
                           "err")]

    def _stacked(self, by_path: Dict[str, torch.Tensor]):
        """The program's tree of {path: [learners, *shape]}, each leaf
        [pods, groups, local, *shape]."""
        from repro_torch.tree import flatten, unflatten
        _, treedef = flatten(self.state.params)
        return unflatten(treedef, [by_path[p].reshape(
            self.topo + tuple(by_path[p].shape[1:])) for p in self.paths])

    def carry_residual(self, res: Dict[str, torch.Tensor]) -> None:
        """Every top-k level's error feedback starts from ``res`` ({path:
        [learners, *shape]}), put in the level's own units by its reducer
        (leaves, or buckets under bucketing)."""
        comm = dict(self.state.comm_state)
        tree = self._stacked(res)
        for lvl in self._ef_levels():
            packed = lvl.reducer.init_state(tree).ref
            comm[lvl.name] = comm[lvl.name]._replace(err=packed)
        self.state = self.state._replace(comm_state=comm)

    def ref_norms(self, w0) -> Dict[str, float]:
        """Each error-feedback unit's norm of its reference's change since
        the start (every learner at ``w0``), over all learners, keyed as
        :meth:`ef_norms`."""
        from repro_torch.tree import leaves
        n = math.prod(self.topo)
        tree = self._stacked({p: w[None].expand((n,) + tuple(w.shape))
                              for p, w in w0.items()})
        out = {}
        for lvl in self._ef_levels():
            start = lvl.reducer.init_state(tree).ref
            for i, (r, r0) in enumerate(zip(
                    leaves(self.state.comm_state[lvl.name].ref),
                    leaves(start))):
                out[f"{lvl.name}/{i}"] = float(torch.linalg.vector_norm(
                    (r.float() - r0.float()).double()))
            del start
        return out

    def step(self, batch):
        self.state, metrics = self.round(self.state, batch)
        return metrics["loss"]

    def change_norms(self, w0) -> Dict[str, float]:
        from repro_torch.tree import leaves
        return {p: float(torch.linalg.vector_norm(
            (x[0, 0, 0].double() - w0[p].double())))
            for p, x in zip(self.paths, leaves(self.state.params))}

    def ef_norms(self) -> Dict[str, float]:
        """Each error-feedback unit's residual norm over all learners,
        keyed "<level>/<unit>" (a leaf, or a bucket under bucketing)."""
        from repro_torch.tree import leaves
        return {f"{lvl.name}/{i}": float(torch.linalg.vector_norm(
                    e.double()))
                for lvl in self._ef_levels()
                for i, e in enumerate(leaves(
                    self.state.comm_state[lvl.name].err))}

    def step_ms(self, batch, device) -> float:
        """One SGD step of all learners across a synchronize, on the
        window's last state."""
        from repro_torch.core.hier_avg import make_sgd_step
        from repro_torch.optim import sgd
        from repro_torch.tree import tree_map
        n = len(self.hier.batch_dims)
        step_batch = tree_map(lambda x: x[(0,) * n], batch)
        step = make_sgd_step(self.loss_fn, sgd(self.lr))
        state = self.state
        return wall_ms(lambda: step(state, step_batch), device)

    def fires(self) -> Dict[str, Callable]:
        """One fire of each level (its reducer and the learner mean) on
        the current state, its result left unused, by level name."""
        from repro_torch.comm import reduce_with
        from repro_torch.core.topology import average_over
        state, out = self.state, {}
        for lvl in self.hier.resolved_plan.levels:
            cs = state.comm_state[lvl.name] if lvl.reducer.stateful else ()
            out[lvl.name] = (lambda lvl=lvl, cs=cs: reduce_with(
                lvl.reducer, lambda t, cf=None, lvl=lvl: average_over(
                    t, lvl.axes), state.params, cs))
        return out


def program_readings(cfg, traffic, adapter, specs, seed, device,
                     wrap_round=None, impl: str = "auto"):
    """Build the program from the seed and run the checked round through
    its round; returns (the program, its readings, the feed)."""
    w0 = weights.make(specs, cfg["init"], seed, device)
    prog = Program(cfg, traffic, adapter, w0, device, wrap_round, impl)
    prog.carry_residual(weights.residual(w0, yardstick.learners(cfg), seed,
                                         device))
    feed = Feed(cfg, traffic, prog.hier.batch_dims, seed, device)
    mine = {"loss": float(prog.step(feed.round(0)))}
    mine["grad_norms"] = dict(zip(prog.paths, prog.tap.norms))
    mine["change_norms"] = prog.change_norms(w0)
    mine["ef_norms"] = prog.ef_norms()
    mine["ref_norms"] = prog.ref_norms(w0)
    return prog, mine, feed


def reference_readings(cfg, traffic, adapter, specs, seed, feed, device,
                       tf32: bool = False) -> Dict:
    """The plain reference over the checked round, from the seed;
    ``tf32`` computes it with TF32 on (the control)."""
    from perfbench.reference.hier_avg import PlainHierAvg
    w0 = weights.make(specs, cfg["init"], seed, device)
    plain = PlainHierAvg(adapter.reference_grads(cfg), traffic["plan"],
                         cfg["topology"], float(cfg["optimizer"]["lr"]),
                         traffic["bucket_bytes"], traffic["overlap"])
    n = yardstick.learners(cfg)
    plain.init(w0, weights.residual(w0, n, seed, device))
    n_dims = len(feed.lead) - 4
    set_precision(dict(cfg["precision"], tf32=tf32))
    try:
        loss = float(plain.round(per_step(feed.round(0), n_dims, n)))
    finally:
        set_precision(cfg["precision"])
    change = {k: float(torch.linalg.vector_norm(
        plain.params[k][0].double() - w0[k].double())) for k in w0}
    return {"loss": loss, "grad_norms": plain.first_grad_norms,
            "change_norms": change, "ef_norms": plain.ef_norms(),
            "ref_norms": plain.ref_norms()}


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        spec: Optional[Spec] = None, device="cuda",
        wrap_round: Optional[Callable] = None) -> Dict:
    """One run; returns the result (``line``: the result line's keys;
    ``checks``: the compared numbers with their limits)."""
    started = process_start()
    marks = {"imports": time.time() - started}
    spec = spec or Spec()
    cell = spec.cell(cell_name)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    adapter = spec.model(cfg["model"])
    limits = spec.limits(cell_name)
    set_precision(cfg["precision"])
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all(cfg.get("kernels", []) + traffic.get("kernels", []))
    marks["kernels"] = time.time() - started

    specs = adapter.param_specs(cfg)
    prog, mine, feed = program_readings(cfg, traffic, adapter, specs, seed,
                                        device, wrap_round)
    # no empty_cache here: the window's first round would pay the
    # allocator's cudaMalloc calls again (+0.1-0.4 s on ResNet-18)
    gc.collect()
    sync(device)
    setup_s = time.time() - started
    marks["checked round"] = setup_s

    # the measured window
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    r = 1
    window_losses, bounds = [], [event(device)]
    t0 = time.perf_counter()
    while True:
        window_losses.append(prog.step(feed.round(r)))
        bounds.append(event(device))
        r += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    rounds = len(window_losses)
    steps = yardstick.steps_per_round(traffic)
    finite = torch.isfinite(torch.stack(window_losses)).tolist()
    round_ms = [a.elapsed_time(b) for a, b in zip(bounds, bounds[1:])] \
        if bounds[0] is not None else []
    ctx = SimpleNamespace(
        cfg=cfg, traffic=traffic, adapter=adapter,
        setup_s=setup_s, peak_bytes=peak, window_s=window_s,
        samples=rounds * steps * yardstick.learners(cfg)
        * traffic["batch_per_learner"], parts=None, trace=None,
        trace_window=None)

    breakdown, fire_ms = None, {}
    if trace:
        batch = feed.round(r)
        ctx.parts = {"step": prog.step_ms(batch, device)}
        full = profile(prog, batch, device)
        ctx.trace_window = a, b = annotated(full, WINDOW)[0]
        ctx.trace = tr.launched(full, a, b)
        for name in prog.fires():
            fire_ms[name] = [tr.busy_us(tr.launched(full, s, e).device) / 1e3
                             for s, e in annotated(full, FIRE + name)]
            ctx.parts[name] = statistics.median(fire_ms[name])
        breakdown = {"device_ops": tr.top_device_ops(ctx.trace),
                     "idle_gaps": tr.idle_gaps(ctx.trace, a, b)}

    # the program's state is freed before the reference runs
    del prog
    free(device)
    ref = reference_readings(cfg, traffic, adapter, specs, seed, feed,
                             device)
    nums = check.numbers(mine, ref)
    ok, checks = check.judge(nums, limits)
    failed = steps * sum(1 for f in finite if not f)
    ok = ok and failed == 0

    metrics = {}
    for m in spec.metrics(cell_name, trace):
        value = spec.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": bool(ok), "attempted": rounds * steps,
            "failed": failed, "metrics": metrics,
            "device": device_info(device, cell["chips"], peak)}
    if trace and ctx.trace is not None:
        a, b = ctx.trace_window
        line["device"]["busy_s"] = tr.busy_us(ctx.trace.device) / 1e6
        line["device"]["window_s"] = (b - a) / 1e6
        line["breakdown"] = breakdown
    marks["checked and read"] = time.time() - started
    return {"line": line, "checks": checks, "numbers": nums,
            "program": mine, "reference": ref, "round_ms": round_ms,
            "fire_ms": fire_ms, "marks": marks}


def profile(prog: Program, batch, device) -> tr.Trace:
    """Under ``torch.profiler`` (host and device): one round on ``batch``
    (the traced window), then ``FIRE_REPS`` fires of each level alone,
    each annotated and closed behind a synchronize."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    from torch.profiler import record_function
    sync(device)
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            prog.step(batch)
            sync(device)
        for name, fire in prog.fires().items():
            for _ in range(FIRE_REPS):
                with record_function(FIRE + name):
                    fire()
                    sync(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return tr.load(path)


def annotated(trace: tr.Trace, name: str):
    """[(start, end)] in trace time of the host annotations ``name``."""
    found = [(e.ts, e.ts + e.dur) for e in trace.host if e.name == name]
    if not found:
        raise RuntimeError(f"the profiler recorded no {name!r} annotation")
    return found


def device_info(device, chips: int, peak: int) -> Dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}

