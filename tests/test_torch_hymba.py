"""The port's Mamba head and Hymba hybrid LM against the JAX package's.

``models/mamba.py::mamba_apply`` against ``repro.models.mamba`` in both of
its branches (time chunks under remat when the sequence is a multiple of
the chunk and longer than one, else one chunk), from zero and from
carried states, with gradients; the one-token decode against the
sequence; the reduced Hymba LM's leaves, loss and gradients (its window
of 64 bites at 96 tokens), remat, ``ServeEngine``'s greedy tokens against
the reference's engine past the window, the paged engine's refusal, a
``Simulator`` run, and the two launchers on both new families.  The
reference's weights come across as numpy (``convert``); its outputs are
taken under ``jax.jit``.

Tolerances, fp32, set from the arithmetic: the scan is the same
recurrence in fp32 in both packages, but the products feeding it (in_proj,
x_proj, dt_proj) and the readout sum in other orders, about 1e-7 relative
a product, carried through up to 96 steps of a contracting recurrence;
outputs and states within 1e-5 of their largest magnitude, losses within
1e-5 relative, each gradient leaf within 2e-5 of its largest magnitude
(an explicit backward of the attention against autodiff, as in
tests/test_torch_lm.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.serve import GenerationConfig as JGen  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import HierAvgParams  # noqa: E402
from repro_torch.core import HierTopology, Simulator  # noqa: E402
from repro_torch.data.synthetic import (make_markov_task,  # noqa: E402
                                        markov_lm_batch)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.serve import (GenerationConfig, PagedServeEngine,  # noqa: E402
                               ServeEngine)
from repro_torch.tree import leaves, tree_map  # noqa: E402

OUT_REL, LOSS_REL, GRAD_REL = 1e-5, 1e-5, 2e-5
ARCH, SEQ = "hymba-1.5b", 96
D, CI, N = 64, 128, 8           # the Mamba tests' d_model, d_inner, state


@pytest.fixture(autouse=True)
def _one_thread():
    """Each test on one thread: the models here are small and their ops
    many, and under the suite's parallel workers each op's thread pool
    waits on the others' (a reduced-Hymba Simulator run took minutes
    there instead of seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close_rel(a, b, rel, what=""):
    a = np.asarray(a.detach().float().numpy()
                   if isinstance(a, torch.Tensor) else a, np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=0.0,
                               atol=rel * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


def _cfgs():
    return jget_config(ARCH).reduced(), get_config(ARCH).reduced()


_INIT = {}


def _jax_params():
    if not _INIT:
        jcfg, _ = _cfgs()
        _INIT["p"] = jax.tree.map(np.asarray, jax.jit(jbuild(jcfg).init)(
            jax.random.PRNGKey(0)))
    return _INIT["p"]


def _batch(vocab, lead, seq, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=lead + (seq + 1,)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# --------------------------------------------------------------------- #
# the Mamba head


def _mamba_case(seed=0):
    jp = jax.tree.map(np.asarray, jmamba.mamba_init(
        jax.random.PRNGKey(seed), D, CI, N))
    # a non-trivial conv bias and skip, so that every leaf is exercised
    rng = np.random.default_rng(seed)
    jp["conv_b"] = (0.1 * rng.standard_normal(CI)).astype(np.float32)
    jp["D"] = (1 + 0.1 * rng.standard_normal(CI)).astype(np.float32)
    return jp, convert.tree_from_numpy(jp, device="cpu")


def _states(rng, b):
    return ((0.5 * rng.standard_normal((b, CI, N))).astype(np.float32),
            rng.standard_normal((b, tmamba.CONV_K - 1, CI)).astype(
                np.float32))


@pytest.mark.parametrize("s,chunk,carried", [
    (32, 8, False), (32, 8, True),      # 4 chunks under remat
    (12, 8, False), (8, 8, True),       # one chunk (not a multiple; equal)
])
def test_mamba_apply_matches_reference(s, chunk, carried):
    """Outputs, the final state and the conv tail, and the gradients of
    a weighted sum of all three with respect to x, the carried states and
    every leaf."""
    jp, tp = _mamba_case()
    rng = np.random.default_rng(s + chunk)
    x = rng.standard_normal((2, s, D)).astype(np.float32)
    ss, cs = _states(rng, 2) if carried else (None, None)
    wy = rng.standard_normal((2, s, D)).astype(np.float32)
    wh = rng.standard_normal((2, CI, N)).astype(np.float32)
    wc = rng.standard_normal((2, tmamba.CONV_K - 1, CI)).astype(np.float32)

    def jfn(p, x, ss, cs):
        y, h, c = jmamba.mamba_apply(p, x, state=N, ssm_state=ss,
                                     conv_state=cs, chunk=chunk)
        return (y * wy).sum() + (h * wh).sum() + (c * wc).sum(), (y, h, c)

    args = (jp, x) + ((ss, cs) if carried else (None, None))
    argnums = (0, 1, 2, 3) if carried else (0, 1)
    (_, (jy, jh, jc)), jg = jax.jit(jax.value_and_grad(
        jfn, argnums=argnums, has_aux=True))(*args)

    tx = torch.from_numpy(x).requires_grad_()
    tss = torch.from_numpy(ss).requires_grad_() if carried else None
    tcs = torch.from_numpy(cs).requires_grad_() if carried else None
    for a in leaves(tp):
        a.requires_grad_()
    y, h, c = tmamba.mamba_apply(tp, tx, state=N, ssm_state=tss,
                                 conv_state=tcs, chunk=chunk)
    ((y * torch.from_numpy(wy)).sum() + (h * torch.from_numpy(wh)).sum()
     + (c * torch.from_numpy(wc)).sum()).backward()
    for what, a, b in (("y", y, jy), ("hT", h, jh), ("conv", c, jc)):
        _close_rel(a, b, OUT_REL, what)
    for key, a, b in zip(sorted(tp), leaves(tp), jax.tree.leaves(jg[0])):
        _close_rel(a.grad, b, GRAD_REL, f"grad {key}")
    _close_rel(tx.grad, jg[1], GRAD_REL, "grad x")
    if carried:
        _close_rel(tss.grad, jg[2], GRAD_REL, "grad ssm_state")
        _close_rel(tcs.grad, jg[3], GRAD_REL, "grad conv_state")


def test_mamba_decode_teacher_forced_equals_the_sequence():
    """Token by token from carried states, the decode gives the
    sequence's outputs, its final state and conv tail, as the reference's
    decode does."""
    jp, tp = _mamba_case(1)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 10, D)).astype(np.float32)
    ss, cs = _states(rng, 2)
    want, hT, tail = tmamba.mamba_apply(
        tp, torch.from_numpy(x), state=N, ssm_state=torch.from_numpy(ss),
        conv_state=torch.from_numpy(cs))
    st = {"ssm": torch.from_numpy(ss), "conv": torch.from_numpy(cs)}
    jst = {"ssm": ss, "conv": cs}
    jdec = jax.jit(lambda p, x, st: jmamba.mamba_decode(p, x, st, state=N))
    for t in range(x.shape[1]):
        y, st = tmamba.mamba_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                    st, state=N)
        jy, jst = jdec(jp, x[:, t:t + 1], jst)
        _close_rel(y, want[:, t:t + 1].detach(), OUT_REL, f"step {t}")
        _close_rel(y, jy, OUT_REL, f"reference step {t}")
    _close_rel(st["ssm"], hT.detach(), OUT_REL, "ssm")
    _close_rel(st["conv"], tail.detach(), OUT_REL, "conv")
    zero = tmamba.init_mamba_state(3, CI, N, device="cpu")
    assert zero["ssm"].shape == (3, CI, N) and zero["conv"].shape == \
        (3, tmamba.CONV_K - 1, CI) and not zero["ssm"].any()


def test_scan_under_vmap_grad_matches_a_loop_over_learners():
    """The trainer's vmap(grad) over learners (the scan's Function folds
    them into the batch; the chunks run under remat) against grad per
    learner, within 1e-6 relative (the projections batch into other
    products under vmap)."""
    _, tp = _mamba_case(2)
    stacked = tree_map(lambda a: torch.stack([a, a * 1.01]), tp)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 2, 32, D)).astype(np.float32))

    def loss(p, x):
        y, h, _ = tmamba.mamba_apply(p, x, state=N, chunk=8)
        return (y ** 2).sum() + h.sum()

    got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)))(stacked, x)
    for i in range(2):
        want = torch.func.grad(loss, argnums=(0, 1))(
            tree_map(lambda a: a[i], stacked), x[i])
        for a, b in zip(leaves(got), leaves(want)):
            _close_rel(a[i], b.numpy(), 1e-6, f"learner {i}")


@pytest.mark.parametrize("arch", [ARCH, "seamless-m4t-large-v2"])
def test_init_template_builds_full_width(arch):
    """core/simulator.py::init_template (FakeTensorMode, what --autotune
    prices plans from) builds both new families at published widths:
    the reference's leaf shapes, nothing allocated."""
    from repro.configs import get_config as jget
    from repro_torch.core.simulator import init_template
    want = jax.eval_shape(jbuild(jget(arch)).init, jax.random.PRNGKey(0))
    got = init_template(build(get_config(arch), device="cpu").init_train,
                        "cpu")
    assert [tuple(a.shape) for a in leaves(got)] == \
        [a.shape for a in jax.tree.leaves(want)]
    assert all(a.device.type == "meta" for a in leaves(got))


# --------------------------------------------------------------------- #
# the Hymba LM


def test_training_leaves_match_the_reference():
    """Paths, shapes, types and order of the training tree equal the
    reference's, from the port's init and through ``convert``, and a
    stack of the wrong depth is refused."""
    jcfg, cfg = _cfgs()
    jp = _jax_params()
    want = [(a.shape, a.dtype.name) for a in jax.tree.leaves(jp)]
    for tree in (build(cfg, device="cpu").init_train(
            torch.Generator().manual_seed(0)),
            convert.train_params_from_jax(jp, cfg, device="cpu")):
        assert sorted(tree) == sorted(jp)
        assert [(tuple(a.shape), str(a.dtype)[6:]) for a in leaves(tree)] \
            == want
    with pytest.raises(ValueError, match="config has 3 layers"):
        convert.train_params_from_jax(
            jp, dataclasses.replace(cfg, n_layers=3), device="cpu")
    with pytest.raises(ValueError, match="training tree"):
        convert.params_from_jax(jp, cfg, device="cpu")


def test_loss_and_gradients_match_jax():
    jcfg, cfg = _cfgs()
    assert 0 < cfg.sliding_window < SEQ
    jp = _jax_params()
    batch = _batch(jcfg.vocab_size, (2,), SEQ, 1)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        jbuild(jcfg).loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = convert.train_params_from_jax(jp, cfg, device="cpu")
    tg, (tl, tm) = torch.func.grad_and_value(
        build(cfg, device="cpu").loss_fn, has_aux=True)(params,
                                                        _torch(batch))
    _close_rel(tl, jl, LOSS_REL, "loss")
    _close_rel(tm["accuracy"], jm["accuracy"], LOSS_REL, "accuracy")
    assert sorted(tm) == sorted(jm)
    for i, (a, b) in enumerate(zip(leaves(tg), jax.tree.leaves(jg))):
        _close_rel(a, b, GRAD_REL, f"grad leaf {i}")


@pytest.fixture
def _deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("seq", [SEQ, 512])
def test_remat_is_bit_identical_under_vmap_grad(seq, _deterministic):
    """Two learners through the trainer's vmap(grad): the layers
    recomputed in the backward give the bits of the layers kept, at one
    scan chunk and at two (512 tokens: each chunk under remat inside the
    remat of its layer).  Deterministic algorithms pin the CPU's threaded
    embedding backward (tests/test_torch_remat.py)."""
    _, cfg = _cfgs()
    params = convert.train_params_from_jax(_jax_params(), cfg, device="cpu")
    stacked = tree_map(lambda a: torch.stack([a, a * 1.01]), params)
    batch = _torch(_batch(cfg.vocab_size, (2, 1), seq, 3))
    out = []
    for remat in (False, True):
        loss_fn = build(cfg, remat=remat, device="cpu").loss_fn
        out.append(torch.func.vmap(torch.func.grad(loss_fn, has_aux=True))(
            stacked, batch))
    (g0, m0), (g1, m1) = out
    assert all(torch.equal(a, b) for a, b in zip(leaves(g0), leaves(g1)))
    assert all(torch.equal(m0[k], m1[k]) for k in m0)


NEW = 6


def test_serve_engine_greedy_matches_reference():
    """Both engines on the reference's weights (fp32 cache): one wave of
    prompts padded to 128 tokens, past the 64-token window (the rolling
    cache keeps the last 64 and the decode's RoPE position is its count,
    as the reference's), and one of 16.  Tokens, steps and the
    prefill caches of the first wave agree."""
    jcfg, cfg = _cfgs()
    jb = jbuild(jcfg, cache_dtype=jnp.float32)
    jp = jax.tree.map(jnp.asarray, _jax_params())
    tb = build(cfg, cache_dtype=torch.float32, device="cpu")
    tp = convert.train_params_from_jax(_jax_params(), cfg, device="cpu")
    rng = np.random.default_rng(3)
    reqs = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in (9, 70, 12)]
    max_len = 128 + NEW
    jres = JEngine(jb, jp, max_len=max_len, gen=JGen(max_new_tokens=NEW)
                   ).serve_queue(reqs, slots=2)
    teng = ServeEngine(tb, tp, max_len=max_len,
                       gen=GenerationConfig(max_new_tokens=NEW))
    tres = teng.serve_queue(reqs, slots=2)
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert (t.steps, t.decode_steps) == (j.steps, j.decode_steps)
    assert teng.prefill_traces == teng.decode_traces == 2
    prompts = np.stack([np.pad(r, (128 - len(r), 0)) for r in reqs[:2]])
    _, jc = jax.jit(jb.prefill)(jp, {"tokens": jnp.asarray(prompts)})
    _, tc = tb.prefill(tp, {"tokens": torch.from_numpy(prompts)})
    for i, lc in enumerate(tc):
        assert lc["kv"]["pos"] == int(jc["kv"]["pos"][i]) == \
            cfg.sliding_window
        for name, a, b in (("k", lc["kv"]["k"], jc["kv"]["k"][i]),
                           ("v", lc["kv"]["v"], jc["kv"]["v"][i]),
                           ("ssm", lc["ssm"], jc["ssm"][i]),
                           ("conv", lc["conv"], jc["conv"][i])):
            _close_rel(a, b, OUT_REL, f"layer {i} {name}")
    with pytest.raises(ValueError, match="use ServeEngine"):
        PagedServeEngine(tb, tp, max_len=max_len)


def test_hier_avg_trains_reduced_hymba():
    """The port's counterpart of tests/test_system.py::
    test_hier_avg_trains_reduced_lm: the Simulator on (1, 2, 2) lowers
    the eval loss of reduced Hymba on a Markov task within 6 rounds."""
    _, cfg = _cfgs()
    bundle = build(cfg, device="cpu")
    logits, _ = make_markov_task(cfg.vocab_size, temperature=2.0,
                                 device="cpu")

    def sample(gen, n):
        return markov_lm_batch(gen, n, 16, logits)

    sim = Simulator(bundle.loss_fn, bundle.init_train, sample,
                    topo=HierTopology(1, 2, 2),
                    hier=HierAvgParams(k1=2, k2=4), optimizer=sgd(0.5),
                    per_learner_batch=4, seed=0, device="cpu",
                    eval_batch=sample(torch.Generator().manual_seed(77), 32))
    r = sim.run(6)
    assert np.isfinite(r.eval_losses).all()
    assert r.eval_losses[-1] < r.eval_losses[0] - 0.05


@pytest.mark.parametrize("arch", [ARCH, "seamless-m4t-large-v2"])
def test_train_and_serve_clis_run_each_new_family(arch, capsys):
    """launch/train.py one round and launch/serve.py one queue on the
    CPU (the encoder-decoder serves on stub frames from --seed); the
    paged engine refuses both families with its own message."""
    ttrain.main(["--arch", arch, "--rounds", "1", "--learners", "4", "--s",
                 "2", "--batch", "2", "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced device=cpu" in out
    line = [ln for ln in out.splitlines() if ln.startswith("round   0")][0]
    loss = float(line.split("loss=")[1].split()[0])
    assert np.isfinite(loss) and abs(loss - np.log(512)) < 1.0
    tserve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                 "--prompt-len", "8", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out
    assert "steady-state: engine=dense" in out
    with pytest.raises(ValueError, match="use ServeEngine"):
        tserve.main(["--arch", arch, "--device", "cpu", "--paged"])
