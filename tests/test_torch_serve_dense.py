"""The port's wave-batched ``ServeEngine`` against the JAX package's.

Both engines serve the same seeded requests on the same weights (the
archs' ``.reduced()`` configs, fp32 params, an fp32 cache; the reference
under its own jit, ``decode_impl="xla"``; the port on the CPU through
the plain kernel versions): greedy tokens, per-request decode steps and
the summary rows must be identical.  Mixed prompt lengths put two waves
into different power-of-two buckets, left-padded with token 0.  Also: the
rolling cache against the reference's (contents and tokens, past the
point where the buffer wraps), the ``serve_step``/``serve_summary`` rows
of both engines, and the paged engine's refusal of the RWKV LM.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import stubs as jstubs  # noqa: E402
from repro.serve import GenerationConfig as JGen  # noqa: E402
from repro.serve import PagedServeEngine as JPaged  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.telemetry import MetricsLogger as JLogger  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (params_from_jax,  # noqa: E402
                                 train_params_from_jax)
from repro_torch.models import build  # noqa: E402
from repro_torch.serve import (GenerationConfig, PagedServeEngine,  # noqa: E402
                               ServeEngine)
from repro_torch.telemetry import MetricsLogger  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
NEW = 6
WALL = ("wall_s", "tokens_per_s")


def pair(arch, *, dropless=False, **kw):
    """(reference config, bundle, params; port config, bundle, params) on
    the reference's weights."""
    jc, tc = jget_config(arch).reduced(), get_config(arch).reduced()
    if dropless:
        cf = float(jc.n_experts) / jc.top_k
        jc = dataclasses.replace(jc, capacity_factor=cf)
        tc = dataclasses.replace(tc, capacity_factor=cf)
    jb = jbuild(jc, cache_dtype=jnp.float32, decode_impl="xla", **kw)
    jp = jax.jit(jb.init)(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jp)
    tb = build(tc, cache_dtype=torch.float32, device="cpu", **kw)
    if tc.family == "ssm":
        tp = train_params_from_jax(np_params, tc, device="cpu")
    else:
        tp = tb.init()
        tp.load_state_dict(params_from_jax(np_params, tc, device="cpu"))
    return jc, jb, jp, tc, tb, tp


def _requests(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _same_results(jres, tres):
    assert [r.request_id for r in tres] == [r.request_id for r in jres]
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        np.testing.assert_array_equal(t.prompt, j.prompt)
        assert (t.steps, t.decode_steps) == (j.steps, j.decode_steps)


def _same_rows(jrows, trows):
    jrows, trows = list(jrows), list(trows)
    assert len(trows) == len(jrows) > 0
    for j, t in zip(jrows, trows):
        assert {k: v for k, v in t.items() if k not in WALL} == \
            {k: v for k, v in j.items() if k not in WALL}


# --------------------- greedy tokens, engine for engine ---------------- #

@pytest.mark.parametrize("arch,lens,dropless", [
    ("yi-34b", [5, 12, 9], False),
    # the second wave's 70 tokens go past the 64-token window
    ("starcoder2-15b", [7, 11, 70], False),
    ("qwen2-vl-2b", [9, 4, 13], False),
    ("deepseek-v2-lite-16b", [6, 10, 9], True),
    ("phi3.5-moe-42b-a6.6b", [8, 5, 11], False),
    ("rwkv6-1.6b", [9, 16, 3], False),
])
def test_dense_engine_greedy_matches_reference(arch, lens, dropless):
    jc, jb, jp, tc, tb, tp = pair(arch, dropless=dropless)
    reqs = _requests(jc.vocab_size, lens)
    budgets = [NEW, 3, NEW - 1]
    max_len = 128 + NEW
    jl, tl = JLogger(), MetricsLogger()
    jeng = JEngine(jb, jp, max_len=max_len, gen=JGen(max_new_tokens=NEW),
                   metrics=jl)
    teng = ServeEngine(tb, tp, max_len=max_len,
                       gen=GenerationConfig(max_new_tokens=NEW), metrics=tl)
    jres = jeng.serve_queue(reqs, slots=2, max_new=budgets)
    tres = teng.serve_queue(reqs, slots=2, max_new=budgets)
    _same_results(jres, tres)
    assert all(r.decode_steps == NEW - 1 for r in tres)
    assert teng.prefill_traces == 2 and teng.decode_traces == 2
    assert sorted(teng.finish_times) == [0, 1, 2]
    _same_rows(jl.rows("serve_summary"), tl.rows("serve_summary"))
    assert teng.steady_state_summary()["engine"] == "dense"


def test_dense_engine_vision_stub_prefill_matches_reference():
    """qwen2-vl through ``generate`` with the stub's patch embeddings and
    M-RoPE positions in front of the text (the reference's
    ``_embed_batch``); the decode continues from the cache's length."""
    jc, jb, jp, tc, tb, tp = pair("qwen2-vl-2b")
    rng = np.random.default_rng(7)
    nv, st = 16, 10
    toks = rng.integers(0, jc.vocab_size, size=(2, st)).astype(np.int32)
    vis = (0.02 * rng.standard_normal((2, nv, jc.d_model))).astype(
        np.float32)
    pos = np.array(np.broadcast_to(
        np.asarray(jstubs.mrope_positions(1, nv, st))[0], (2, nv + st, 3)))
    jeng = JEngine(jb, jp, max_len=64, gen=JGen(max_new_tokens=NEW))
    teng = ServeEngine(tb, tp, max_len=64,
                       gen=GenerationConfig(max_new_tokens=NEW))
    want = jeng.generate(jnp.asarray(toks), {
        "vision_embeds": jnp.asarray(vis), "positions": jnp.asarray(pos)})
    got = teng.generate(toks, {"vision_embeds": torch.from_numpy(vis),
                               "positions": torch.from_numpy(pos)})
    np.testing.assert_array_equal(got, np.asarray(want))
    # the vision tokens change the answer
    assert not np.array_equal(got, teng.generate(toks))


# --------------------------- rolling cache ----------------------------- #

def test_rolling_cache_matches_reference():
    """yi-34b with ``rolling_decode``: a 120-token prompt in the
    128-position buffer, then 14 decode steps, so the buffer wraps.  The
    caches agree after the prefill and after the steps, and the engines'
    greedy tokens agree (compare the reference's
    ``test_rolling_window_decode_bounded_cache``)."""
    jc, jb, jp, tc, tb, tp = pair("yi-34b", rolling_decode=True)
    w = tc.long_context_window
    prompt = _requests(jc.vocab_size, [120], seed=9)[0][None]
    jlg, jcache = jax.jit(jb.prefill)(
        jp, {"tokens": jnp.asarray(prompt)})
    tlg, tcache = tb.prefill(tp, {"tokens": torch.from_numpy(prompt),
                                  "max_len": 4096})
    assert tcache[0]["k"].shape[1] == w == jcache["k"].shape[2]

    def same(jcache, tcache):
        assert all(c["pos"] == int(p) for c, p in zip(tcache, jcache["pos"]))
        for i, c in enumerate(tcache):
            for name in ("k", "v"):
                np.testing.assert_allclose(c[name].numpy(),
                                           np.asarray(jcache[name][i]),
                                           **TOL)

    same(jcache, tcache)
    jdecode = jax.jit(jb.decode_step)
    tok = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
    for _ in range(14):
        jlg, jcache = jdecode(jp, jnp.asarray(tok), jcache)
        tlg, tcache = tb.decode_step(tp, torch.from_numpy(tok), tcache)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
        tok = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
    assert tcache[0]["pos"] > w
    same(jcache, tcache)

    reqs = _requests(jc.vocab_size, [120, 100], seed=10)
    jres = JEngine(jb, jp, max_len=136, gen=JGen(max_new_tokens=12)
                   ).serve_queue(reqs, slots=2)
    tres = ServeEngine(tb, tp, max_len=136,
                       gen=GenerationConfig(max_new_tokens=12)
                       ).serve_queue(reqs, slots=2)
    _same_results(jres, tres)


# ------------------------ telemetry and refusals ----------------------- #

def test_paged_engine_rows_match_reference():
    """One serve_step row per decode step and one serve_summary row per
    queue, key for key and value for value (wall times aside), on
    starcoder2-15b with per-request budgets and a slot refill."""
    jc, jb, jp, tc, tb, tp = pair("starcoder2-15b")
    reqs = _requests(jc.vocab_size, [5, 30, 12, 21])
    budgets = [6, 3, 7, 4]
    kw = dict(slots=2, page_size=8, max_len=64, prefill_chunk=16)
    jl, tl = JLogger(), MetricsLogger()
    JPaged(jb, jp, cache_dtype=jnp.float32, gen=JGen(max_new_tokens=8),
           metrics=jl, **kw).serve_queue(reqs, max_new=budgets)
    teng = PagedServeEngine(tb, tp, cache_dtype=torch.float32,
                            gen=GenerationConfig(max_new_tokens=8),
                            metrics=tl, **kw)
    teng.serve_queue(reqs, max_new=budgets)
    steps = list(tl.rows("serve_step"))
    assert len(steps) == teng.decode_calls
    _same_rows(jl.rows("serve_step"), steps)
    _same_rows(jl.rows("serve_summary"), tl.rows("serve_summary"))
    assert list(tl.rows("serve_summary"))[0]["refill_events"] > 0


def test_paged_engine_refuses_rwkv():
    _, tc = jget_config("rwkv6-1.6b"), get_config("rwkv6-1.6b").reduced()
    bundle = build(tc, device="cpu")
    assert bundle.decode_step_paged is None
    with pytest.raises(ValueError, match="use ServeEngine"):
        PagedServeEngine(bundle, bundle.init())
