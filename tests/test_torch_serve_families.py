"""Serving of every family the port trains, against the JAX package.

Reduced configs, fp32 params and caches, the reference's weights carried
across (``tests/test_torch_serve_dense.py::pair``).  Here: the port's
paged and dense paths give the same greedy tokens (the reference's
``tests/test_paged.py::test_paged_greedy_matches_dense``, on the port),
the RWKV-6 states of ``init_cache``, ``prefill`` and ``decode_step``
against the reference's within ``tests/test_torch_lm.py``'s limits, the
MLA latent caches (dense, and paged after a chunk and after a decode
step) against the reference's, the paged engine on the MoE, MLA and
M-RoPE decoders against the reference's engine, token for token, and the
cache accounting (``serve/kvcache.py``) of the latent, rolling and RWKV
caches against the reference's and against what ``init_cache``
allocates.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serve import GenerationConfig as JGen  # noqa: E402
from repro.serve import PagedServeEngine as JPaged  # noqa: E402
from repro_torch.serve import (GenerationConfig,  # noqa: E402
                               PagedServeEngine, pages_for)
from test_torch_serve_dense import TOL, pair  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6           # tests/test_torch_lm.py's state limits


def _greedy(logits):
    return torch.argmax(logits, -1).to(torch.int32)


@pytest.mark.parametrize("arch", ["yi-34b", "starcoder2-15b", "qwen2-vl-2b",
                                  "deepseek-v2-lite-16b"])
def test_paged_greedy_matches_dense(arch):
    """Chunked paged prefill and paged decode give the dense path's greedy
    tokens (fp32 caches; a dropless capacity factor for the MoE, whose
    routing groups the chunks would otherwise change)."""
    *_, tc, tb, tp = pair(arch, dropless="deepseek" in arch)
    B, PLEN, NEW, PAGE, CHUNK = 2, 9, 5, 8, 4
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, tc.vocab_size, size=(B, PLEN)).astype(np.int32))

    logits, cache = tb.prefill(tp, {"tokens": prompts, "max_len": 64})
    tok = _greedy(logits)
    dense = [tok]
    for _ in range(NEW - 1):
        logits, cache = tb.decode_step(tp, tok, cache)
        tok = _greedy(logits)
        dense.append(tok)

    maxp = pages_for(PLEN + NEW + CHUNK, PAGE)
    pages = tb.init_paged_cache(1 + B * maxp, PAGE)
    tables = torch.arange(1, 1 + B * maxp, dtype=torch.int32).reshape(B,
                                                                      maxp)
    padded = -(-PLEN // CHUNK) * CHUNK
    ptoks = torch.nn.functional.pad(prompts, (0, padded - PLEN))
    for c0 in range(0, padded, CHUNK):
        lg, pages = tb.prefill_paged_chunk(tp, ptoks[:, c0:c0 + CHUNK],
                                           pages, tables, c0)
        if c0 <= PLEN - 1 < c0 + CHUNK:
            last = lg[:, PLEN - 1 - c0]
    tok = _greedy(last)
    paged = [tok]
    lengths = torch.full((B,), PLEN, dtype=torch.int32)
    active = torch.ones((B,), dtype=torch.bool)
    for _ in range(NEW - 1):
        lg, pages = tb.decode_step_paged(tp, tok, pages, tables, lengths,
                                         active)
        tok = _greedy(lg)
        paged.append(tok)
        lengths = lengths + 1
    np.testing.assert_array_equal(torch.stack(dense, 1).numpy(),
                                  torch.stack(paged, 1).numpy())


def test_rwkv_states_match_reference():
    """``init_cache`` (zeros), then ``prefill`` of 24 tokens through the
    WKV recurrence from the cache's state, then 4 decode steps: every
    layer's two shifts and WKV state against the reference's within
    ATOL + RTOL x the state's largest value (an element of a sum that
    cancels keeps the rounding of its largest terms: the WKV state reads
    3.1e-6 apart on an element of 4e-4, in a state of magnitude 3.7), and
    the logits within TOL."""
    jc, jb, jp, tc, tb, tp = pair("rwkv6-1.6b")
    jzero, tzero = jb.init_cache(2), tb.init_cache(2)
    assert len(tzero) == tc.n_layers
    for name in ("tm_shift", "wkv", "cm_shift"):
        assert tuple(tzero[0][name].shape) == jzero[name].shape[1:]
        assert not any(c[name].any() for c in tzero)
    toks = np.random.default_rng(2).integers(
        0, jc.vocab_size, size=(2, 24)).astype(np.int32)

    def same(jl, jcache, tl, tcache):
        # logits at the decoders' limit: a 512-wide product after the
        # states, summed in other orders by XLA and ATen
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for i, c in enumerate(tcache):
            for name in ("tm_shift", "wkv", "cm_shift"):
                assert c[name].dtype == torch.float32
                want = np.asarray(jcache[name][i])
                np.testing.assert_allclose(
                    c[name].numpy(), want, rtol=0.0,
                    atol=ATOL + RTOL * np.abs(want).max(),
                    err_msg=f"layer {i} {name}")

    jl, jcache = jax.jit(jb.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = tb.prefill(tp, {"tokens": torch.from_numpy(toks)})
    same(jl, jcache, tl, tcache)
    jdecode = jax.jit(jb.decode_step)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(4):
        jl, jcache = jdecode(jp, jnp.asarray(tok), jcache)
        tl, tcache = tb.decode_step(tp, torch.from_numpy(tok), tcache)
        same(jl, jcache, tl, tcache)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_mla_latent_caches_match_reference():
    """deepseek-v2-lite: the dense latent cache after a prefill and a
    decode step, and the latent pages after a 16-token chunk and after a
    decode step over two slots, one inactive (its write goes to the null
    page, which is left out)."""
    jc, jb, jp, tc, tb, tp = pair("deepseek-v2-lite-16b")
    toks = np.random.default_rng(4).integers(
        0, jc.vocab_size, size=(2, 16)).astype(np.int32)

    jl, jcache = jax.jit(lambda p, t: jb.prefill(
        p, {"tokens": t, "max_len": 24}))(jp, jnp.asarray(toks))
    tl, tcache = tb.prefill(tp, {"tokens": torch.from_numpy(toks),
                                 "max_len": 24})
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jl, jcache = jax.jit(jb.decode_step)(jp, jnp.asarray(tok), jcache)
    tl, tcache = tb.decode_step(tp, torch.from_numpy(tok), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i, c in enumerate(tcache):
        assert c["pos"] == int(jcache["pos"][i]) == 17
        for name in ("ckv", "k_rope"):
            np.testing.assert_allclose(c[name].numpy(),
                                       np.asarray(jcache[name][i]), **TOL)

    page, maxp = 8, 3
    n_pages = 1 + 2 * maxp
    tables = np.arange(n_pages - 1, 0, -1, dtype=np.int32).reshape(2, maxp)
    jpages = jb.init_paged_cache(n_pages, page)
    tpages = tb.init_paged_cache(n_pages, page)

    def same_pages():
        for i, pg in enumerate(tpages):
            for name in ("ckv", "kr"):
                np.testing.assert_allclose(
                    pg[name][1:].numpy(), np.asarray(jpages[name][i][1:]),
                    **TOL)

    jl, jpages = jax.jit(jb.prefill_paged_chunk)(
        jp, jnp.asarray(toks[:1]), jpages, jnp.asarray(tables[:1]),
        jnp.asarray(0, jnp.int32))
    tl, tpages = tb.prefill_paged_chunk(tp, torch.from_numpy(toks[:1]),
                                        tpages, torch.from_numpy(tables[:1]),
                                        0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    same_pages()
    tok = np.array([int(np.argmax(np.asarray(jl)[0, -1])), 0], np.int32)
    lengths = np.array([16, 0], np.int32)
    active = np.array([True, False])
    jl, jpages = jax.jit(jb.decode_step_paged)(
        jp, jnp.asarray(tok), jpages, jnp.asarray(tables),
        jnp.asarray(lengths), jnp.asarray(active))
    tl, tpages = tb.decode_step_paged(
        tp, torch.from_numpy(tok), tpages, torch.from_numpy(tables),
        torch.from_numpy(lengths), torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    same_pages()


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "phi3.5-moe-42b-a6.6b", "qwen2-vl-2b"])
def test_paged_engine_matches_reference(arch):
    """The paged engines on the MoE, MLA and M-RoPE decoders at the
    configs' own capacity factors (both route the same chunks): tokens,
    decode steps, refills and the pool's high-water mark."""
    jc, jb, jp, tc, tb, tp = pair(arch)
    rng = np.random.default_rng(6)
    reqs = [rng.integers(0, jc.vocab_size, size=n).astype(np.int32)
            for n in (5, 27, 12, 19)]
    budgets = [6, 3, 7, 4]
    kw = dict(slots=2, page_size=8, max_len=48, prefill_chunk=16)
    jeng = JPaged(jb, jp, cache_dtype=jnp.float32,
                  gen=JGen(max_new_tokens=8), **kw)
    teng = PagedServeEngine(tb, tp, cache_dtype=torch.float32,
                            gen=GenerationConfig(max_new_tokens=8), **kw)
    jres = jeng.serve_queue(reqs, max_new=budgets)
    tres = teng.serve_queue(reqs, max_new=budgets)
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert (t.steps, t.decode_steps) == (j.steps, j.decode_steps)
    assert teng.refill_events == jeng.refill_events > 0
    assert teng.alloc.peak_in_use == jeng.alloc.peak_in_use
    assert teng.alloc.free_pages == teng.alloc.n_pages - 1


@pytest.mark.parametrize("arch", ["yi-34b", "starcoder2-15b",
                                  "deepseek-v2-lite-16b", "qwen2-vl-2b",
                                  "rwkv6-1.6b"])
@pytest.mark.parametrize("rolling", [False, True])
def test_cache_accounting_of_latent_and_rolling_caches(arch, rolling):
    """``cache_bytes``, ``describe_cache`` and ``pool_pages`` against the
    reference's for the MLA latent cache, the rolling window and the
    RWKV state, at full configs."""
    from repro.configs import get_config as jget_config
    from repro.serve import kvcache as jkv
    from repro_torch.configs import get_config
    from repro_torch.serve import kvcache as tkv
    jc, tc = jget_config(arch), get_config(arch)
    assert tkv.cache_bytes(tc, 3, 20000, rolling=rolling) == \
        jkv.cache_bytes(jc, 3, 20000, rolling=rolling)
    assert tkv.describe_cache(tc, 3, 20000, rolling=rolling) == \
        jkv.describe_cache(jc, 3, 20000, rolling=rolling)
    assert tkv.pool_pages(tc, 16, slots=3, max_len=20000) == \
        jkv.pool_pages(jc, 16, slots=3, max_len=20000)


@pytest.mark.parametrize("arch,rolling", [("deepseek-v2-lite-16b", False),
                                          ("yi-34b", True),
                                          ("starcoder2-15b", False),
                                          ("rwkv6-1.6b", False)])
def test_dense_cache_allocation_matches_its_accounting(arch, rolling):
    """The bytes ``init_cache`` allocates are ``cache_bytes``' count (the
    RWKV state is fp32 whatever the cache type)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.serve import cache_bytes
    cfg = get_config(arch).reduced()
    bundle = build(cfg, rolling_decode=rolling, device="meta")
    cache = bundle.init_cache(3, 300)
    nbytes = sum(t.numel() * t.element_size() for c in cache
                 for t in c.values() if isinstance(t, torch.Tensor))
    assert nbytes == cache_bytes(cfg, 3, 300, rolling=rolling)
