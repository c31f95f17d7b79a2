"""The port's decoder against the JAX package's, on the same weights.

Config: starcoder2-15b ``.reduced()`` with ``n_kv_heads=2`` (G = 2,
sliding window 64), fp32 params and an fp32 cache; the paged serving test
also runs yi-34b and deepseek-67b ``.reduced()`` as they are (G = 1, no
window).  The reference's
weights come across through ``repro_torch.convert.params_from_jax``; the
reference's outputs are taken under ``jax.jit``.  Logits agree within
atol/rtol 1e-4: XLA and ATen sum in different orders.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.serve import GenerationConfig  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
PAGE, CHUNK, NEW = 8, 16, 6


def _cfgs():
    jc = dataclasses.replace(jget_config("starcoder2-15b").reduced(),
                             n_kv_heads=2)
    tc = dataclasses.replace(get_config("starcoder2-15b").reduced(),
                             n_kv_heads=2)
    assert jc.sliding_window == tc.sliding_window == 64
    return jc, tc


@pytest.fixture(scope="module")
def pair():
    return _pair(*_cfgs())


def _pair(jc, tc):
    jb = jbuild(jc, cache_dtype=jnp.float32, decode_impl="xla")
    np_params = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(0)))
    tb = build(tc, cache_dtype=torch.float32, device="cpu")
    model = tb.init()
    model.load_state_dict(params_from_jax(np_params, tc, device="cpu"))
    return jc, jb, np_params, tc, tb, model


def test_params_from_jax_copies_every_leaf_exactly(pair):
    jc, _, np_params, tc, _, model = pair
    sd = model.state_dict()
    leaves = jax.tree_util.tree_leaves_with_path(np_params)
    n = 0
    for path, leaf in leaves:
        keys = [p.key for p in path]
        if keys[0] == "layers":
            for i in range(tc.n_layers):
                name = ".".join(["layers", str(i)] + keys[1:])
                np.testing.assert_array_equal(sd[name].numpy(), leaf[i])
                n += 1
        else:
            np.testing.assert_array_equal(sd[".".join(keys)].numpy(), leaf)
            n += 1
    assert n == len(sd)


def test_params_from_jax_keeps_bf16_bits():
    jc, tc = _cfgs()
    jb = jbuild(jc, param_dtype=jnp.bfloat16)
    np_params = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(1)))
    sd = params_from_jax(np_params, tc, device="cpu")
    w = sd["layers.1.attn.wq"]
    assert w.dtype == torch.bfloat16
    want = np_params["layers"]["attn"]["wq"][1].astype(np.float32)
    np.testing.assert_array_equal(w.float().numpy(), want)


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = jcommon.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    out = common.rmsnorm(torch.from_numpy(scale), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 5000, size=(2, 7)).astype(np.int32)
    jcos, jsin = jcommon.rope_cos_sin(jnp.asarray(pos), 32, 1e4)
    want = jcommon.apply_rope(jnp.asarray(x), jcos[:, :, None],
                              jsin[:, :, None])
    cos, sin = common.rope_cos_sin(torch.from_numpy(pos), 32, 1e4)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-4)
    out = common.apply_rope(torch.from_numpy(x), cos[:, :, None],
                            sin[:, :, None])
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_mlp_matches_jax(act):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    jp = jmlp.mlp_init(jax.random.PRNGKey(3), 32, 64, act)
    m = mlp.mlp_init(32, 64, act, device="cpu")
    for k, v in jp.items():
        getattr(m, k).data.copy_(torch.from_numpy(np.array(v)))
    want = jmlp.mlp_apply(jp, jnp.asarray(x), act)
    with torch.no_grad():
        out = mlp.mlp_apply(m, torch.from_numpy(x), act)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


def test_paged_prefill_and_decode_match_jax(pair):
    """Two prompts (70 and 37 tokens) prefilled in 16-token chunks, so the
    64-token window bites, then 6 teacher-forced decode steps over three
    slots, the last one inactive: it holds pages, as a slot mid-prefill
    does, and its writes must go to the null page instead."""
    _paged_run(pair)


@pytest.mark.parametrize("arch", ["yi-34b", "deepseek-67b"])
def test_paged_prefill_and_decode_match_jax_dense_decoders(arch):
    """The run of test_paged_prefill_and_decode_match_jax on the other
    dense GQA decoders, at their reduced configs."""
    _paged_run(_pair(jget_config(arch).reduced(),
                     get_config(arch).reduced()))


def _paged_run(pair):
    jc, jb, np_params, tc, tb, model = pair
    jparams = jax.tree.map(jnp.asarray, np_params)
    rng = np.random.default_rng(4)
    plens = [70, 37]
    prompts = [rng.integers(0, jc.vocab_size, size=n).astype(np.int32)
               for n in plens]
    slots = 3
    maxp = -(-(max(plens) + NEW + CHUNK) // PAGE)
    n_pages = 1 + slots * maxp
    tables = np.zeros((slots, maxp), np.int32)
    ids = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    for i in range(slots):      # the inactive slot holds pages too, as a
        tables[i] = ids[i * maxp:(i + 1) * maxp]   # slot mid-prefill does

    jprefill = jax.jit(jb.prefill_paged_chunk)
    jdecode = jax.jit(jb.decode_step_paged)
    jpages = jb.init_paged_cache(n_pages, PAGE)
    tpages = tb.init_paged_cache(n_pages, PAGE)
    first = []
    with torch.no_grad():
        for i, prompt in enumerate(prompts):
            padded = -(-len(prompt) // CHUNK) * CHUNK
            toks = np.zeros((1, padded), np.int32)
            toks[0, :len(prompt)] = prompt
            for c0 in range(0, padded, CHUNK):
                chunk = toks[:, c0:c0 + CHUNK]
                jl, jpages = jprefill(jparams, jnp.asarray(chunk), jpages,
                                      jnp.asarray(tables[i:i + 1]),
                                      jnp.asarray(c0, jnp.int32))
                tl, tpages = tb.prefill_paged_chunk(
                    model, torch.from_numpy(chunk), tpages,
                    torch.from_numpy(tables[i:i + 1]), c0)
                np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
                if c0 <= len(prompt) - 1 < c0 + CHUNK:
                    first.append(int(jnp.argmax(jl[0, len(prompt) - 1 - c0])))

        tok = np.array(first + [0], np.int32)
        lengths = np.array(plens + [0], np.int32)
        active = np.array([True, True, False])
        for _ in range(NEW):
            jl, jpages = jdecode(jparams, jnp.asarray(tok), jpages,
                                 jnp.asarray(tables), jnp.asarray(lengths),
                                 jnp.asarray(active))
            tl, tpages = tb.decode_step_paged(
                model, torch.from_numpy(tok), tpages,
                torch.from_numpy(tables), torch.from_numpy(lengths),
                torch.from_numpy(active))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            tok[~active] = 0
            lengths = lengths + active
    # the pools agree too (page 0 excluded: duplicate writes land there)
    for layer in range(tc.n_layers):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                tpages[layer][name][:, 1:].numpy(),
                np.asarray(jpages[name][layer][:, 1:]), **TOL)


def test_every_family_builds_and_serves():
    """Every family builds and trains.  The MoE, MLA and VLM decoders
    serve through both engines (their parity with the reference is
    ``tests/test_torch_serve_families.py``'s); the Hymba LM and the
    encoder-decoder serve through ``ServeEngine`` (the encoder-decoder
    with its frames) and the paged engine refuses them, as the
    reference's does (their parity: ``tests/test_torch_hymba.py`` and
    ``tests/test_torch_encdec.py``)."""
    from repro_torch.models.stubs import audio_frame_embeds
    from repro_torch.serve.engine import PagedServeEngine, ServeEngine
    gen = GenerationConfig(max_new_tokens=4)
    prompts = np.arange(1, 19, dtype=np.int32).reshape(2, 9)
    for arch in ("hymba-1.5b", "seamless-m4t-large-v2"):
        cfg = get_config(arch).reduced()
        bundle = build(cfg, device="cpu")
        params = bundle.init_train(torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="use ServeEngine"):
            PagedServeEngine(bundle, params, max_len=32, gen=gen)
        extras = {"frames": audio_frame_embeds(
            torch.Generator().manual_seed(1), 2, 8, cfg.d_model)} \
            if cfg.is_encoder_decoder else None
        toks = ServeEngine(bundle, params, max_len=32, gen=gen).generate(
            prompts, extras)
        assert toks.shape == (2, 4) and (toks < cfg.vocab_size).all()
    reqs = [np.arange(1, 10, dtype=np.int32), np.arange(3, 8,
                                                        dtype=np.int32)]
    for arch in ("deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b",
                 "qwen2-vl-2b"):
        cfg = get_config(arch).reduced()
        bundle = build(cfg, device="cpu")
        assert bundle.init_train(torch.Generator().manual_seed(0))
        params = bundle.init()
        if cfg.first_k_dense:
            assert len(params.layers_dense) == cfg.first_k_dense
        dense = ServeEngine(bundle, params, max_len=32, gen=gen)
        paged = PagedServeEngine(bundle, params, max_len=32, page_size=8,
                                 prefill_chunk=8, gen=gen)
        for eng in (dense, paged):
            res = eng.serve_queue(reqs)
            assert [r.steps for r in res] == [4, 4]
            assert all(((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()
                       for r in res)
