"""The port's encoder-decoder (SeamlessM4T-style, stub audio frames)
against the JAX package's.

Non-causal, extra-masked and cross-attention against the reference's
``full_attention`` / ``cross_attention``; the reduced model's leaves,
loss and gradients, remat, the reference's property that the last frame
reaches the loss, the prefill's caches (self K/V, cross K/V) and
``ServeEngine``'s greedy tokens against the reference's engine on the
same frames, the paged engine's refusal, and the audio batch contract of
``make_train_batch``.  The reference's weights come across as numpy
(``convert``); its outputs are taken under ``jax.jit``.

Tolerances, fp32, those of tests/test_torch_lm.py: attention outputs and
caches within 1e-5 of their largest magnitude (XLA and ATen sum the
products in other orders), losses within 1e-5 relative, each gradient
leaf within 2e-5 of its largest magnitude.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import stubs as jstubs  # noqa: E402
from repro.serve import GenerationConfig as JGen  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import stubs as tstubs  # noqa: E402
from repro_torch.serve import (GenerationConfig, PagedServeEngine,  # noqa: E402
                               ServeEngine)
from repro_torch.tree import leaves, tree_map  # noqa: E402

OUT_REL, LOSS_REL, GRAD_REL = 1e-5, 1e-5, 2e-5
ARCH, SEQ, FRAMES = "seamless-m4t-large-v2", 24, 12


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


def _batch(d, lead, seq, frames, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, size=lead + (seq + 1,)).astype(np.int32)
    return {"frames": (0.5 * rng.standard_normal(lead + (frames, d))
                       ).astype(np.float32),
            "tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# --------------------------------------------------------------------- #
# attention


@pytest.mark.parametrize("masked", [False, True])
def test_noncausal_and_cross_attention_match_reference(masked):
    """Non-causal GQA (group 2), causal with an extra mask, and the
    decoder's cross-attention over precomputed encoder K/V, with and
    without a frame mask (each row keeps at least one frame)."""
    rng = np.random.default_rng(int(masked))
    b, s, t, hq, hkv, d = 2, 9, 14, 4, 2, 32
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    q, k, v = n(b, s, hq, d), n(b, t, hkv, d), n(b, t, hkv, d)
    enc_mask = rng.random((b, t)) < 0.6 if masked else None
    if masked:
        enc_mask[:, 0] = True
    extra = None if enc_mask is None else \
        np.broadcast_to(enc_mask[:, None, None, :], (b, 1, s, t)).copy()
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tx = None if extra is None else torch.from_numpy(extra)
    for causal in (False, True):
        want = jax.jit(lambda q, k, v, m: jattn.full_attention(
            q, k, v, causal=causal, extra_mask=m))(q, k, v, extra)
        _close_rel(tattn.full_attention(tq, tk, tv, causal=causal,
                                        extra_mask=tx), want, OUT_REL,
                   f"causal={causal}")
    x = n(b, s, 64)
    jp = jax.tree.map(np.asarray, jattn.gqa_init(jax.random.PRNGKey(2), 64,
                                                 hq, hkv, d))
    kw = dict(n_heads=hq, n_kv_heads=hkv, head_dim=d)
    want = jax.jit(lambda p, x, k, v, m: jattn.cross_attention(
        p, x, k, v, m, **kw))(jp, x, k, v, enc_mask)
    got = tattn.cross_attention(
        convert.tree_from_numpy(jp, device="cpu"), torch.from_numpy(x), tk,
        tv, None if enc_mask is None else torch.from_numpy(enc_mask), **kw)
    _close_rel(got, want, OUT_REL, "cross_attention")


# --------------------------------------------------------------------- #
# the model


def test_training_leaves_match_the_reference():
    """Keys, shapes, types and order of the training tree equal the
    reference's (from the port's init and through ``convert``); each
    stack is checked against its own depth."""
    jcfg, cfg = _cfgs()
    jp = _jax_params()
    want = [(a.shape, a.dtype.name) for a in jax.tree.leaves(jp)]
    for tree in (build(cfg, device="cpu").init_train(
            torch.Generator().manual_seed(0)),
            convert.train_params_from_jax(jp, cfg, device="cpu")):
        assert sorted(tree) == sorted(jp) == [
            "dec_layers", "embed", "enc_layers", "enc_norm", "final_norm",
            "lm_head"]
        assert [(tuple(a.shape), str(a.dtype)[6:]) for a in leaves(tree)] \
            == want
    with pytest.raises(ValueError, match="enc_layers.*config has 3"):
        convert.train_params_from_jax(
            jp, dataclasses.replace(cfg, n_encoder_layers=3), device="cpu")
    with pytest.raises(ValueError, match="dec_layers.*config has 1"):
        convert.train_params_from_jax(
            jp, dataclasses.replace(cfg, n_layers=1), device="cpu")
    with pytest.raises(ValueError, match="training tree"):
        convert.params_from_jax(jp, cfg, device="cpu")


def test_loss_and_gradients_match_jax():
    jcfg, cfg = _cfgs()
    jp = _jax_params()
    batch = _batch(cfg.d_model, (2,), SEQ, FRAMES, 1)
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


def test_perturbing_the_last_frame_changes_the_loss():
    """tests/test_models_extra.py's property: the decoder reads every
    frame through cross-attention and the encoder is bidirectional."""
    _, cfg = _cfgs()
    bundle = build(cfg, device="cpu")
    params = bundle.init_train(torch.Generator().manual_seed(0))
    frames = 0.1 * torch.randn((1, 8, cfg.d_model),
                               generator=torch.Generator().manual_seed(1))
    batch = {"frames": frames, "tokens": torch.ones((1, 4), dtype=torch.int32),
             "labels": torch.ones((1, 4), dtype=torch.int32)}
    l1, _ = bundle.loss_fn(params, batch)
    l2, _ = bundle.loss_fn(params, dict(batch, frames=frames.clone().index_add_(
        1, torch.tensor([7]), torch.ones((1, 1, cfg.d_model)))))
    assert float(l1) != float(l2)


@pytest.fixture
def _deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def test_remat_is_bit_identical_under_vmap_grad(_deterministic):
    """Two learners through the trainer's vmap(grad): every encoder and
    decoder layer recomputed in the backward (the decoder's with the
    encoder's output as a differentiable input) gives the bits of the
    layers kept."""
    _, cfg = _cfgs()
    params = convert.train_params_from_jax(_jax_params(), cfg, device="cpu")
    stacked = tree_map(lambda a: torch.stack([a, a * 1.01]), params)
    batch = _torch(_batch(cfg.d_model, (2, 1), SEQ, FRAMES, 3))
    out = []
    for remat in (False, True):
        loss_fn = build(cfg, remat=remat, device="cpu").loss_fn
        out.append(torch.func.vmap(torch.func.grad(loss_fn, has_aux=True))(
            stacked, batch))
    (g0, m0), (g1, m1) = out
    assert all(torch.equal(a, b) for a, b in zip(leaves(g0), leaves(g1)))
    assert all(torch.equal(m0[k], m1[k]) for k in m0)


NEW = 6


def test_prefill_caches_and_greedy_tokens_match_reference():
    """On the reference's weights and the same frames (fp32 cache): the
    prefill's per-layer self K/V, position and cross K/V, then the
    greedy tokens of both engines' ``generate``; the paged engine refuses
    the family, as the reference's does."""
    jcfg, cfg = _cfgs()
    jb = jbuild(jcfg, cache_dtype=jnp.float32)
    jp = jax.tree.map(jnp.asarray, _jax_params())
    tb = build(cfg, cache_dtype=torch.float32, device="cpu")
    tp = convert.train_params_from_jax(_jax_params(), cfg, device="cpu")
    batch = _batch(cfg.d_model, (3,), 11, FRAMES, 4)
    max_len = 11 + NEW
    jl, jc = jax.jit(lambda p, b: jb.prefill(p, dict(b, max_len=max_len)))(
        jp, {k: jnp.asarray(batch[k]) for k in ("frames", "tokens")})
    tl, tc = tb.prefill(tp, dict(_torch(batch), max_len=max_len))
    _close_rel(tl, jl, OUT_REL, "prefill logits")
    assert len(tc) == cfg.n_layers
    for i, lc in enumerate(tc):
        assert lc["self"]["pos"] == int(jc["self"]["pos"][i]) == 11
        for name, a, b in (("k", lc["self"]["k"], jc["self"]["k"][i]),
                           ("v", lc["self"]["v"], jc["self"]["v"][i]),
                           ("cross_k", lc["cross_k"], jc["cross_k"][i]),
                           ("cross_v", lc["cross_v"], jc["cross_v"][i])):
            assert tuple(a.shape) == b.shape
            _close_rel(a, b, OUT_REL, f"layer {i} {name}")
    empty = tb.init_cache(3, max_len, FRAMES)
    assert [tuple(c["cross_k"].shape) for c in empty] == \
        [tuple(c["cross_k"].shape) for c in tc]
    jtoks = JEngine(jb, jp, max_len=max_len, gen=JGen(max_new_tokens=NEW)
                    ).generate(jnp.asarray(batch["tokens"]),
                               {"frames": jnp.asarray(batch["frames"])})
    ttoks = ServeEngine(tb, tp, max_len=max_len,
                        gen=GenerationConfig(max_new_tokens=NEW)).generate(
        batch["tokens"], {"frames": torch.from_numpy(batch["frames"])})
    np.testing.assert_array_equal(ttoks, jtoks)
    with pytest.raises(ValueError, match="use ServeEngine"):
        PagedServeEngine(tb, tp, max_len=max_len)


@pytest.mark.parametrize("seq", [8, 40, 8192])
def test_audio_train_batch_contract(seq):
    """Keys, shapes and dtypes of the audio batch equal the reference's
    (frames min(frontend_tokens, max(4, seq // 4)), tokens and labels
    [B, seq] int32 below the vocab); at full width too."""
    for jcfg, cfg in (_cfgs(), (jget_config(ARCH), get_config(ARCH))):
        want = jax.eval_shape(lambda k: jstubs.make_train_batch(
            k, jcfg, 2, seq), jax.random.PRNGKey(0))
        got = tstubs.make_train_batch(torch.Generator().manual_seed(0), cfg,
                                      2, seq)
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            assert tuple(v.shape) == want[k].shape, k
            assert str(v.dtype)[6:] == want[k].dtype.name, k
        assert int(got["tokens"].max()) < cfg.vocab_size
        assert abs(float(got["frames"].std()) - 0.02) < 2e-3
