"""``remat`` in the port's LMs: the layers recomputed in the backward
(``models.common.scan_layers``) against the layers kept, and against the
reference's ``remat=True`` (``jax.checkpoint`` per layer) under
``jax.jit``, at ``cfg.reduced()`` from the reference's init carried across
by ``convert.train_params_from_jax``.

Remat changes what is kept, never what is computed: on the CPU the loss,
metrics and every gradient leaf with ``remat=True`` are the bits of
``remat=False``, through the trainer's ``vmap(grad)`` over learners (the
kernels' autograd Functions run inside the recomputation) and through
plain autograd.  These tests run under
``torch.use_deterministic_algorithms(True)``: the CPU's threaded
accumulation of the embedding's rows (the backward of ``embed[tokens]``)
sums in another order from run to run, remat or not (1.9e-9 apart in 2 of
3 runs of the same model with 8 threads), and the deterministic mode pins
it.  Against the reference, the limits of
tests/test_torch_lm.py: the loss within 1e-5 relative, each gradient leaf
within 2e-5 of its largest magnitude.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import stubs as jstubs  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

LOSS_REL, GRAD_REL = 1e-5, 2e-5
ARCHS = {"rwkv6-1.6b": 48, "starcoder2-15b": 96,
         "deepseek-v2-lite-16b": 48, "qwen2-vl-2b": 48}


def _cfgs(arch):
    return jget_config(arch).reduced(), get_config(arch).reduced()


def _batch(jcfg, lead, seq, seed):
    """Numpy batch [*lead, ...]: tokens/labels of seq tokens, or for the
    VLM the stub's patch embeddings in front of seq - Nv text tokens."""
    rng = np.random.default_rng(seed)
    nv = min(jcfg.frontend_tokens, seq // 4) if jcfg.family == "vlm" else 0
    toks = rng.integers(0, jcfg.vocab_size, size=lead + (seq - nv + 1,))
    toks = toks.astype(np.int32)
    out = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if nv:
        out["vision_embeds"] = (0.02 * rng.standard_normal(
            lead + (nv, jcfg.d_model))).astype(np.float32)
        pos = np.asarray(jstubs.mrope_positions(1, nv, seq - nv))[0]
        out["positions"] = np.array(np.broadcast_to(pos, lead + pos.shape))
    return out


def _close_rel(a, b, rel, what=""):
    a = np.asarray(a.detach().float().numpy(), np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=0.0,
                               atol=rel * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


_INITS = {}


def _jax_params(arch):
    if arch not in _INITS:
        jcfg, _ = _cfgs(arch)
        _INITS[arch] = jax.tree.map(np.asarray, jax.jit(jbuild(jcfg).init)(
            jax.random.PRNGKey(0)))
    return _INITS[arch]


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(autouse=True)
def _deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_remat_is_bit_identical_under_vmap_grad(arch):
    """Two learners (the second's params scaled by 1.01) through the
    trainer's vmap(grad): remat on and off give the same bits."""
    jcfg, cfg = _cfgs(arch)
    params = convert.train_params_from_jax(_jax_params(arch), cfg,
                                           device="cpu")
    stacked = tree_map(lambda a: torch.stack([a, a * 1.01]), params)
    batch = _torch(_batch(jcfg, (2, 2), ARCHS[arch], 3))
    out = []
    for remat in (False, True):
        loss_fn = build(cfg, remat=remat, device="cpu").loss_fn
        out.append(torch.func.vmap(torch.func.grad(loss_fn, has_aux=True))(
            stacked, batch))
    (g0, m0), (g1, m1) = out
    assert all(torch.equal(a, b) for a, b in zip(leaves(g0), leaves(g1)))
    assert all(torch.equal(m0[k], m1[k]) for k in m0)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "rwkv6-1.6b"])
def test_remat_is_bit_identical_under_autograd(arch):
    """loss.backward() through the remat Function, one learner."""
    jcfg, cfg = _cfgs(arch)
    batch = _torch(_batch(jcfg, (2,), ARCHS[arch], 4))
    grads = []
    for remat in (False, True):
        params = convert.train_params_from_jax(_jax_params(arch), cfg,
                                               device="cpu")
        for x in leaves(params):
            x.requires_grad_()
        loss, _ = build(cfg, remat=remat, device="cpu").loss_fn(params,
                                                                batch)
        loss.backward()
        grads.append([x.grad for x in leaves(params)])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_remat_matches_the_reference_remat(arch):
    jcfg, cfg = _cfgs(arch)
    jp = _jax_params(arch)
    batch = _batch(jcfg, (2,), ARCHS[arch], 5)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        jbuild(jcfg, remat=True).loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = convert.train_params_from_jax(jp, cfg, device="cpu")
    tg, (tl, tm) = torch.func.grad_and_value(
        build(cfg, remat=True, device="cpu").loss_fn, has_aux=True)(
        params, _torch(batch))
    _close_rel(tl, jl, LOSS_REL, "loss")
    assert sorted(tm) == sorted(jm)
    for a, b in zip(leaves(tg), jax.tree.leaves(jg)):
        _close_rel(a, b, GRAD_REL)


def test_scan_layers_remat_takes_a_tuple_carry_and_constants():
    """The carry may be a tuple (the decoder's (x, aux)); constants are
    read, not differentiated; the result is the loop's, bit for bit."""
    g = torch.Generator().manual_seed(0)
    stack = {"w": torch.randn(3, 4, 4, generator=g)}
    c = torch.randn(4, generator=g)

    def body(carry, lp, c):
        x, s = carry
        y = torch.tanh(x @ lp["w"]) * c
        return y, s + y.square().sum()

    def f(w, x, remat):
        x, s = common.scan_layers(body, (x, torch.zeros(())), {"w": w},
                                  remat=remat, consts=(c,))
        return x.sum() + s

    x = torch.randn(2, 4, generator=g)
    ref = torch.func.grad(f, argnums=(0, 1))(stack["w"], x, False)
    got = torch.func.grad(f, argnums=(0, 1))(stack["w"], x, True)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))
