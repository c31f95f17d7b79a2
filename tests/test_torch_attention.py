"""The port's flash attention against the JAX package's, forward and
backward.

On the CPU ``repro_torch.kernels.ops.flash_attention(impl="auto")`` runs
the plain forward and the plain backward (``kernels/ref.py``) through the
same autograd Functions and vmap rules as the CUDA kernels, which
chip_smoke.py holds against the plain versions on the card.  Inputs are
made with numpy and handed to both packages.

Tolerances, fp32: outputs within 2e-5 of the reference (absolute and
relative, as the reference's own kernel tests hold its Pallas kernel to
the oracle); the log-sum-exp within 1e-5 relative of ``logsumexp`` of the
oracle's masked scores; dQ, dK and dV within 2e-5 of each gradient's
largest magnitude against ``jax.grad`` of ``flash_attention_ref`` (an
explicit backward against autodiff of the softmax: the order of every sum
differs); vmap(grad) against a per-learner loop within 1e-6 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_backward, flash_attention_fwd)

FWD_TOL, LSE_REL, GRAD_REL, VMAP_REL = 2e-5, 1e-5, 2e-5, 1e-6

# (B, S, Hq, Hkv, D, window): GQA groups 1, 2 and 4, S 64-256, windows
# that bite inside a block and across blocks
_CASES = [(2, 64, 2, 2, 32, 0), (1, 128, 4, 2, 32, 0),
          (2, 128, 4, 1, 64, 40), (1, 256, 8, 2, 32, 100),
          (1, 192, 3, 3, 32, 64)]


def _inputs(b, s, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return dict(q=n(b, s, hq, d), k=n(b, s, hkv, d), v=n(b, s, hkv, d),
                do=n(b, s, hq, d))


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, copy=True)).requires_grad_(grad)


def _close_rel(a, b, rel, what=""):
    a = np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0.0, atol=rel * scale,
                               err_msg=what)


def _jref(window):
    return jax.jit(lambda q, k, v: jref.flash_attention_ref(
        q, k, v, causal=True, window=window))


@pytest.mark.parametrize("b,s,hq,hkv,d,window", _CASES)
def test_plain_forward_matches_oracle(b, s, hq, hkv, d, window):
    x = _inputs(b, s, hq, hkv, d)
    o_ref = _jref(window)(x["q"], x["k"], x["v"])
    o = tops.flash_attention(_t(x["q"]), _t(x["k"]), _t(x["v"]),
                             window=window)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=FWD_TOL,
                               rtol=FWD_TOL)
    # the residual: logsumexp of the oracle's masked, scaled scores
    qg = x["q"].reshape(b, s, hkv, hq // hkv, d)
    sc = np.einsum("bskgd,btkd->bkgst", qg.astype(np.float64),
                   x["k"].astype(np.float64)) / np.sqrt(d)
    qpos, kpos = np.arange(s)[:, None], np.arange(s)[None, :]
    m = (kpos <= qpos) & ((qpos - kpos < window) if window else True)
    sc = np.where(m, sc, -1e30)
    lse_ref = np.log(np.exp(sc - sc.max(-1, keepdims=True)).sum(-1)) \
        + sc.max(-1)
    _, lse = tref.flash_attention_plain(_t(x["q"]), _t(x["k"]), _t(x["v"]),
                                        window=window)
    _close_rel(lse, lse_ref.reshape(b, hq, s), LSE_REL, "lse")


@pytest.mark.parametrize("b,s,hq,hkv,d,window", [(1, 128, 4, 2, 32, 0),
                                                 (1, 128, 4, 1, 32, 40)])
def test_plain_forward_matches_pallas_interpret(b, s, hq, hkv, d, window):
    x = _inputs(b, s, hq, hkv, d, seed=1)
    o_p = jops.flash_attention(x["q"], x["k"], x["v"], causal=True,
                               window=window, impl="pallas_interpret",
                               block_q=64, block_k=64)
    o, _ = tref.flash_attention_plain(_t(x["q"]), _t(x["k"]), _t(x["v"]),
                                      window=window)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_p), atol=FWD_TOL,
                               rtol=FWD_TOL)


@pytest.mark.parametrize("b,s,hq,hkv,d,window", _CASES)
def test_plain_backward_matches_jax_grad(b, s, hq, hkv, d, window):
    x = _inputs(b, s, hq, hkv, d, seed=2)

    def objective(q, k, v):
        o = jref.flash_attention_ref(q, k, v, causal=True, window=window)
        return jnp.sum(o * x["do"])

    ref = jax.jit(jax.grad(objective, argnums=(0, 1, 2)))(
        x["q"], x["k"], x["v"])
    ins = [_t(x[n], grad=True) for n in "qkv"]
    o = tops.flash_attention(*ins, window=window)
    (o * _t(x["do"])).sum().backward()
    for name, t, jg in zip(("dq", "dk", "dv"), ins, ref):
        _close_rel(t.grad, jg, GRAD_REL, name)


def test_vmap_grad_equals_a_loop():
    """The trainer's transform: vmap over learners of grad of a loss that
    attends with per-learner q/k/v projections; equal to a loop."""
    p, b, s, hq, hkv, d = 3, 2, 64, 4, 2, 32
    rng = np.random.default_rng(5)
    wq = _t(rng.standard_normal((p, d, hq * d)).astype(np.float32) * 0.2)
    wkv = _t(rng.standard_normal((p, d, 2 * hkv * d)).astype(np.float32)
             * 0.2)
    x = _t(rng.standard_normal((p, b, s, d)).astype(np.float32))

    def loss(params, xb):
        q = (xb @ params["wq"]).reshape(b, s, hq, d)
        k, v = (xb @ params["wkv"]).reshape(b, s, 2, hkv, d).unbind(2)
        return tops.flash_attention(q, k, v, window=24).square().mean()

    params = {"wq": wq, "wkv": wkv}
    got = torch.func.vmap(torch.func.grad(loss))(params, x)
    for i in range(p):
        one = torch.func.grad(loss)({n: t[i] for n, t in params.items()},
                                    x[i])
        for n in params:
            _close_rel(got[n][i], one[n].numpy(), VMAP_REL,
                       f"learner {i} {n}")


def test_non_causal_runs_the_oracle_semantics_on_the_plain_path():
    x = _inputs(1, 64, 2, 1, 32, seed=3)
    o_ref = jref.flash_attention_ref(x["q"], x["k"], x["v"], causal=False)
    o = tops.flash_attention(_t(x["q"]), _t(x["k"]), _t(x["v"]),
                             causal=False)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=FWD_TOL,
                               rtol=FWD_TOL)


def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    x = _inputs(1, 64, 2, 1, 32)
    q, k, v = (_t(x[n]) for n in "qkv")
    flash_attention_fwd.launches = flash_attention_backward.launches = 0
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tops.flash_attention(q, k, v, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        tops.flash_attention(q, k, v, impl="pallas")
    tops.flash_attention(q.requires_grad_(), k, v).sum().backward()
    assert flash_attention_fwd.launches == 0
    assert flash_attention_backward.launches == 0


def test_full_attention_dispatch():
    """The model's entry: at a static offset of 0 the (differentiable)
    kernel path, elsewhere the masked core; both give the oracle's
    semantics.  Non-causal attention takes the masked core, as the
    reference's does."""
    from repro_torch.models import attention as tattn
    x = _inputs(1, 64, 4, 2, 32, seed=6)
    q, k, v = (_t(x[n]) for n in "qkv")
    want = np.asarray(_jref(16)(x["q"], x["k"], x["v"]))
    np.testing.assert_allclose(
        tattn.full_attention(q, k, v, window=16).numpy(), want,
        atol=FWD_TOL, rtol=FWD_TOL)
    # queries at positions 32..63 against all 64 keys
    got = tattn.full_attention(q[:, 32:], k, v, window=16, q_offset=32)
    np.testing.assert_allclose(got.numpy(), want[:, 32:], atol=FWD_TOL,
                               rtol=FWD_TOL)
    # non-causal (the encoder's) takes the masked core over an all-true
    # mask, as the reference's does
    from repro.models import attention as jattn
    np.testing.assert_allclose(
        tattn.full_attention(q, k, v, causal=False).numpy(),
        np.asarray(jax.jit(lambda q, k, v: jattn.full_attention(
            q, k, v, causal=False))(x["q"], x["k"], x["v"])),
        atol=FWD_TOL, rtol=FWD_TOL)
