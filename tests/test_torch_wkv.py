"""The port's WKV6 recurrence against the JAX package's, forward and
backward.

On the CPU ``repro_torch.kernels.ops.rwkv6_wkv(impl="auto")`` runs the
plain forward and the plain explicit backward (``kernels/ref.py``) through
the same autograd Functions and vmap rules as the CUDA kernels, which
chip_smoke.py holds against the plain versions on the card.  Inputs are
made with numpy and handed to both packages.

Tolerances, fp32: y and the final state within 1e-5 of the largest
magnitude of the reference tensor (the two sum in another order; fp32
rounding over 64 steps is about 1e-6 of it); the six gradients against
``jax.grad`` of ``rwkv6_wkv_ref`` within 2e-5 of each gradient's largest
magnitude (an explicit reverse recurrence against reverse-mode autodiff of
the scan: the order of every sum differs); vmap(grad) against a
per-learner loop of the same Function within 1e-6 relative (the same
arithmetic, batched).
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
from repro_torch.kernels.rwkv6_wkv import (rwkv6_wkv_backward,  # noqa: E402
                                           rwkv6_wkv_forward)

FWD_REL, GRAD_REL, VMAP_REL = 1e-5, 2e-5, 1e-6


def _inputs(b, s, h, d, seed=0, w_lo=0.05):
    """r/k/v/dy normal, w in [w_lo, 0.999], u normal, nonzero s0/dsT."""
    rng = np.random.default_rng(seed)
    n = lambda *shape: (0.5 * rng.standard_normal(shape)).astype(np.float32)  # noqa: E731
    w = rng.uniform(w_lo, 0.999, (b, s, h, d)).astype(np.float32)
    return dict(r=n(b, s, h, d), k=n(b, s, h, d), v=n(b, s, h, d), w=w,
                u=n(h, d), s0=n(b, h, d, d), dy=n(b, s, h, d),
                dsT=n(b, h, d, d))


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, copy=True)).requires_grad_(grad)


def _close_rel(a, b, rel, what=""):
    a = np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0.0, atol=rel * scale,
                               err_msg=what)


_JREF = jax.jit(jref.rwkv6_wkv_ref)


@pytest.mark.parametrize("b,s,h,d", [(2, 64, 2, 64), (2, 64, 2, 32),
                                     (1, 100, 2, 32)])
def test_plain_forward_matches_oracle(b, s, h, d):
    x = _inputs(b, s, h, d)
    y_ref, sT_ref = _JREF(x["r"], x["k"], x["v"], x["w"], x["u"], x["s0"])
    y, sT = tops.rwkv6_wkv(*(_t(x[n]) for n in "rkvwu"), _t(x["s0"]))
    _close_rel(y, y_ref, FWD_REL, "y")
    _close_rel(sT, sT_ref, FWD_REL, "sT")


@pytest.mark.parametrize("b,s,h,d", [(2, 64, 2, 64), (1, 64, 2, 32)])
def test_plain_forward_matches_pallas_interpret(b, s, h, d):
    x = _inputs(b, s, h, d, seed=1)
    y_p, sT_p = jops.rwkv6_wkv(x["r"], x["k"], x["v"], x["w"], x["u"],
                               x["s0"], impl="pallas_interpret")
    y, sT = tref.rwkv6_wkv_plain(*(_t(x[n]) for n in "rkvwu"), _t(x["s0"]))
    _close_rel(y, y_p, FWD_REL, "y")
    _close_rel(sT, sT_p, FWD_REL, "sT")


def test_checkpoints_are_the_chunk_start_states():
    """The forward's residual holds the state before steps 0, 64, 128."""
    x = _inputs(1, 150, 1, 32, seed=2)
    args = [_t(x[n]) for n in "rkvwu"]
    _, _, ckpt = tref.rwkv6_wkv_forward_plain(*args, _t(x["s0"]))
    assert ckpt.shape == (1, 1, 3, 32, 32)
    np.testing.assert_array_equal(ckpt[:, :, 0].numpy(), x["s0"])
    for c, t in ((1, 64), (2, 128)):
        _, st = tref.rwkv6_wkv_plain(*(a[:, :t] for a in args[:4]), args[4],
                                     _t(x["s0"]))
        np.testing.assert_array_equal(ckpt[:, :, c].numpy(), st.numpy())


@pytest.mark.parametrize("b,s,h,d,w_lo", [(2, 64, 2, 64, 0.05),
                                          (2, 64, 2, 32, 0.05),
                                          (1, 130, 2, 32, 1e-6)])
def test_plain_backward_matches_jax_grad(b, s, h, d, w_lo):
    """All six gradients, nonzero dS_T, a sequence of 3 chunks (the last
    one partial) and decays down to 1e-6, where rebuilding S_t from
    S_{t+1} / w would blow up."""
    x = _inputs(b, s, h, d, seed=3, w_lo=w_lo)

    def objective(r, k, v, w, u, s0):
        y, sT = jref.rwkv6_wkv_ref(r, k, v, w, u, s0)
        return jnp.sum(y * x["dy"]) + jnp.sum(sT * x["dsT"])

    ref = jax.jit(jax.grad(objective, argnums=tuple(range(6))))(
        *(x[n] for n in ("r", "k", "v", "w", "u", "s0")))
    ins = [_t(x[n], grad=True) for n in ("r", "k", "v", "w", "u", "s0")]
    y, sT = tops.rwkv6_wkv(*ins)
    (y * _t(x["dy"])).sum().add((sT * _t(x["dsT"])).sum()).backward()
    for name, t, jg in zip(("dr", "dk", "dv", "dw", "du", "ds0"), ins, ref):
        _close_rel(t.grad, jg, GRAD_REL, name)


def test_vmap_grad_with_per_learner_u_equals_a_loop():
    """The trainer's transform: vmap over learners of grad of a loss that
    calls the Function, each learner with its own u; equal to a loop."""
    p, b, s, h, d = 3, 2, 64, 2, 32
    xs = [_inputs(b, s, h, d, seed=10 + i) for i in range(p)]
    stack = {n: _t(np.stack([x[n] for x in xs])) for n in xs[0]}

    def loss(params, batch):
        y, sT = tops.rwkv6_wkv(batch["r"], params["k"], batch["v"],
                               params["w"], params["u"], batch["s0"])
        return (y * batch["dy"]).sum() + (sT * batch["dsT"]).sum()

    params = {n: stack[n] for n in ("k", "w", "u")}
    batch = {n: stack[n] for n in ("r", "v", "s0", "dy", "dsT")}
    got = torch.func.vmap(torch.func.grad(loss))(params, batch)
    for i in range(p):
        one = torch.func.grad(loss)({n: t[i] for n, t in params.items()},
                                    {n: t[i] for n, t in batch.items()})
        for n in params:
            _close_rel(got[n][i], one[n].numpy(), VMAP_REL, f"learner {i} {n}")


def test_mixed_types_promote_to_fp32():
    """bf16 r/k/v with an fp32 w, as the model passes them in bf16: the
    oracle's fp32 arithmetic on the bf16 values, y back in bf16."""
    x = _inputs(1, 64, 2, 32, seed=4)
    bf = {n: _t(x[n]).to(torch.bfloat16) for n in "rkv"}
    y, sT = tops.rwkv6_wkv(bf["r"], bf["k"], bf["v"], _t(x["w"]), _t(x["u"]),
                           _t(x["s0"]))
    assert y.dtype == torch.bfloat16 and sT.dtype == torch.float32
    y32, sT32 = tops.rwkv6_wkv(*(bf[n].float() for n in "rkv"), _t(x["w"]),
                               _t(x["u"]), _t(x["s0"]))
    np.testing.assert_array_equal(y.float().numpy(),
                                  y32.to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(sT.numpy(), sT32.numpy())


def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    x = _inputs(1, 64, 1, 32)
    args = [_t(x[n]) for n in "rkvw"] + [_t(x["u"][None]), _t(x["s0"])]
    rwkv6_wkv_forward.launches = rwkv6_wkv_backward.launches = 0
    with pytest.raises(ValueError, match="CUDA tensors only"):
        rwkv6_wkv_forward(*args)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tops.rwkv6_wkv(*args[:4], _t(x["u"]), args[5], impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        tops.rwkv6_wkv(*args[:4], _t(x["u"]), args[5], impl="pallas")
    tops.rwkv6_wkv(*args[:4], _t(x["u"]), args[5])
    assert rwkv6_wkv_forward.launches == rwkv6_wkv_backward.launches == 0
