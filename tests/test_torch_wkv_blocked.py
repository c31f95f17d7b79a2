"""The CUDA WKV6 backward's schedule, emulated on the CPU.

``kernels/ref.py::rwkv6_wkv_backward_blocked_plain`` runs the schedule of
``csrc/rwkv6_wkv.cu``'s backward kernel in plain PyTorch: the state's rows
in blocks of 16 (one CTA each of a cluster), sub-checkpoints every 8 steps
recomputed from each chunk's checkpoint, and dv summed over the row blocks
in a fixed order.  chip_smoke.py holds the kernel against it and against
``rwkv6_wkv_backward_plain`` on the card; here it is held against
``jax.grad`` of the reference's ``rwkv6_wkv_ref`` under ``jax.jit`` and
against the plain backward.  Inputs are made with numpy and handed to
both packages.

Tolerances: against ``jax.grad``, fp32, each gradient within
GRAD_REL = 1e-5 of its largest magnitude (reverse-mode autodiff of the
scan sums in another order; fp32 rounding over a few hundred steps is
about 1e-6 of the largest term).  Against the plain backward, the on-card
limits of chip_smoke.py phase 10: fp32 within KERN_REL_TOL = 1e-5 of
max|plain|; bf16 per element within BF16_ULPS = 2 ulps of
max(|emulation|, |plain|) plus KERN_REL_TOL * max|plain|.  A control,
dr and dw computed with S_{t+1} in place of S_t (an off-by-one in the
kernel's ring of on-chip states), must fail that limit.
"""
import inspect
import pathlib
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# the control's closed form, as chip_smoke.py phase 10 computes it
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import shifted_state_control  # noqa: E402

GRAD_REL = 1e-5
KERN_REL_TOL = 1e-5
BF16_ULPS = 2.0
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def _inputs(b, s, h, d, seed=0, w_lo=0.05):
    """r/k/v/dy normal * 0.5, w in [w_lo, 0.999], u normal, nonzero s0
    and dS_T."""
    rng = np.random.default_rng(seed)
    n = lambda *shape: (0.5 * rng.standard_normal(shape)).astype(np.float32)  # noqa: E731
    w = rng.uniform(w_lo, 0.999, (b, s, h, d)).astype(np.float32)
    return dict(r=n(b, s, h, d), k=n(b, s, h, d), v=n(b, s, h, d), w=w,
                u=n(h, d), s0=n(b, h, d, d), dy=n(b, s, h, d),
                dsT=n(b, h, d, d))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, copy=True)).to(dtype)


def _backward_args(x, dtype=torch.float32):
    """(r, k, v, w, u, ckpt, dy, dsT) with the plain forward's
    checkpoints; r/k/v/w/dy in ``dtype``."""
    seq = {n: _t(x[n], dtype) for n in ("r", "k", "v", "w", "dy")}
    u, s0, dsT = _t(x["u"]), _t(x["s0"]), _t(x["dsT"])
    _, _, ckpt = tref.rwkv6_wkv_forward_plain(
        seq["r"], seq["k"], seq["v"], seq["w"], u, s0)
    return (seq["r"], seq["k"], seq["v"], seq["w"], u, ckpt, seq["dy"],
            dsT)


def _bf16_ulp(x):
    a = x.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _within(out, ref):
    """(ok, measure) under chip_smoke.py phase 10's limit."""
    o, p = out.float(), ref.float()
    diff = (o - p).abs()
    scale = max(p.abs().max().item(), 1e-30)
    if out.dtype == torch.float32:
        rel = diff.max().item() / scale
        return rel <= KERN_REL_TOL, rel
    ulp = _bf16_ulp(torch.maximum(o.abs(), p.abs()))
    share = (diff / (BF16_ULPS * ulp + KERN_REL_TOL * scale)).max().item()
    return share <= 1.0, share


def _shifted_state_grads(r, k, v, w, u, ckpt, dy, dsT):
    """dr and dw of the plain backward's recurrence with S_{t+1} in place
    of S_t, by a direct loop (fp32)."""
    b, s, h, d = r.shape
    uf = u.float().expand(b, h, d)
    g = dsT.float()
    states = [ckpt[:, :, 0].float()]
    for t in range(s):
        states.append(w[:, t, ..., None] * states[-1]
                      + k[:, t, ..., None] * v[:, t, :, None, :])
    dr, dw = torch.empty((b, s, h, d)), torch.empty((b, s, h, d))
    for t in reversed(range(s)):
        nxt = states[t + 1]
        dyv = (dy[:, t] * v[:, t]).sum(-1, keepdim=True)
        dr[:, t] = torch.einsum("bhji,bhi->bhj", nxt, dy[:, t]) \
            + uf * k[:, t] * dyv
        dw[:, t] = (g * nxt).sum(-1)
        g = w[:, t, ..., None] * g + r[:, t, ..., None] * dy[:, t, :, None, :]
    return dr, dw


_JREF = jax.jit(jref.rwkv6_wkv_ref)


@pytest.mark.parametrize("w_lo", [0.05, 1e-4])
@pytest.mark.parametrize("s", [1, 8, 64, 130, 192])
@pytest.mark.parametrize("d", [32, 64])
def test_blocked_backward_matches_jax_grad(d, s, w_lo):
    """All six gradients of sum(y dy) + sum(sT dS_T): ragged chunks (130,
    192 = 3 chunks) and sub-chunks (1, 130), decays down to 1e-4."""
    b, h = (2, 2) if d == 32 else (1, 2)
    x = _inputs(b, s, h, d, seed=100 + s + d, w_lo=w_lo)

    def objective(r, k, v, w, u, s0):
        y, sT = jref.rwkv6_wkv_ref(r, k, v, w, u, s0)
        return jnp.sum(y * x["dy"]) + jnp.sum(sT * x["dsT"])

    ref = jax.jit(jax.grad(objective, argnums=tuple(range(6))))(
        *(x[n] for n in ("r", "k", "v", "w", "u", "s0")))
    got = list(tref.rwkv6_wkv_backward_blocked_plain(*_backward_args(x)))
    got[4] = got[4].sum(0)                   # du per batch row -> du
    for name, a, jg in zip(NAMES, got, ref):
        jg = np.asarray(jg, np.float64)
        scale = max(np.abs(jg).max(), 1e-30)
        np.testing.assert_allclose(a.numpy().astype(np.float64), jg, rtol=0.0,
                                   atol=GRAD_REL * scale, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,s,h,d", [(2, 130, 2, 32), (1, 192, 2, 64),
                                     (1, 77, 3, 64)])
def test_blocked_backward_matches_plain(b, s, h, d, dtype):
    """Under chip_smoke.py phase 10's limit, per output."""
    args = _backward_args(_inputs(b, s, h, d, seed=7 + s), dtype)
    got = tref.rwkv6_wkv_backward_blocked_plain(*args)
    want = tref.rwkv6_wkv_backward_plain(*args)
    for name, a, p in zip(NAMES, got, want):
        assert a.dtype == p.dtype and a.shape == p.shape, name
        ok, measure = _within(a, p)
        assert ok, f"{name}: {measure:.3e} of the limit"


@pytest.mark.parametrize("rows,sub", [(8, 4), (32, 16), (64, 64), (16, 1)])
def test_other_blocks_and_sub_chunks_give_the_same_gradients(rows, sub):
    """The schedule's constants move no result past the limit."""
    args = _backward_args(_inputs(1, 150, 2, 64, seed=3))
    got = tref.rwkv6_wkv_backward_blocked_plain(*args, rows=rows, sub=sub)
    want = tref.rwkv6_wkv_backward_plain(*args)
    for name, a, p in zip(NAMES, got, want):
        ok, measure = _within(a, p)
        assert ok, f"{name}: {measure:.3e} of the limit"


def test_rows_must_divide_the_head_size():
    args = _backward_args(_inputs(1, 8, 1, 32))
    with pytest.raises(ValueError, match="multiple of rows"):
        tref.rwkv6_wkv_backward_blocked_plain(*args, rows=24)


def test_shifted_state_control_closed_form_equals_the_loop():
    """chip_smoke.py's closed form of the control is what a backward
    reading S_{t+1} for S_t computes (a single chunk: the states come from
    one checkpoint)."""
    args = _backward_args(_inputs(2, 40, 2, 32, seed=5))
    r, k, v, w, u, ckpt, dy, dsT = args
    dr, dk, _, dw, _, _ = tref.rwkv6_wkv_backward_plain(*args)
    want_dr, want_dw = _shifted_state_grads(*args)
    got_dr, got_dw = shifted_state_control(r, k, v, w, u[None, None],
                                           dr, dk, dw, dy)
    for name, a, p in (("dr", got_dr, want_dr), ("dw", got_dw, want_dw)):
        ok, measure = _within(a, p)
        assert ok, f"{name}: {measure:.3e} of the limit"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_shifted_state_control_fails_the_limit(dtype):
    """dr and dw with S_{t+1} for S_t fail phase 10's limit against the
    plain backward, in both types, as the control on the card must."""
    args = _backward_args(_inputs(2, 130, 2, 64, seed=9), dtype)
    r, k, v, w, u, ckpt, dy, dsT = args
    want = tref.rwkv6_wkv_backward_plain(*args)
    got = tref.rwkv6_wkv_backward_blocked_plain(*args)
    f = lambda t: t.float()  # noqa: E731
    bad_dr, bad_dw = shifted_state_control(
        f(r), f(k), f(v), f(w), u[None, None], f(got[0]), f(got[1]),
        f(got[3]), f(dy))
    for name, bad, p in (("dr", bad_dr, want[0]), ("dw", bad_dw, want[3])):
        ok, measure = _within(bad.to(dtype), p)
        # measure over its limit: fp32 a share of max|plain|, bf16 already
        # a share of the element's limit
        over = measure / KERN_REL_TOL if dtype == torch.float32 else measure
        assert not ok and over > 10.0, f"control {name} read {measure:.3e}"


def test_schedule_constants_match_the_cuda_source():
    """The emulation's defaults are the kernel's: rows per CTA
    (BWD_ROWS), steps per sub-chunk (BWD_SUB), a cluster of D / rows CTAs
    per (b, h), and the forward's checkpoint interval (CHUNK)."""
    src = (pathlib.Path(tref.__file__).parent / "csrc"
           / "rwkv6_wkv.cu").read_text()
    const = lambda name: int(re.search(  # noqa: E731
        rf"constexpr int {name} = (\d+);", src).group(1))
    params = inspect.signature(tref.rwkv6_wkv_backward_blocked_plain
                               ).parameters
    assert const("BWD_ROWS") == params["rows"].default == tref.WKV_BWD_ROWS
    assert const("BWD_SUB") == params["sub"].default == tref.WKV_BWD_SUB
    assert const("CHUNK") == tref.WKV_CHUNK
    assert re.search(r"constexpr int bwd_cluster\(int d\) \{ return "
                     r"d / BWD_ROWS; \}", src)
    assert "attr[0].val.clusterDim.x = bwd_cluster(D);" in src
    assert {d: d // params["rows"].default for d in (32, 64)} == {32: 2,
                                                                  64: 4}
