"""The port's qint8 and batched-QR kernels' plain versions and its
compressed reducers against the JAX package's.

On the CPU ``repro_torch.kernels.ops`` resolves to the plain versions (the
CUDA kernels need the card; chip_smoke.py holds them against the plain
versions there).  Reference outputs come from ``jax.jit``, and the Pallas
kernels run with ``interpret=True``.

Tolerances:
  * qint8 wire bytes and unpacked values: none, bit for bit.
  * QR, plain against Pallas (the same CGS2 recurrence and column signs):
    raw Q within QR_RTOL = 1e-5 of max|Q|; against the Householder oracle
    (other signs): the projector Q Q^T and Q^T Q = I within QR_ATOL.
  * Reducer outputs and EF state: fp32 within 1e-5 relative plus 1e-6
    absolute (the packages sum in another order).  PowerSGD: within 1e-5
    of the largest magnitude of each tensor (its factors come from a QR
    and three products, each summed in another order; an element of the
    residual that nearly cancels keeps their absolute error), and the
    warm-start Q against the LAPACK oracle path up to a sign per column.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import comm as jcomm  # noqa: E402
from repro.comm import quant as jquant  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.batched_qr import batched_qr as pallas_qr  # noqa: E402
from repro.kernels.qint8_pack import (qint8_pack as pallas_pack,  # noqa: E402
                                      qint8_unpack as pallas_unpack)
from repro_torch import comm as tcomm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.comm import quant as tquant  # noqa: E402
from repro_torch.comm import sparse as tsparse  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

QR_RTOL = 1e-5
QR_ATOL = 1e-5
RTOL, ATOL = 1e-5, 1e-6

_PACK_REF = jax.jit(jref.qint8_pack_ref, static_argnums=1)
_UNPACK_REF = jax.jit(jref.qint8_unpack_ref, static_argnums=1)
_QUANT = jax.jit(jquant.quantize_block, static_argnums=1)
_DEQUANT = jax.jit(jquant.dequantize_block, static_argnums=2)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _close(a, b, rtol=RTOL, atol=ATOL, what=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


# --------------------------------------------------------------------- #
# qint8 pack / unpack


def _check_wire(x, block):
    """Plain pack/unpack against the oracle, the Pallas kernels and the
    two-pass functions, bit for bit."""
    rows, n = x.shape
    wire = tops.qint8_pack(_t(x), block).numpy()
    want = np.asarray(_PACK_REF(x, block))
    assert wire.dtype == np.int8 and wire.shape == want.shape
    np.testing.assert_array_equal(wire, want)
    np.testing.assert_array_equal(
        wire, np.asarray(pallas_pack(jnp.asarray(x), block, interpret=True)))
    q, s = _QUANT(x, block)
    np.testing.assert_array_equal(wire[..., :block], np.asarray(q))
    np.testing.assert_array_equal(
        _bits(wire[..., block:].copy().view(np.float32)), _bits(s))
    tq, ts = tquant.quantize_block(_t(x), block)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(s))

    out = tops.qint8_unpack(_t(wire), n).numpy()
    assert out.shape == (rows, n) and out.dtype == np.float32
    np.testing.assert_array_equal(_bits(out), _bits(_UNPACK_REF(want, n)))
    np.testing.assert_array_equal(
        _bits(out), _bits(pallas_unpack(jnp.asarray(want), n,
                                        interpret=True)))
    np.testing.assert_array_equal(_bits(out), _bits(_DEQUANT(q, s, n)))
    np.testing.assert_array_equal(
        _bits(out), _bits(tquant.dequantize_block(tq, ts, n).contiguous()))
    return wire


@pytest.mark.parametrize("block", [128, 255, 256])
@pytest.mark.parametrize("rows,n", [(1, 1), (16, 1), (1, 255), (16, 255),
                                    (1, 1000), (16, 1000), (1, 70000),
                                    (16, 70000)])
def test_qint8_wire_matches_jax(rows, n, block):
    rng = np.random.default_rng(rows * 100003 + n + block)
    x = rng.standard_normal((rows, n)) \
        * rng.choice([1e-3, 1.0, 1e3], size=(rows, 1))
    _check_wire(x.astype(np.float32), block)


def test_qint8_edge_values_match_jax():
    """All-zero blocks, values exactly k + 0.5 quantization steps (the
    half-to-even ties), +-absmax, -0.0, subnormals and 1e30."""
    block = 8
    rows = []
    rows.append(np.zeros(4 * block, np.float32))         # all-zero blocks
    # ties: a block whose absmax is 127 * 2^-3 has scale 2^-3 exactly
    # (127/8 * fp32(1/127) rounds to 0.125), so (k + 0.5) / 8 sits on
    # the half-way point between two steps
    amax = np.float32(127 / 8)
    scale = np.float32(amax * np.float32(tref.QINT8_INV_127))
    assert scale == np.float32(0.125)
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5], np.float32)
    tie_block = np.concatenate([ties * scale, [amax]]).astype(np.float32)
    assert (tie_block[:7] / scale == ties).all()
    rows.append(np.concatenate([tie_block, -tie_block,
                                np.float32(-1) * tie_block[::-1],
                                tie_block]))
    specials = np.array([3.0, -3.0, -0.0, 0.0, 1e-40, -1e-41, 1e-45, 2.0],
                        np.float32)
    big = np.array([1e30, -1e30, 1e29, 1.0, -0.0, 1e-40, 5e29, -7e29],
                   np.float32)
    rows.append(np.concatenate([specials, big, -specials, big[::-1]]))
    x = np.stack(rows).astype(np.float32)
    wire = _check_wire(x, block)
    # the ties rounded half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
    np.testing.assert_array_equal(wire[1, 0, :7], [0, 2, 2, 0, -2, -2, 126])
    assert (wire[0, :, :block] == 0).all()
    # a partial final block (n = 29) pads with zeros on the wire
    _check_wire(x[:, :29].copy(), block)


def test_qint8_dispatch_and_wrapper_contract():
    x = torch.randn(2, 10)
    with pytest.raises(ValueError):
        tops.qint8_pack(x, 4, impl="bogus")
    with pytest.raises(ValueError, match="CUDA"):
        tops.qint8_pack(x, 4, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tops.qint8_unpack(tops.qint8_pack(x, 4), 10, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tops.batched_qr(torch.randn(2, 5, 2), impl="kernel")


# --------------------------------------------------------------------- #
# batched QR


def _pallas_qr(p):
    return np.asarray(pallas_qr(jnp.asarray(p), interpret=True))


_QR_REF = jax.jit(jref.batched_qr_ref)


def _check_qr_against_oracle(q, p):
    """Projector and orthonormality against the Householder oracle."""
    want = np.asarray(_QR_REF(p))
    proj = np.einsum("...ar,...br->...ab", q, q)
    np.testing.assert_allclose(
        proj, np.einsum("...ar,...br->...ab", want, want), rtol=0,
        atol=QR_ATOL)
    r = q.shape[-1]
    np.testing.assert_allclose(np.einsum("...ar,...as->...rs", q, q),
                               np.broadcast_to(np.eye(r), q.shape[:-2]
                                               + (r, r)),
                               rtol=0, atol=QR_ATOL)


@pytest.mark.parametrize("shape", [(16, 3, 2), (16, 512, 2), (4, 1536, 2),
                                   (4, 100, 1), (4, 100, 4), (2, 3, 40, 8)])
def test_batched_qr_matches_jax(shape):
    p = np.random.default_rng(sum(shape)).standard_normal(shape) \
        .astype(np.float32)
    q = tops.batched_qr(_t(p)).numpy()
    assert q.shape == p.shape and q.dtype == np.float32
    want = _pallas_qr(p)
    np.testing.assert_allclose(q, want, rtol=0,
                               atol=QR_RTOL * np.abs(want).max())
    _check_qr_against_oracle(q, p)


def test_batched_qr_rank_deficient_and_wide():
    """A zero column, and a whole zero panel, give exact zero columns and
    no NaN, as the Pallas kernel does (a column that is dependent only in
    exact arithmetic keeps a rounding residual, so the test uses exact
    zeros); a wide panel raises."""
    rng = np.random.default_rng(3)
    p = rng.standard_normal((3, 50, 4)).astype(np.float32)
    p[:, :, 2] = 0.0
    p[1] = 0.0                                   # a whole zero panel
    q = tops.batched_qr(_t(p)).numpy()
    assert np.isfinite(q).all()
    assert (q[:, :, 2] == 0).all() and (q[1] == 0).all()
    want = _pallas_qr(p)
    assert (want[:, :, 2] == 0).all()
    np.testing.assert_allclose(q, want, rtol=0, atol=QR_RTOL)
    live = [0, 1, 3]
    np.testing.assert_allclose(
        np.einsum("nar,nas->nrs", q[0][None][..., live],
                  q[0][None][..., live])[0], np.eye(3), atol=QR_ATOL)
    with pytest.raises(ValueError, match="tall"):
        tops.batched_qr(torch.randn(2, 3, 5))
    with pytest.raises(ValueError, match="tall"):
        tref.batched_qr_plain(torch.randn(3, 5))


def test_one_pass_control_loses_orthogonality():
    """On a panel of condition ~1e6 the CGS2 recurrence stays orthonormal
    to fp32 working precision and one pass (plain CGS) does not: the
    limit chip_smoke.py holds the kernel to tells the two apart."""
    rng = np.random.default_rng(4)
    u, _ = np.linalg.qr(rng.standard_normal((200, 4)))
    v, _ = np.linalg.qr(rng.standard_normal((4, 4)))
    p = (u * np.array([1.0, 1e-2, 1e-4, 1e-6])) @ v.T
    p = _t(p.astype(np.float32)[None])
    eye = torch.eye(4)

    def err(q):
        return (q[0].T @ q[0] - eye).abs().max().item()
    assert err(tref.batched_qr_plain(p)) < QR_ATOL
    assert err(tref.batched_qr_plain(p, passes=1)) > 100 * QR_ATOL


# --------------------------------------------------------------------- #
# reducers against the reference


def _tree(shape=(1, 2, 2), seed=0):
    """Leaves of the MLP classifier's kinds: matrices, vectors, a 4-D
    conv-like leaf and a scalar."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(shape + s).astype(np.float32)  # noqa: E731,E501
    return {"w0": mk(16, 12), "b0": mk(12), "c": mk(3, 3, 2, 4),
            "s": mk(), "w1": mk(12, 5)}


def _pair(tree_np):
    return (convert.tree_from_numpy(tree_np, device="cpu"),
            jax.tree.map(jnp.asarray, tree_np))


def _j_reduce(red):
    def f(tree, st):
        return jcomm.reduce_with(red, jtopo.global_average, tree, st)
    return jax.jit(f)


def _t_reduce(red, tree, st):
    return tcomm.reduce_with(red, lambda t, cf=None: ttopo.average_over(
        t, (0, 1, 2)), tree, st)


def _jstate_to_port(jst):
    np_state = jax.tree.map(np.asarray, jst)
    return convert.reducer_state_from_jax(np_state, "cpu")


@pytest.mark.parametrize("spec", [
    "qint8:128", "qint8:128:twopass", "qint8:32:bucketed",
    "qint8:255:twopass:bucketed", "powersgd:2", "powersgd:1:bucketed",
    "randk:0.25", "randk:0.25:bucketed", "topk:0.25:bucketed",
    "qint8:64:pipelined"])
def test_accounting_matches_jax(spec):
    """describe() round-trips; payload bytes and message counts equal the
    reference's, per leaf and per bucket (the reference's own accounting
    tree, tests/test_bucket.py, and a 4-D leaf)."""
    jr, tr = jcomm.get_reducer(spec), tcomm.get_reducer(spec)
    assert tr.describe() == jr.describe()
    assert tcomm.get_reducer(tr.describe()).describe() == jr.describe()
    for shapes in ({"w": (100, 10), "b": (10,), "v": (77,)},
                   {"c": (3, 3, 8, 16), "s": (), "w": (40, 3)}):
        tt = {k: torch.zeros(s) for k, s in shapes.items()}
        jt = {k: jnp.zeros(s) for k, s in shapes.items()}
        for fn in ("payload_bytes", "wire_payload_bytes", "n_messages"):
            assert getattr(tr, fn)(tt) == getattr(jr, fn)(jt), (fn, shapes)


@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("block", [32, 255])
def test_qint8_reducer_matches_jax(block, bucketed):
    """Fused and two-pass give the same bits (as the reference's do), and
    both equal the reference's reduction under jit."""
    tree_np = _tree(seed=block)
    tt, jt = _pair(tree_np)
    wrap = (lambda r: tcomm.Bucketed(r, 256)) if bucketed else (lambda r: r)
    jwrap = (lambda r: jcomm.Bucketed(r, 256)) if bucketed else \
        (lambda r: r)
    fused, _ = _t_reduce(wrap(tquant.QInt8Reducer(block)), tt, ())
    twopass, _ = _t_reduce(wrap(tquant.QInt8Reducer(block, fused=False)),
                           tt, ())
    want, _ = _j_reduce(jwrap(jquant.QInt8Reducer(block)))(jt, ())
    for k in tree_np:
        np.testing.assert_array_equal(_bits(fused[k].numpy()),
                                      _bits(twopass[k].numpy()))
        _close(fused[k], want[k], what=k)


def _fires(seed, n=3, shape=(1, 2, 2)):
    """Three successive parameter trees: each learner drifts on its own."""
    rng = np.random.default_rng(seed)
    base = _tree(shape, seed)
    out = []
    for _ in range(n):
        base = {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(
            np.float32) for k, v in base.items()}
        out.append(base)
    return out


def _close_rel(a, b, rel=RTOL, what=""):
    """Within ``rel`` of the largest magnitude of the reference tensor."""
    b = np.asarray(b, np.float64)
    _close(a, b, rtol=0.0, atol=rel * max(np.abs(b).max(), 1e-30), what=what)


def _q_up_to_sign(tq, jq, what):
    """Warm-start Q [..., b, r] equal up to one sign per column."""
    tq, jq = np.asarray(tq, np.float64), np.asarray(jq, np.float64)
    sign = np.sign(np.sum(tq * jq, axis=-2, keepdims=True))
    sign[sign == 0] = 1.0
    scale = max(np.abs(jq).max(), 1e-30)
    np.testing.assert_allclose(tq * sign, jq, rtol=0, atol=RTOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("mode", ["perleaf", "bucketed", "pipelined"])
@pytest.mark.parametrize("oracle", ["lapack", "pallas_interpret"])
def test_powersgd_ef_state_matches_jax(mode, oracle):
    """Three fires from a converted state: outputs, EF ref and err, and
    the warm-started Q.  Against the reference's default CPU path (the
    LAPACK QR, other column signs) Q agrees up to a sign per column;
    against its Pallas QR in interpret mode (the same CGS2 recurrence)
    Q agrees as it is."""
    jimpl = "auto" if oracle == "lapack" else "pallas_interpret"
    jinner = jcomm.PowerSGDReducer(2, impl=jimpl)
    tinner = tcomm.PowerSGDReducer(2)
    if mode == "bucketed":
        jred, tred = jcomm.Bucketed(jinner, 512), tcomm.Bucketed(tinner, 512)
    elif mode == "pipelined":
        jred, tred = (jcomm.Pipelined(jinner, 512),
                      tcomm.Pipelined(tinner, 512))
    else:
        jred, tred = jinner, tinner
    fires = _fires(7)
    tt0, jt0 = _pair(_tree(seed=7))
    jst = jred.init_state(jt0)
    tst = _jstate_to_port(jst)
    if mode != "perleaf":
        assert len(tst.ref) == tred.layout_for(tt0).n_buckets > 1
    jfn = _j_reduce(jred)
    for i, tree_np in enumerate(fires):
        tt, jt = _pair(tree_np)
        jout, jst = jfn(jt, jst)
        tout, tst = _t_reduce(tred, tt, tst)
        for k in tree_np:
            _close_rel(tout[k], jout[k], what=f"fire {i} out {k}")
        for a, b in zip(leaves(tst.ref), jax.tree.leaves(jst.ref)):
            _close_rel(a, b, what=f"fire {i} ref")
        for a, b in zip(leaves(tst.err), jax.tree.leaves(jst.err)):
            _close_rel(a, b, what=f"fire {i} err")
        tqs = [q for q in (tst.q.values() if isinstance(tst.q, dict)
                           else tst.q)]
        jqs = [jst.q[k] for k in sorted(jst.q)] if isinstance(jst.q, dict) \
            else list(jst.q)
        assert len(tqs) == len(jqs)
        for a, b in zip(tqs, jqs):
            if isinstance(b, tuple):
                assert a == ()
            elif oracle == "lapack":
                _q_up_to_sign(a.numpy(), b, f"fire {i} q")
            else:
                _close_rel(a, b, what=f"fire {i} q")


@pytest.mark.parametrize("mode", ["perleaf", "bucketed", "pipelined"])
def test_randk_with_injected_support_matches_jax(mode, monkeypatch):
    """The support is the reference's (recorded from its compress under
    jit and handed to the port's sampler); everything else, the EF delta,
    residual, mean and reference update, must agree."""
    if mode == "bucketed":
        jred = jcomm.Bucketed(jcomm.RandKReducer(0.25), 256)
        tred = tcomm.Bucketed(tcomm.RandKReducer(0.25), 256)
    elif mode == "pipelined":
        jred = jcomm.Pipelined(jcomm.RandKReducer(0.25), 256)
        tred = tcomm.Pipelined(tcomm.RandKReducer(0.25), 256)
    else:
        jred, tred = jcomm.RandKReducer(0.25), tcomm.RandKReducer(0.25)
    tt0, jt0 = _pair(_tree(seed=9))
    jst = jred.init_state(jt0)
    tst = _jstate_to_port(jst)
    assert tst.key.dtype == torch.int64 and tst.key.tolist()[1:] == [0, 0]
    jfn = _j_reduce(jred)
    if mode == "pipelined":
        # the reference's pipelined stages fold the key per bucket
        def record(tree, st):
            lay = jred.layout_for(tree)
            sts = jred.inner.split_bucket_states(st, lay.n_buckets)
            return [jred.inner.compress([b], s)[0][0][1]
                    for b, s in zip(lay.pack(tree), sts)]
    else:
        def record(tree, st):
            return [idx for _, idx in jred.compress(tree, st)[0]]
    jrecord = jax.jit(record)
    supports = []

    def injected(self, n, k, stream, device):
        idx = supports.pop(0)
        assert idx.shape == (k,) and int(idx.max()) < n
        return idx

    monkeypatch.setattr(tsparse.RandKReducer, "support", injected)
    for i, tree_np in enumerate(_fires(9)):
        tt, jt = _pair(tree_np)
        for idx in jrecord(jt, jst):
            idx = np.asarray(idx)
            assert (idx == idx[:1]).all()          # one shared support
            supports.append(_t(idx[0]))
        jout, jst = jfn(jt, jst)
        tout, tst = _t_reduce(tred, tt, tst)
        assert not supports
        for k in tree_np:
            _close(tout[k], jout[k], what=f"fire {i} out {k}")
        for a, b in zip(leaves(tst.err), jax.tree.leaves(jst.err)):
            _close(a, b, what=f"fire {i} err")
            np.testing.assert_array_equal(a.numpy() == 0, np.asarray(b) == 0)
        for a, b in zip(leaves(tst.ref), jax.tree.leaves(jst.ref)):
            _close(a, b, what=f"fire {i} ref")
        assert tst.key.tolist()[1] == i + 1


def test_randk_pipelined_equals_serial_and_support_is_fresh():
    """The port's own stream: a bucket's support depends on (seed, fire,
    bucket) only, so pipelined and serial schedules on one layout agree
    bit for bit; successive fires draw different supports."""
    tt, _ = _pair(_tree(seed=11))
    red = tcomm.Pipelined(tcomm.RandKReducer(0.3), 256)
    st0 = red.init_state({k: torch.zeros_like(v) for k, v in tt.items()})
    ser, ser_st = tcomm.Bucketed.reduce(
        red, lambda t, cf=None: ttopo.average_over(t, (0, 1, 2)), tt, st0)
    pip, pip_st = _t_reduce(red, tt, st0)
    for k in tt:
        assert torch.equal(pip[k], ser[k])
    for a, b in zip(leaves(pip_st), leaves(ser_st)):
        assert torch.equal(a, b)
    sup = tcomm.RandKReducer(0.3).support
    assert not torch.equal(sup(1000, 50, tsparse.stream_seed(0, 0, 0), "cpu"),
                           sup(1000, 50, tsparse.stream_seed(0, 1, 0), "cpu"))
