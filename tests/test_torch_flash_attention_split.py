"""The CUDA attention kernels' arithmetic, emulated on the CPU.

``kernels/ref.py::flash_attention_split_plain`` and
``flash_attention_split_backward_plain`` do in PyTorch what
``csrc/flash_attention.cu`` does on the tensor cores: blocks of query
rows over the key blocks they see (the kernel's tiles, ``attn_tiles``,
checked here against the source), products summed one mma chunk at a
time into a zeroed fp32 fragment, fp32 operands in big + small TF32 parts
(three products, "3xTF32"), and the fp32 P and dS in three bf16 parts
against bf16 inputs.  They are held here against the reference's oracle
(``repro/kernels/ref.py::flash_attention_ref`` under ``jax.jit``, and
``jax.grad`` of it) and against the Pallas kernel in interpret mode, at
head dims 32/64/128, groups 1/3/12, windows 0 and 70, query counts that
are not a multiple of 64, and windows that leave whole key blocks unseen.

Tolerances.  fp32: max|split - oracle| <= 1e-5 * max|oracle| per output
(the kernels' own limit on the card, chip_smoke.py KERN_REL_TOL): the
split products are right to about 2^-21 each, and sums of 128 terms in
another order round at about 1e-6 of their largest term.  bf16: each
element within one bf16 ulp of the larger of the two values, plus
1e-5 * max|oracle|: both sides compute in fp32 and round once at the end,
so a value near a rounding boundary may land on either side.  The bf16
backward takes rowsum(dO O) from the stored bf16 output, where
``jax.grad`` takes it from the fp32 output before rounding; so its
expectation is built in jnp in fp32 from the oracle's pieces (its scores
and mask, P = exp(S - logsumexp S), delta = rowsum(dO o) on the oracle's
bf16 output, which the emulation is given as its stored output).  The
control, one TF32 part per fp32 operand, is right to about 2^-11 per
product and must fail the fp32 limit.
"""
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

REL_TOL = 1e-5

# (D, group, window, S, dtype); B 2 and Hkv 1 or 2.  Window 70 at S 256
# leaves key block 0 unseen by query block 3, and at S 200 by the ragged
# last block; S 100, 130, 136 and 200 are not multiples of 64
_CASES = [(32, 1, 0, 200, "float32"), (64, 3, 70, 200, "float32"),
          (128, 12, 0, 136, "float32"), (128, 1, 70, 256, "float32"),
          (64, 12, 70, 200, "bfloat16"), (32, 3, 0, 130, "bfloat16"),
          (128, 3, 70, 200, "bfloat16"), (64, 1, 0, 100, "bfloat16")]
_IDS = [f"D{d}-G{g}-w{w}-S{s}-{dt}" for d, g, w, s, dt in _CASES]


def _inputs(d, g, s, seed):
    rng = np.random.default_rng(seed)
    hkv = 1 if g == 12 else 2
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return dict(q=n(2, s, hkv * g, d), k=n(2, s, hkv, d), v=n(2, s, hkv, d),
                do=n(2, s, hkv * g, d))


def _t(x, dtype):
    return torch.from_numpy(np.array(x, copy=True)).to(getattr(torch, dtype))


def _j(x, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _hold(got, want, dtype, what):
    """fp32: max|diff| <= REL_TOL max|want|; bf16: per element one ulp of
    max(|got|, |want|) plus REL_TOL max|want|."""
    a, b = _f64(got), _f64(want)
    assert np.isfinite(a).all(), what
    scale = max(np.abs(b).max(), 1e-30)
    diff = np.abs(a - b)
    if dtype == "float32":
        assert diff.max() <= REL_TOL * scale, \
            f"{what}: {diff.max() / scale:.3e} of max|oracle|"
        return
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0 ** -126)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    share = (diff / (ulp + REL_TOL * scale)).max()
    assert share <= 1.0, f"{what}: {share:.2f} of the bf16 limit"


@pytest.mark.parametrize("d,g,window,s,dtype", _CASES, ids=_IDS)
def test_split_forward_matches_oracle(d, g, window, s, dtype):
    x = _inputs(d, g, s, seed=s + d + g)
    o_ref = jax.jit(lambda q, k, v: jref.flash_attention_ref(
        q, k, v, causal=True, window=window))(
            *(_j(x[n], dtype) for n in "qkv"))
    o, lse = tref.flash_attention_split_plain(
        *(_t(x[n], dtype) for n in "qkv"), window=window)
    assert o.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    _hold(o, o_ref, dtype, "o")
    # the residual against the plain version's logsumexp (fp32 either way)
    _, lse_p = tref.flash_attention_plain(*(_t(x[n], dtype) for n in "qkv"),
                                          window=window)
    _hold(lse, lse_p, "float32", "lse")


@pytest.mark.parametrize("g,window", [(1, 0), (3, 70), (12, 70)])
def test_split_forward_matches_pallas_interpret(g, window):
    x = _inputs(64, g, 128, seed=7 + g)
    o_p = jops.flash_attention(x["q"], x["k"], x["v"], causal=True,
                               window=window, impl="pallas_interpret",
                               block_q=64, block_k=64)
    o, _ = tref.flash_attention_split_plain(
        *(_t(x[n], "float32") for n in "qkv"), window=window)
    _hold(o, o_p, "float32", "o")


def _grad_stored_output(q, k, v, o, do, window):
    """dQ, dK, dV of the oracle in fp32 with rowsum(dO O) taken from the
    stored output ``o`` (all jnp arrays): the oracle's masked scores S,
    P = exp(S - logsumexp S), dS = P (dO V^T - delta), dQ = scale dS K,
    dK = scale dS^T Q, dV = P^T dO, summed over each kv head's group."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    scale = 1.0 / float(d) ** 0.5
    f32 = lambda a: a.astype(jnp.float32)  # noqa: E731
    qg = f32(q).reshape(b, s, hkv, hq // hkv, d)
    dog = f32(do).reshape(qg.shape)
    sc = jnp.einsum("bskgd,btkd->bkgst", qg, f32(k)) * scale
    qpos, kpos = jnp.arange(s)[:, None], jnp.arange(t)[None, :]
    vis = (kpos <= qpos) & (((qpos - kpos) < window) if window else True)
    sc = jnp.where(vis, sc, jref.NEG_INF)
    p = jnp.exp(sc - jax.nn.logsumexp(sc, axis=-1, keepdims=True))
    delta = jnp.einsum("bskgd,bskgd->bkgs", dog, f32(o).reshape(qg.shape))
    ds = p * (jnp.einsum("bskgd,btkd->bkgst", dog, f32(v)) - delta[..., None])
    dq = jnp.einsum("bkgst,btkd->bskgd", ds, f32(k)) * scale
    dk = jnp.einsum("bkgst,bskgd->btkd", ds, qg) * scale
    dv = jnp.einsum("bkgst,bskgd->btkd", p, dog)
    return dq.reshape(q.shape), dk, dv


@pytest.mark.parametrize("d,g,window,s,dtype", _CASES, ids=_IDS)
def test_split_backward_matches_grad(d, g, window, s, dtype):
    x = _inputs(d, g, s, seed=2 * s + d + g)
    q, k, v, do = (_t(x[n], dtype) for n in ("q", "k", "v", "do"))
    o, lse = tref.flash_attention_split_plain(q, k, v, window=window)
    if dtype == "float32":
        def objective(q, k, v):
            out = jref.flash_attention_ref(q, k, v, causal=True,
                                           window=window)
            return jnp.sum(out * x["do"])

        want = jax.jit(jax.grad(objective, argnums=(0, 1, 2)))(
            x["q"], x["k"], x["v"])
    else:
        qj, kj, vj, doj = (_j(x[n], dtype) for n in ("q", "k", "v", "do"))
        o_ref = jax.jit(lambda q, k, v: jref.flash_attention_ref(
            q, k, v, causal=True, window=window))(qj, kj, vj)
        o = _t(_f64(o_ref), dtype)     # the stored output, on both sides
        want = jax.jit(_grad_stored_output, static_argnums=5)(
            qj, kj, vj, o_ref, doj, window)
    got = tref.flash_attention_split_backward_plain(q, k, v, o, lse, do,
                                                    window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == getattr(torch, dtype)
        _hold(a, b, dtype, name)


def test_tf32_one_part_control_fails_the_fp32_limit():
    """One TF32 part per operand (what TF32 matmuls do) must fail the
    limit the split is held to, in the forward and every gradient."""
    x = _inputs(64, 3, 200, seed=11)
    q, k, v, do = (_t(x[n], "float32") for n in ("q", "k", "v", "do"))
    o_ref = jax.jit(lambda q, k, v: jref.flash_attention_ref(
        q, k, v, causal=True, window=70))(x["q"], x["k"], x["v"])
    o, lse = tref.flash_attention_split_plain(q, k, v, window=70,
                                              fp32_scheme="tf32")
    want = tref.flash_attention_backward_plain(q, k, v, o, lse, do,
                                               window=70)
    got = tref.flash_attention_split_backward_plain(
        q, k, v, o, lse, do, window=70, fp32_scheme="tf32")
    for name, a, b in zip(("o", "dq", "dk", "dv"), (o, *got),
                          (o_ref, *want)):
        with pytest.raises(AssertionError):
            _hold(a, b, "float32", f"control {name}")


@pytest.mark.parametrize("kind,exact", [("bf16", True), ("bf16p", True),
                                        ("tf32x3", True), ("tf32", False)])
def test_split_matmul_against_fp64(kind, exact):
    """init + a @ b by chunks of split terms, K 40 (not a multiple of 16),
    against fp64 on the same values: per element within 1e-6 of
    |init| + |a| @ |b| (each product right to 2^-21 or better, 3 chunks
    of 16 or 5 of 8 summed in fp32), which one TF32 part (2^-11) must
    fail.  bf16 kinds take B in bf16 (and A too for "bf16")."""
    rng = np.random.default_rng(5)
    a, b, init = (torch.from_numpy(rng.standard_normal(shape)
                                   .astype(np.float32))
                  for shape in ((3, 24, 40), (3, 40, 16), (3, 24, 16)))
    if kind.startswith("bf16"):
        b = b.to(torch.bfloat16)
        if kind == "bf16":
            a = a.to(torch.bfloat16)
    got = tref.split_matmul(a, b, kind, init=init).double()
    a64, b64 = a.double(), b.double()
    want = init.double() + a64 @ b64
    limit = 1e-6 * (init.double().abs() + a64.abs() @ b64.abs())
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert bool(((got - want).abs() <= limit).all()) == exact


def _edge_values():
    rng = np.random.default_rng(3)
    tiny = np.float32(2.0 ** -140)                 # a subnormal
    vals = [0.0, -0.0, 1.0, -1.0, 1.0 + 2.0 ** -23, 1.0 - 2.0 ** -24,
            1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, tiny, -3 * tiny,
            np.float32(1.17e-38), 1e38, -2.0 ** 127, 3.0e-30, 7.0e20]
    return np.concatenate([np.asarray(vals, np.float32),
                           rng.standard_normal(4096).astype(np.float32)
                           * np.exp2(rng.integers(-60, 60, 4096))])


@pytest.mark.parametrize("how", ["tf32", "bf16"])
def test_split_helpers_reconstruct(how):
    """big + small is x to 2^-21 |x| (TF32: 11 significant bits each,
    the remainder exact in fp32); hi + mid + lo to 2^-24 |x| (bf16: 8 bits
    each).  Below the normal range the parts are fixed point: the floor
    is the smallest subnormal of the part's type (TF32 2^-136, bf16
    2^-133).  A signed zero keeps its sign in the first part; the
    remainders of a zero are zeros (-0 - -0 is +0, on the card too)."""
    x = torch.from_numpy(_edge_values())
    if how == "tf32":
        parts = tref.split_tf32(x)
        rel, floor = 2.0 ** -21, 2.0 ** -136
        for p in parts:     # TF32 values: the 13 low bits are clear
            assert (p.view(torch.int32) & 0x1FFF == 0).all()
    else:
        parts = tref.split_bf16(x)
        rel, floor = 2.0 ** -24, 2.0 ** -133
        for p in parts:
            assert torch.equal(p, p.to(torch.bfloat16).float())
    xs = x.numpy().astype(np.float64)
    total = sum(p.numpy().astype(np.float64) for p in parts)
    assert np.all(np.abs(total - xs) <= rel * np.abs(xs) + floor)
    neg_zero = np.signbit(x.numpy()) & (x.numpy() == 0)
    assert np.all(np.signbit(parts[0].numpy()[neg_zero]))
    for p in parts[1:]:
        assert np.all(p.numpy()[x.numpy() == 0] == 0)


def test_tf32_round_ties_away_from_zero():
    """cvt.rna: a value halfway between two TF32 values goes to the one
    of larger magnitude, on both signs."""
    half = 1.0 + 2.0 ** -11                        # between 1 and 1 + 2^-10
    x = torch.tensor([half, -half, 1.0 + 2.0 ** -12], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0])
    assert torch.equal(tref.tf32_round(x), want)


def test_split_tiles_match_the_cuda_source():
    """The emulation's forward tiles are the kernel's (``Cfg`` in
    csrc/flash_attention.cu): 16 x WQ query rows, KB keys (fp32 below
    D 128 apart)."""
    src = (pathlib.Path(tref.__file__).parent / "csrc"
           / "flash_attention.cu").read_text()
    wq = re.search(r"int WQ = F32 \? (\d+) : (\d+);", src)
    kb = re.search(r"int KB = F32 && !BIG \? (\d+) : (\d+);", src)
    f32_rows, bf16_rows = 16 * int(wq.group(1)), 16 * int(wq.group(2))
    small_d, other = int(kb.group(1)), int(kb.group(2))
    assert tref.attn_tiles(torch.float32, 128) == (f32_rows, other)
    assert tref.attn_tiles(torch.float32, 64) == (f32_rows, small_d)
    assert tref.attn_tiles(torch.bfloat16, 128) == (bf16_rows, other)
    assert tref.attn_tiles(torch.bfloat16, 32) == (bf16_rows, other)
