"""The CUDA WKV6 forward's schedule, emulated on the CPU.

``kernels/ref.py::rwkv6_wkv_forward_blocked_plain`` runs the schedule and
the arithmetic of ``csrc/rwkv6_wkv.cu``'s forward kernel in plain PyTorch:
the state in 8 x 4 tiles updated by fmaf, y's partials as fmaf chains
over each tile's rows and, once per stage, summed over the row groups in
order, and the bonus term q_t = r_t . (u k_t) once per step, each fmaf
rounded once (``kernels/ref.py::fmaf``, held here against exact rational
arithmetic).  chip_smoke.py holds the kernel's outputs against it on the
card (states bit for bit, y within one ulp); here it is held against the
reference's ``rwkv6_wkv_ref`` under ``jax.jit``, against the Pallas
kernel in interpret mode and against the plain forward.  Inputs are made
with numpy and handed to both packages.

Tolerances: against the reference and the Pallas kernel, fp32, y and the
final state within FWD_REL = 1e-5 of the reference tensor's largest
magnitude (sums in another order; fp32 rounding over a few hundred steps
is about 1e-6 of it).  The states and checkpoints bit for bit against a
step-by-step fmaf recurrence, and within FWD_REL of the plain forward's
(which rounds w S before adding k v); y under chip_smoke.py phase 10's
limit of the plain forward's: fp32 within
KERN_REL_TOL = 1e-5 of max|plain|; bf16 per element within BF16_ULPS = 2
ulps of max(|emulation|, |plain|) plus KERN_REL_TOL * max|plain|.  A
control, y with r_{t+1} for r_t at the first step of every stage (a fault
in the kernel's staging), must fail that limit.
"""
import inspect
import math
import pathlib
import re
import sys
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# the staging control, as chip_smoke.py phase 10 computes it
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import staging_fault_control, ulps_apart  # noqa: E402

FWD_REL = 1e-5
KERN_REL_TOL = 1e-5
BF16_ULPS = 2.0
SEQ_LENS = [1, 8, 64, 130, 192]


def _inputs(b, s, h, d, seed=0, w_lo=0.05):
    """r/k/v normal * 0.5, w in [w_lo, 0.999], u normal, nonzero s0."""
    rng = np.random.default_rng(seed)
    n = lambda *shape: (0.5 * rng.standard_normal(shape)).astype(np.float32)  # noqa: E731
    w = rng.uniform(w_lo, 0.999, (b, s, h, d)).astype(np.float32)
    return dict(r=n(b, s, h, d), k=n(b, s, h, d), v=n(b, s, h, d), w=w,
                u=n(h, d), s0=n(b, h, d, d))


def _args(x, dtype=torch.float32):
    """(r, k, v, w, u, s0) as torch tensors, r/k/v/w in ``dtype``."""
    t = lambda a: torch.from_numpy(np.array(a, copy=True))  # noqa: E731
    return (*(t(x[n]).to(dtype) for n in "rkvw"), t(x["u"]), t(x["s0"]))


def _close_rel(a, ref, rel, what):
    ref = np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(a.numpy().astype(np.float64), ref, rtol=0.0,
                               atol=rel * scale, err_msg=what)


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


def _fma_states(r, k, v, w, u, s0):
    """(sT, checkpoints) of the kernel's state arithmetic, step by step:
    S = fmaf(w_j, S, k_j v_i), with no tiles or stages."""
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    st, ckpts = s0.float(), []
    for t in range(r.shape[1]):
        if t % tref.WKV_CHUNK == 0:
            ckpts.append(st)
        st = tref.fmaf(wf[:, t, :, :, None], st,
                       kf[:, t, :, :, None] * vf[:, t, :, None, :])
    return st, torch.stack(ckpts, 2)


def _states_hold(sT, ckpt, args, want_plain):
    """sT and the checkpoints: the fmaf recurrence's to the bit, the plain
    forward's within FWD_REL."""
    sT_f, ckpt_f = _fma_states(*args)
    assert torch.equal(sT, sT_f) and torch.equal(ckpt, ckpt_f)
    _, sT_p, ckpt_p = want_plain
    _close_rel(sT, sT_p, FWD_REL, "sT against plain")
    _close_rel(ckpt, ckpt_p, FWD_REL, "checkpoints against plain")


def _shape(d):
    return (2, 2) if d == 32 else (1, 2)


def _pallas_block(s):
    """The Pallas kernel's time block: the largest up to 65 that divides s
    (it takes whole blocks only)."""
    return next(bt for bt in range(min(s, 65), 0, -1) if s % bt == 0)


_JREF = jax.jit(jref.rwkv6_wkv_ref)


@pytest.mark.parametrize("w_lo", [0.05, 1e-4])
@pytest.mark.parametrize("s", SEQ_LENS)
@pytest.mark.parametrize("d", [32, 64])
def test_blocked_forward_matches_jax_ref(d, s, w_lo):
    """y and the final state: ragged stages and chunks (1, 8, 130), three
    chunks (192), decays down to 1e-4."""
    b, h = _shape(d)
    x = _inputs(b, s, h, d, seed=200 + s + d, w_lo=w_lo)
    y_ref, sT_ref = _JREF(x["r"], x["k"], x["v"], x["w"], x["u"], x["s0"])
    y, sT, _ = tref.rwkv6_wkv_forward_blocked_plain(*_args(x))
    _close_rel(y, y_ref, FWD_REL, "y")
    _close_rel(sT, sT_ref, FWD_REL, "sT")


@pytest.mark.parametrize("w_lo", [0.05, 1e-4])
@pytest.mark.parametrize("s", SEQ_LENS)
@pytest.mark.parametrize("d", [32, 64])
def test_blocked_forward_matches_pallas_interpret(d, s, w_lo):
    """The TPU kernel the CUDA forward replaces, run in interpret mode."""
    b, h = _shape(d)
    x = _inputs(b, s, h, d, seed=300 + s + d, w_lo=w_lo)
    y_p, sT_p = jops.rwkv6_wkv(x["r"], x["k"], x["v"], x["w"], x["u"],
                               x["s0"], impl="pallas_interpret",
                               block_t=_pallas_block(s))
    y, sT, _ = tref.rwkv6_wkv_forward_blocked_plain(*_args(x))
    _close_rel(y, y_p, FWD_REL, "y")
    _close_rel(sT, sT_p, FWD_REL, "sT")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,s,h,d", [(2, 130, 2, 32), (1, 192, 2, 64),
                                     (1, 77, 3, 64)])
def test_blocked_forward_states_equal_plain(b, s, h, d, dtype):
    """The states and checkpoints are the fmaf recurrence's to the bit
    and the plain forward's within FWD_REL; y holds phase 10's limit."""
    args = _args(_inputs(b, s, h, d, seed=7 + s), dtype)
    y, sT, ckpt = tref.rwkv6_wkv_forward_blocked_plain(*args)
    plain = tref.rwkv6_wkv_forward_plain(*args)
    _states_hold(sT, ckpt, args, plain)
    y_p = plain[0]
    assert y.dtype == y_p.dtype == dtype and y.shape == y_p.shape
    ok, measure = _within(y, y_p)
    assert ok, f"y: {measure:.3e} of the limit"


@pytest.mark.parametrize("tile,stage", [((4, 4), 16), ((4, 8), 16),
                                        ((2, 8), 16), ((2, 4), 16),
                                        ((8, 4), 8), ((8, 4), 32)])
def test_other_tiles_and_stages_give_the_same_forward(tile, stage):
    """The schedule's constants (the variants the on-card study times)
    move no state bit and no y past the limit, at both head sizes."""
    for d in (32, 64):
        args = _args(_inputs(1, 150, 2, d, seed=3 + d))
        y, sT, ckpt = tref.rwkv6_wkv_forward_blocked_plain(
            *args, tile=tile, stage=stage)
        plain = tref.rwkv6_wkv_forward_plain(*args)
        _states_hold(sT, ckpt, args, plain)
        ok, measure = _within(y, plain[0])
        assert ok, f"D {d}: y {measure:.3e} of the limit"


@pytest.mark.parametrize("tile,stage,match", [
    ((3, 4), 16, "whole warps"), ((4, 64), 16, "whole warps"),
    ((8, 8), 16, "whole warps"), ((4, 4), 24, "checkpoint interval")])
def test_schedules_the_kernel_cannot_run_are_refused(tile, stage, match):
    """3-row tiles leave rows over, 64 columns a thread more than D 32
    has, 8 x 8 tiles half a warp at D 32, and a stage that does not
    divide 64 steps puts a checkpoint inside a stage."""
    args = _args(_inputs(1, 8, 1, 32))
    with pytest.raises(ValueError, match=match):
        tref.rwkv6_wkv_forward_blocked_plain(*args, tile=tile, stage=stage)


def test_halving_sum_is_the_butterfly_order():
    """A shuffle butterfly over 16 lanes (xor 8, 4, 2, 1: each lane adds
    its partner's value) leaves in every lane the bits of the halving
    sum."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((5, 16)).astype(np.float32))
    lanes = [x[:, i] for i in range(16)]
    for o in (8, 4, 2, 1):
        lanes = [lanes[i] + lanes[i ^ o] for i in range(16)]
    want = tref._halving_sum(x, 1)
    for lane in lanes:
        assert torch.equal(lane, want)


def test_schedule_constants_match_the_cuda_source():
    """The emulation's defaults are the kernel's: the tile (FWD_TR x
    FWD_TC), the stage (FWD_STAGE steps, dividing CHUNK) and the
    checkpoint interval."""
    src = (pathlib.Path(tref.__file__).parent / "csrc"
           / "rwkv6_wkv.cu").read_text()
    const = lambda name: int(re.search(  # noqa: E731
        rf"constexpr int {name} = (\d+);", src).group(1))
    params = inspect.signature(tref.rwkv6_wkv_forward_blocked_plain
                               ).parameters
    assert (const("FWD_TR"), const("FWD_TC")) == params["tile"].default \
        == (tref.WKV_FWD_TR, tref.WKV_FWD_TC)
    assert const("FWD_STAGE") == params["stage"].default \
        == tref.WKV_FWD_STAGE
    assert const("CHUNK") == tref.WKV_CHUNK
    assert "static_assert(CHUNK % FWD_STAGE == 0" in src
    assert re.search(r"return \(d / FWD_TR\) \* \(d / FWD_TC\);", src)
    assert "kern<<<B * H, fwd_threads(D), smem, stream>>>" in src


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_staging_fault_control_fails_the_limit(dtype):
    """y with r_{t+1} for r_t at every stage start fails phase 10's limit
    against the plain forward, in both types, as the control on the card
    must; the control's y leaves the other steps as they were."""
    r, k, v, w, u, s0 = _args(_inputs(2, 130, 2, 64, seed=9), dtype)
    want = tref.rwkv6_wkv_forward_plain(r, k, v, w, u, s0)[0]
    bad = staging_fault_control(tref, r, k, v, w, u, s0, tref.WKV_FWD_STAGE)
    ok, measure = _within(bad, want)
    # measure over its limit: fp32 a share of max|plain|, bf16 already a
    # share of the element's limit
    over = measure / KERN_REL_TOL if dtype == torch.float32 else measure
    assert not ok and over > 10.0, f"control read {measure:.3e}"
    starts = torch.arange(0, 130, tref.WKV_FWD_STAGE)
    rest = torch.ones(130, dtype=torch.bool)
    rest[starts] = False
    assert torch.equal(bad[:, rest], want[:, rest])


def _round_f32(x: Fraction) -> np.float32:
    """An exact rational rounded to fp32, to nearest, ties to even."""
    if x == 0:
        return np.float32(0.0)
    mag = abs(x)
    e = mag.numerator.bit_length() - mag.denominator.bit_length()
    if Fraction(2) ** e > mag:
        e -= 1
    quantum = Fraction(2) ** (max(e, -126) - 23)   # the ulp at |x|
    n = math.floor(mag / quantum)
    rest = mag / quantum - n
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and n % 2):
        n += 1
    return np.float32(math.copysign(float(n * quantum), x))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fmaf_rounds_once(seed):
    """fmaf(a, b, c) is a * b + c rounded once to fp32, to the bit: on
    random triples over a wide range of exponents (subnormal results
    included), and on triples whose fp64 sum lands on an fp32 tie that
    the exact value is not on (where rounding twice goes wrong)."""
    rng = np.random.default_rng(seed)
    n = 2000
    mant = lambda: rng.uniform(-2.0, 2.0, n)  # noqa: E731
    a = (mant() * np.exp2(rng.integers(-70, 20, n))).astype(np.float32)
    b = (mant() * np.exp2(rng.integers(-70, 20, n))).astype(np.float32)
    c = (mant() * np.exp2(rng.integers(-150, 40, n))).astype(np.float32)
    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 lies on a tie; c = +-2^-60
    # breaks it, c = 0 leaves it to even
    one = np.float32(1 + 2.0 ** -12)
    tie = np.array([[one, one, 2.0 ** -60], [one, one, -(2.0 ** -60)],
                    [one, one, 0.0], [-one, one, 2.0 ** -60],
                    [-one, one, -(2.0 ** -60)]], np.float32)
    a, b, c = (np.concatenate([x, tie[:, i]]) for i, x in enumerate((a, b, c)))
    got = tref.fmaf(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    # rounding twice (fp64, then fp32) misses the broken ties
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert not np.array_equal(twice[-5:].view(np.int32),
                              want[-5:].view(np.int32))


def test_ulps_apart_counts_units_in_the_last_place():
    """chip_smoke.py's measure of y against the emulation: 0 for the same
    values (+0 and -0 too), 1 for neighbours in fp32 and in bf16, across
    zero and among subnormals."""
    x = torch.tensor([1.0, -1.0, 0.0, -0.0, 2.0 ** -149, 1e30, -3.25])
    up = torch.nextafter(x, torch.full_like(x, float("inf")))
    assert ulps_apart(torch, x, x.clone()) == 0
    assert ulps_apart(torch, x, up) == 1
    assert ulps_apart(torch, torch.tensor([0.0]), torch.tensor([-0.0])) == 0
    tiny = torch.tensor([2.0 ** -149])
    assert ulps_apart(torch, tiny, -tiny) == 2
    b = torch.tensor([1.0, -2.5, 0.0], dtype=torch.bfloat16)
    b_up = torch.tensor([1.0078125, -2.484375, 2.0 ** -133],
                        dtype=torch.bfloat16)
    assert ulps_apart(torch, b, b_up) == 1
    assert ulps_apart(torch, b, -b) == 2 * int(
        torch.tensor([-2.5], dtype=torch.bfloat16).view(torch.int16)
        .item() & 0x7FFF)
