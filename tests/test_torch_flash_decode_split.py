"""The port's split-K decomposition of paged flash-decode, on the CPU.

``kernels/ref.py::flash_decode_split_plain`` does in PyTorch what the CUDA
kernel does: the visible keys of each sequence cut into splits counted
from the first visible key, fp32 partials (m, l, acc) per split and a
combine in split order.  It is held against the reference's oracle
(``repro/kernels/ref.py::flash_decode_ref``) and against the port's plain
``flash_decode_plain`` at split sizes of one, two and three pages and one
past the table, at lengths on and around the split boundaries, with
windows that start inside a split and inside a page, and with the null
page poisoned.  ``kernels/flash_decode.py::split_plan`` is the host's
plan of the kernel's grid; it must cover the visible keys exactly once.

Tolerances: fp32 within 1e-5 (another order of the sums), as in
test_torch_flash_decode.py; bf16 within one bf16 ulp of the larger value
(fp32 arithmetic rounded once at the end on both sides) plus BF16_ATOL:
an output that cancels to near zero keeps the absolute error of the fp32
sums before that rounding (a split sums in another order than one softmax
over the row; 1.1e-8 seen on an output of -6.4e-7, over one ulp there).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

HKV, PAGE, MAXP = 2, 4, 8          # a table of 32 keys
SPLITS = (PAGE, 2 * PAGE, 3 * PAGE, MAXP * PAGE + PAGE)
BF16_ATOL = 1e-6


def _lengths(sk):
    """0, 1, around one and two splits, the full table and past it."""
    return [0, 1, sk - 1, sk, sk + 1, 2 * sk, MAXP * PAGE, MAXP * PAGE + 3]


def _case(g, d, lengths, seed):
    rng = np.random.default_rng(seed + 31 * g + d + len(lengths))
    b = len(lengths)
    n_pages = 1 + b * MAXP
    q = rng.standard_normal((b, HKV * g, d)).astype(np.float32)
    kp = rng.standard_normal((HKV, n_pages, PAGE, d)).astype(np.float32)
    vp = rng.standard_normal((HKV, n_pages, PAGE, d)).astype(np.float32)
    kp[:, 0] = 1e4                 # the null page: any leak shows
    vp[:, 0] = -1e4
    ids = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = np.zeros((b, MAXP), np.int32)
    for i, n in enumerate(lengths):
        used = min(-(-int(n) // PAGE), MAXP)
        tables[i, :used] = ids[i * MAXP:i * MAXP + used]
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


def _torch(case, dtype):
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    q, kp, vp, tables, lengths = case
    return (torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
            torch.from_numpy(vp).to(tdt), torch.from_numpy(tables),
            torch.from_numpy(lengths))


def _assert_close(out, want, dtype):
    out = np.asarray(out, np.float32)
    want = np.asarray(want, np.float32)
    assert np.isfinite(out).all()
    if dtype == "float32":
        np.testing.assert_allclose(out, want, atol=1e-5, rtol=1e-5)
    else:
        a = np.maximum(np.maximum(np.abs(out), np.abs(want)),
                       np.float32(2.0 ** -126))
        ulp = np.exp2(np.floor(np.log2(a)) - 7)
        assert (np.abs(out - want) <= ulp + BF16_ATOL).all(), \
            np.abs(out - want).max()


_SPLIT_GRID = pytest.mark.parametrize("sk,window,dtype", [
    (sk, window, dtype) for sk in SPLITS for window in (0, 6, 11)
    for dtype in ("float32", "bfloat16")])


@_SPLIT_GRID
@pytest.mark.parametrize("g,d", [(3, 32), (1, 64)])
def test_split_plain_matches_jax_oracle(g, d, sk, window, dtype):
    case = _case(g, d, _lengths(sk), seed=0)
    args = _torch(case, dtype)
    out = tref.flash_decode_split_plain(*args, window=window, split_keys=sk)
    assert out.dtype == args[0].dtype
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    q, kp, vp, tables, lengths = case
    want = jref.flash_decode_ref(
        jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(tables), jnp.asarray(lengths), window=window)
    _assert_close(out.float().numpy(), want, dtype)
    np.testing.assert_array_equal(out[0].float().numpy(), 0.0)   # len 0


@_SPLIT_GRID
def test_split_plain_matches_plain(sk, window, dtype):
    args = _torch(_case(3, 32, _lengths(sk), seed=1), dtype)
    out = tref.flash_decode_split_plain(*args, window=window, split_keys=sk)
    want = tref.flash_decode_plain(*args, window=window)
    _assert_close(out.float().numpy(), want.float().numpy(), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_all_inactive_batch_gives_zeros(dtype):
    args = _torch(_case(3, 32, [0] * 4, seed=2), dtype)
    for sk in (PAGE, 3 * PAGE):
        out = tref.flash_decode_split_plain(*args, window=6, split_keys=sk)
        assert torch.equal(out.float(), torch.zeros_like(out.float()))


@pytest.mark.parametrize("maxp,page", [(3, 4), (8, 4), (5, 16), (6, 24)])
def test_split_plan_covers_visible_keys_once(maxp, page):
    table = maxp * page
    windows = sorted({0, 1, page - 1, page, page + 1, 2 * page + 1,
                      table - 1, table, table + 5})
    for window in windows:
        for forced in (None, page, 2 * page, table + page):
            sk, n_splits = tfd.split_plan(maxp, page, window, forced)
            assert sk % page == 0 and sk > 0
            for n in range(table + 4):
                lo, hi = tfd.visible_span(n, maxp, page, window)
                seen = np.zeros(table, np.int64)
                busy = 0
                for s in range(n_splits):
                    s0 = lo + s * sk
                    s1 = min(s0 + sk, hi)
                    if s0 < s1:
                        busy += 1
                        seen[s0:s1] += 1
                want = np.zeros(table, np.int64)
                want[max(lo, 0):max(hi, 0)] = 1
                np.testing.assert_array_equal(seen, want)
                assert [busy] == tfd.busy_splits([n], maxp, page, window, sk)


def test_split_plan_defaults_and_refusals():
    assert tfd.split_plan(272, 16, 4096) == (256, 16)
    assert tfd.split_plan(272, 16, 0) == (256, 17)
    assert tfd.split_plan(10, 24, 0) == (240, 1)       # whole pages
    assert tfd.split_plan(2, 512, 0) == (512, 2)       # at least one page
    for bad in (0, -16, 24):
        with pytest.raises(ValueError, match="multiple of the page"):
            tfd.split_plan(272, 16, 4096, bad)


def test_serving_plan_fills_the_card():
    """starcoder2-15b decode at 8 slots (Hkv 4, page 16, window 4096) and
    chip_smoke.py's lengths: at least one busy CTA per SM of an H100."""
    sk, n_splits = tfd.split_plan(272, 16, 4096)
    lengths = [0, 1, 16, 1000, 2047, 4096, 4150, 4200]
    busy = sum(tfd.busy_splits(lengths, 272, 16, 4096, sk)) * 4
    assert busy >= 132
    assert busy == 248 and n_splits * 4 * 8 == 512
