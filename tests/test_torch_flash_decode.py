"""The port's paged flash-decode against the JAX package's.

On the CPU ``repro_torch.kernels.ops.flash_decode(impl="auto")`` resolves
to the plain PyTorch version (the CUDA kernel needs the card; chip_smoke.py
holds it against the plain version there).  Both are fed the same numpy
inputs as the reference's oracle (``kernels/ref.py::flash_decode_ref``)
and the Pallas kernel in interpret mode.

Tolerances: fp32 outputs within 1e-5 (the two frameworks sum in another
order); bf16 outputs within one bf16 ulp of the reference's value (both
compute in fp32 and round once at the end, so a rounding boundary can
flip by one ulp).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

HKV, MAXP = 2, 3


def _case(g, d, page, seed=0):
    """Four sequences with lengths 0, 1, one full page and a full table;
    pages scattered over the pool, unused table entries on the null page
    0, which is poisoned so any leak past the mask shows."""
    rng = np.random.default_rng(seed + 97 * g + d + page)
    b = 4
    n_pages = 1 + b * MAXP
    q = rng.standard_normal((b, HKV * g, d)).astype(np.float32)
    kp = rng.standard_normal((HKV, n_pages, page, d)).astype(np.float32)
    vp = rng.standard_normal((HKV, n_pages, page, d)).astype(np.float32)
    kp[:, 0] = 1e4
    vp[:, 0] = -1e4
    lengths = np.array([0, 1, page, MAXP * page], np.int32)
    ids = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = np.zeros((b, MAXP), np.int32)
    for i, n in enumerate(lengths):
        used = -(-int(n) // page)
        tables[i, :used] = ids[i * MAXP:i * MAXP + used]
    return q, kp, vp, tables, lengths


def _bf16_ulp(x):
    a = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7)


def _assert_close(out, want, dtype):
    out = np.asarray(out, np.float32)
    want = np.asarray(want, np.float32)
    assert np.isfinite(out).all()
    if dtype == "float32":
        np.testing.assert_allclose(out, want, atol=1e-5, rtol=1e-5)
    else:
        ulp = _bf16_ulp(np.maximum(np.abs(out), np.abs(want)))
        assert (np.abs(out - want) <= ulp).all(), np.abs(out - want).max()


def _run_port(q, kp, vp, tables, lengths, window, dtype):
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    out = tops.flash_decode(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
        torch.from_numpy(vp).to(tdt), torch.from_numpy(tables),
        torch.from_numpy(lengths), window=window)
    assert out.dtype == tdt
    return out.float().numpy()


def _jax_inputs(q, kp, vp, tables, lengths, dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return (jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
            jnp.asarray(tables), jnp.asarray(lengths))


_GRID = pytest.mark.parametrize("g,d,page,window,dtype", [
    (g, d, page, window, dtype)
    for g in (1, 3) for d in (32, 64) for page in (4, 8)
    for window in (0, 5) for dtype in ("float32", "bfloat16")])


@_GRID
def test_plain_matches_jax_oracle(g, d, page, window, dtype):
    case = _case(g, d, page)
    out = _run_port(*case, window, dtype)
    want = jref.flash_decode_ref(*_jax_inputs(*case, dtype), window=window)
    _assert_close(out, want, dtype)
    np.testing.assert_array_equal(out[0], 0.0)        # lengths == 0


@_GRID
def test_plain_matches_pallas_interpret(g, d, page, window, dtype):
    case = _case(g, d, page, seed=1)
    out = _run_port(*case, window, dtype)
    want = jops.flash_decode(*_jax_inputs(*case, dtype), window=window,
                             impl="pallas_interpret")
    _assert_close(out, want, dtype)


@pytest.mark.parametrize("page", [4, 8])
def test_gather_pages_is_exact(page):
    _, kp, _, tables, _ = _case(3, 32, page)
    out = tref.gather_pages(torch.from_numpy(kp), torch.from_numpy(tables))
    want = jref.gather_pages(jnp.asarray(kp), jnp.asarray(tables))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_mixed_types_fp32_query_bf16_pool():
    """The serving default: fp32 params with a bf16 pool gives an fp32
    query; both sides read the pool in fp32."""
    q, kp, vp, tables, lengths = _case(3, 64, 8)
    kb = torch.from_numpy(kp).to(torch.bfloat16)
    vb = torch.from_numpy(vp).to(torch.bfloat16)
    out = tops.flash_decode(torch.from_numpy(q), kb, vb,
                            torch.from_numpy(tables),
                            torch.from_numpy(lengths), window=5)
    want = jref.flash_decode_ref(
        jnp.asarray(q), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(tables),
        jnp.asarray(lengths), window=5)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_kernel_impl_refuses_cpu_tensors():
    case = [torch.from_numpy(a) for a in _case(1, 32, 4)]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tops.flash_decode(*case, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        tops.flash_decode(*case, impl="pallas")
