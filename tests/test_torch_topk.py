"""The port's top-k compress against the JAX package's.

On the CPU ``repro_torch.kernels.ops.topk_compress(impl="auto")`` resolves
to the plain PyTorch version (the CUDA kernel needs the card; chip_smoke.py
holds it against the plain version there, bit for bit).  Both are fed the
same numpy rows as the reference's oracle (``kernels/ref.py::
topk_compress_ref`` under ``jax.jit``) and the Pallas kernel in interpret
mode.  There is no tolerance: a selection either agrees or it does not,
so values (compared as bits) and indices must be identical.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.topk_compress import topk_compress as tk  # noqa: E402

_ORACLE = jax.jit(jref.topk_compress_ref, static_argnums=1)


def _rows(kind, rows, n, seed=0):
    rng = np.random.default_rng(seed + 1000 * rows + n)
    if kind == "normal":
        return rng.standard_normal((rows, n)).astype(np.float32)
    if kind == "bf16_ties":          # a coarse grid: many tied magnitudes
        return np.round(rng.standard_normal((rows, n)) * 2).astype(
            ml_dtypes.bfloat16)
    if kind == "zeros":              # every element ties: first k win
        return np.zeros((rows, n), np.float32)
    if kind == "outlier":            # +-1 with a 1e8 outlier
        x = np.sign(rng.standard_normal((rows, n))).astype(np.float32)
        x[:, n // 2] = 1e8
        return x
    if kind == "signed_zeros":       # negatives, -0.0 and +0.0 tie
        x = np.where(rng.random((rows, n)) < 0.5, -0.0, 0.0)
        x = x.astype(np.float32)
        x[:, ::7] = -rng.random((rows, len(range(0, n, 7)))) - 0.5
        return x
    if kind == "subnormal":          # magnitudes below 1.2e-38, kept as bits
        return (rng.standard_normal((rows, n)) * 1e-40).astype(np.float32)
    raise ValueError(kind)


def _port(x, k):
    t = torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16) \
        if x.dtype == ml_dtypes.bfloat16 else torch.from_numpy(x)
    v, i = tops.topk_compress(t, k)
    assert v.dtype == t.dtype and i.dtype == torch.int32
    v = v.view(torch.uint16) if v.dtype == torch.bfloat16 \
        else v.view(torch.int32)
    return v.numpy(), i.numpy()


def _bits(v):
    v = np.asarray(v)
    return v.view(np.uint16) if v.dtype == ml_dtypes.bfloat16 \
        else v.view(np.int32)


_CASES = [
    ("normal", 1, 64, 1),
    ("normal", 5, 300, 30),
    ("normal", 3, 1024, 102),
    ("normal", 2, 128, 128),          # k == n
    ("normal", 4, 17, 3),
    ("normal", 16, 1728, 86),         # the stem of ResNet-18, 16 learners
    ("bf16_ties", 3, 256, 25),
    ("bf16_ties", 2, 1000, 333),
    ("zeros", 2, 64, 5),
    ("outlier", 1, 8193, 100),
    ("signed_zeros", 2, 90, 20),
]


@pytest.mark.parametrize("kind,rows,n,k", _CASES)
def test_plain_matches_jax_oracle(kind, rows, n, k):
    x = _rows(kind, rows, n)
    v, i = _port(x, k)
    v_ref, i_ref = _ORACLE(jnp.asarray(x), k)
    np.testing.assert_array_equal(i, np.asarray(i_ref))
    np.testing.assert_array_equal(v, _bits(v_ref))
    assert (np.diff(i, axis=-1) > 0).all()


@pytest.mark.parametrize("kind,rows,n,k", _CASES)
def test_plain_matches_pallas_interpret(kind, rows, n, k):
    """Bit for bit, except that the Pallas kernel's packing contraction
    turns a selected -0.0 into +0.0 (as it flushes subnormals): there the
    values are compared as numbers, the indices still exactly."""
    x = _rows(kind, rows, n, seed=1)
    v, i = _port(x, k)
    v_p, i_p = jops.topk_compress(jnp.asarray(x), k,
                                  impl="pallas_interpret")
    np.testing.assert_array_equal(i, np.asarray(i_p))
    if kind == "signed_zeros":
        np.testing.assert_array_equal(v.view(np.float32), np.asarray(v_p))
    else:
        np.testing.assert_array_equal(v, _bits(v_p))


def test_subnormal_values_are_copied_exactly():
    """The oracle keeps subnormal values bit for bit, and so does the port
    (the Pallas kernel flushes them through its packing contraction; the
    port follows the oracle)."""
    x = _rows("subnormal", 2, 300)
    v, i = _port(x, 13)
    v_ref, i_ref = _ORACLE(jnp.asarray(x), 13)
    np.testing.assert_array_equal(i, np.asarray(i_ref))
    np.testing.assert_array_equal(v, _bits(v_ref))
    assert (v != 0).all()


def test_ties_go_to_the_lowest_indices():
    x = np.zeros((2, 64), np.float32)
    x[0, [5, 9, 40]] = [0.5, 0.5, -0.5]
    x[1, 60] = -2.0
    _, i = _port(x, 2)
    np.testing.assert_array_equal(i, [[5, 9], [0, 60]])


def test_auto_takes_the_plain_version_on_cpu_and_counts_no_launch():
    before = tk.launches
    x = torch.from_numpy(_rows("normal", 2, 50))
    v, i = tops.topk_compress(x, 5, impl="auto")
    vp, ip = tops.topk_compress(x, 5, impl="plain")
    assert torch.equal(v, vp) and torch.equal(i, ip)
    assert tk.launches == before


def test_kernel_impl_refuses_cpu_tensors():
    x = torch.from_numpy(_rows("normal", 2, 50))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tops.topk_compress(x, 5, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        tops.topk_compress(x, 5, impl="pallas")
