"""The top-k kernel's decomposition, and the grouped calls of the sparse
reducer, against the JAX package's oracle.

``repro_torch.kernels.ref.topk_compress_radix_plain`` is the CUDA kernel
``csrc/topk_compress.cu`` step by step in plain PyTorch: the 11 + 11 + 9
bit radix select, the candidate buffer of digit 1's bin (or the path that
reads the row again when the bin overflows it), one CTA for a small row,
and the compaction chunk by chunk with the gt/eq counts of the chunks
before.  Its constants are read from the CUDA source.  It must give the
bits of ``repro/kernels/ref.py::topk_compress_ref`` under ``jax.jit`` and
of ``topk_compress_plain`` on numpy rows made from a seed: there is no
tolerance, a selection agrees or it does not.

The reducer selects the deltas of consecutive leaves in one call
(``ops.topk_compress_many``) up to ``TopKReducer.group_bytes``; its
payload, error-feedback state and RNG carry must be those of the leaf by
leaf loop, bit for bit.
"""
import inspect
import pathlib
import re

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.comm import sparse as tsparse  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.resnet18_cifar import CNNConfig, MLPConfig  # noqa: E402,E501
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import resnet as tres  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

_ORACLE = jax.jit(jref.topk_compress_ref, static_argnums=1)
SMALL_N, CHUNK = tref.TOPK_SMALL_N, tref.TOPK_CHUNK


def _torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _bits(v):
    v = np.asarray(v)
    return v.view(np.uint16) if v.dtype == ml_dtypes.bfloat16 \
        else v.view(np.int32)


def _tbits(v):
    return v.view(torch.int16 if v.dtype == torch.bfloat16 else torch.int32)


def _tie_rows(rng, rows, n, end_chunk, chunk=CHUNK):
    """Rows whose k-th magnitude is a tie (+-1 at every third index,
    N(0, 0.1) elsewhere, 64 values of -2) and whose taken ties end in
    chunk ``end_chunk``: (x, k)."""
    x = (rng.standard_normal((rows, n)) * 0.1).astype(np.float32)
    x[:, ::3] = np.where(rng.random((rows, len(range(0, n, 3)))) < 0.5,
                         -1.0, 1.0)
    x[:, rng.permutation(n)[:64]] = -2.0
    cut = min(n, end_chunk * chunk + chunk // 2)
    ties = np.cumsum(np.abs(x[0]) == 1.0)
    return x, int((np.abs(x[0]) == 2.0).sum()) + int(ties[cut - 1])


def _case(kind, rows, n, seed):
    """(x, k, emulation keywords) for one case."""
    rng = np.random.default_rng(seed)
    normal = lambda: rng.standard_normal((rows, n)).astype(np.float32)  # noqa: E731,E501
    k5 = max(1, n // 20)
    if kind.startswith("ties_end_"):
        end = {"first": 0, "middle": 2, "last": 5}[kind[9:]]
        x, k = _tie_rows(rng, rows, n, end)
        return x, k, {}
    if kind.startswith("small_chunks_ties_end_"):
        end = {"first": 0, "middle": 7, "last": 15}[kind[22:]]
        x, k = _tie_rows(rng, rows, n, end, chunk=64)
        return x, k, {"chunk": 64, "small_n": 64}
    if kind == "zeros":
        return np.zeros((rows, n), np.float32), k5, {}
    if kind == "outlier":            # +-1 with a 1e8 outlier: one full bin
        x = np.sign(normal())
        x[:, n // 3] = 1e8
        return x, k5, {}
    if kind.startswith("cap"):
        return normal(), k5, {"cap": int(kind[3:])}
    if kind == "k1":
        return normal(), 1, {}
    if kind == "kn":
        return normal(), n, {}
    if kind == "normal":
        return normal(), k5, {}
    if kind == "bf16_grid":
        return np.round(rng.standard_normal((rows, n)) * 4).astype(
            ml_dtypes.bfloat16), k5, {}
    if kind == "subnormal":
        return (normal() * 1e-40).astype(np.float32), k5, {}
    if kind == "signed_zeros":       # negatives, -0.0 and +0.0 tie
        x = np.where(rng.random((rows, n)) < 0.5, -0.0, 0.0).astype(
            np.float32)
        x[:, ::5] = -1.5
        return x, n // 5 + 7, {}
    raise ValueError(kind)


_CASES = (
    [(f"ties_end_{w}", 2, 6 * CHUNK - 7) for w in ("first", "middle", "last")]
    + [(f"small_chunks_ties_end_{w}", 3, 16 * 64 - 5)
       for w in ("first", "middle", "last")]
    + [("zeros", 2, 3 * CHUNK + 5), ("outlier", 2, 20_000),
       ("cap0", 3, 20_001), ("cap1", 3, 20_001), ("cap0", 2, 300),
       ("k1", 2, SMALL_N + 9), ("kn", 2, SMALL_N + 9), ("k1", 3, 77),
       ("kn", 3, 77), ("normal", 2, SMALL_N), ("normal", 2, SMALL_N + 1)]
    + [("normal", 2, 2 * CHUNK + r) for r in (1, 2, 3)]
    + [("normal", 3, 100 + r) for r in (1, 2, 3)]
    + [("bf16_grid", 2, 2 * CHUNK + 16 + r) for r in range(1, 8)]
    + [("bf16_grid", 3, 96 + r) for r in range(1, 8)]
    + [("subnormal", 2, 3 * CHUNK), ("subnormal", 2, 500),
       ("signed_zeros", 2, 2 * CHUNK + 3), ("signed_zeros", 3, 90)])


@pytest.mark.parametrize("kind,rows,n", _CASES)
def test_radix_emulation_matches_oracle_and_plain(kind, rows, n):
    x, k, kw = _case(kind, rows, n, seed=n + rows)
    v_ref, i_ref = _ORACLE(jnp.asarray(x), k)
    t = _torch(x)
    v, i = tref.topk_compress_radix_plain(t, k, **kw)
    vp, ip = tref.topk_compress_plain(t, k)
    assert v.dtype == t.dtype and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(_tbits(v).numpy().view(_bits(v_ref).dtype),
                                  _bits(v_ref))
    assert torch.equal(i, ip) and torch.equal(_tbits(v), _tbits(vp))


def test_the_cases_reach_their_paths():
    """The cases above take the paths they are named for: the taken ties
    end in the chunk named, a full bin (zeros, +-1) overflows the
    candidate buffer, caps 0 and 1 refuse the candidates, and a normal
    large row uses them."""
    for where, end, chunk, n in (("first", 0, CHUNK, 6 * CHUNK - 7),
                                 ("middle", 2, CHUNK, 6 * CHUNK - 7),
                                 ("last", 5, CHUNK, 6 * CHUNK - 7),
                                 ("middle", 7, 64, 16 * 64 - 5)):
        x, k, kw = _case(f"ties_end_{where}" if chunk == CHUNK else
                         f"small_chunks_ties_end_{where}", 2, n, seed=n + 2)
        ts, fills, _, _ = tref.topk_radix_select(_torch(x), k, **{
            a: b for a, b in kw.items() if a != "chunk"})
        keys = tref.topk_keys(_torch(x))[0]
        ties = torch.cumsum(keys == ts[0], 0)
        assert 0 < fills[0] < int(ties[-1])          # part of the ties
        last = int(torch.nonzero(ties == fills[0])[0])
        assert last // chunk == end
    for kind, rows, n, used in (("zeros", 2, 3 * CHUNK + 5, False),
                                ("outlier", 2, 20_000, False),
                                ("cap0", 3, 20_001, False),
                                ("cap1", 3, 20_001, False),
                                ("normal", 2, 2 * CHUNK + 1, True)):
        x, k, kw = _case(kind, rows, n, seed=n + rows)
        _, _, c1, use = tref.topk_radix_select(_torch(x), k, **kw)
        assert use == [used] * rows, (kind, c1)
    _, _, c1, use = tref.topk_radix_select(_torch(_case("normal", 2, SMALL_N,
                                                        0)[0]), 5)
    assert c1 == [0, 0] and use == [False, False]    # a small row


def test_constants_match_the_cuda_source():
    """The emulation's constants are the kernel's: the digit widths, the
    small-row limit, the compaction's chunk, the candidate capacity."""
    src = (pathlib.Path(tref.__file__).parent / "csrc"
           / "topk_compress.cu").read_text()
    const = lambda name: int(re.search(  # noqa: E731
        rf"constexpr int {name} = (\d+);", src).group(1))
    assert "constexpr int DIGIT3 = 31 - DIGIT1 - DIGIT2;" in src
    assert tref.TOPK_DIGITS == (const("DIGIT1"), const("DIGIT2"),
                                31 - const("DIGIT1") - const("DIGIT2"))
    assert const("SMALL_N") == tref.TOPK_SMALL_N
    assert const("CHUNK") == tref.TOPK_CHUNK
    assert const("CAP_SHIFT") == tref.TOPK_CAP_SHIFT
    assert "o[F_CAP] = e[F_CAP] >= 0 ? std::min(e[F_CAP], n) : n >> " \
        "CAP_SHIFT;" in src
    assert "const bool small = e[F_N] <= SMALL_N;" in src
    params = inspect.signature(tref.topk_compress_radix_plain).parameters
    assert params["small_n"].default == tref.TOPK_SMALL_N
    assert params["chunk"].default == tref.TOPK_CHUNK
    assert params["digits"].default == tref.TOPK_DIGITS


_MAGS = (0.0, -0.0, 0.5, 1.0, 2.0, 3.0e-40, 1.0 + 2 ** -23)


@settings(max_examples=60, deadline=None)
@given(rows=st.integers(1, 3), n=st.integers(1, 300),
       k_frac=st.floats(0.0, 1.0), seed=st.integers(0, 2 ** 16),
       chunk=st.sampled_from((8, 32, 64)),
       small_n=st.sampled_from((0, 16, 64, 8192)),
       cap=st.sampled_from((None, 0, 1, 5)),
       bf16=st.booleans())
def test_radix_emulation_on_tie_heavy_rows(rows, n, k_frac, seed, chunk,
                                           small_n, cap, bf16):
    """Rows drawn from a few magnitudes (ties everywhere, signed zeros,
    a subnormal, two values one fp32 ulp apart) give the plain version's
    bits at any chunk, small-row limit and candidate capacity."""
    rng = np.random.default_rng(seed)
    x = rng.choice(np.array(_MAGS, np.float32), size=(rows, n))
    x = np.where(rng.random((rows, n)) < 0.5, -x, x).astype(np.float32)
    t = torch.from_numpy(x)
    if bf16:
        t = t.bfloat16()
    k = 1 + int(k_frac * (n - 1))
    v, i = tref.topk_compress_radix_plain(t, k, cap=cap, chunk=chunk,
                                          small_n=small_n)
    vp, ip = tref.topk_compress_plain(t, k)
    assert torch.equal(i, ip)
    assert torch.equal(_tbits(v), _tbits(vp))


# --------------------------------------------------------------------- #
# grouped calls


def test_grouped_plain_equals_per_segment_calls(monkeypatch):
    """ops.topk_compress_many on CPU tensors calls ops.topk_compress on
    each segment in turn (so tests that record those calls see every
    leaf) and returns what the per-segment calls return."""
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in ((4, 64), (4, 9000), (1, 17), (16, 300))]
    xs.append(torch.from_numpy(np.round(rng.standard_normal((2, 33)) * 2)
                               .astype(np.float32)).bfloat16())
    ks = [3, 450, 17, 15, 5]
    seen = []
    real = tops.topk_compress

    def recording(x, k, **kw):
        seen.append(k)
        return real(x, k, **kw)

    monkeypatch.setattr(tops, "topk_compress", recording)
    outs = tops.topk_compress_many(xs, ks, impl="plain")
    assert seen == ks
    assert tops.topk_compress_many([], [], impl="auto") == []
    for x, k, (v, i) in zip(xs, ks, outs):
        vp, ip = tref.topk_compress_plain(x, k)
        assert torch.equal(i, ip) and torch.equal(_tbits(v), _tbits(vp))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tops.topk_compress_many(xs, ks, impl="kernel")
    with pytest.raises(ValueError, match="one k per x"):
        tops.topk_compress_many(xs, ks[:-1])


def _shapes(model):
    if model == "resnet":
        tmpl = tres.resnet_init(None, CNNConfig(width=8), device="meta")
    elif model == "mlp":
        tmpl = tres.mlp_cls_init(None, MLPConfig(in_dim=16, hidden=(32, 8),
                                                 n_classes=4), device="meta")
    else:
        tmpl = build(get_config("rwkv6-1.6b").reduced(),
                     device="meta").init_train()
    return tmpl


def _fire_trees(model, seed, n=3):
    """Stacked [1, 2, 2, ...] trees of the model's leaves, each learner
    drifting on its own, fire after fire."""
    rng = np.random.default_rng(seed)
    tmpl = _shapes(model)
    base = tree_map(lambda m: torch.from_numpy(rng.standard_normal(
        (1, 2, 2) + tuple(m.shape)).astype(np.float32)), tmpl)
    out = []
    for _ in range(n):
        base = tree_map(lambda x: x + torch.from_numpy(
            0.1 * rng.standard_normal(x.shape).astype(np.float32)), base)
        out.append(base)
    return out


@pytest.mark.parametrize("model", ["resnet", "mlp", "rwkv6"])
def test_grouped_reducer_equals_the_per_leaf_loop(model, monkeypatch):
    """Two fires of TopKReducer.compress with a group budget that splits
    the leaves into several calls and sends the largest leaf alone, and
    with the default 1 GiB (one call), give the per-leaf loop's payload,
    EF state and RNG carry bit for bit."""
    trees = _fire_trees(model, seed=len(model))
    sizes = [4 * x.numel() for x in leaves(trees[0])]
    budget = max(sizes) - 1
    calls = []
    real = tsparse.ops.topk_compress_many

    def recording(xs, ks, **kw):
        calls.append([4 * x.numel() for x in xs])
        return real(xs, ks, **kw)

    monkeypatch.setattr(tsparse.ops, "topk_compress_many", recording)
    runs = {}
    for name, group in (("per_leaf", 0), ("split", budget),
                        ("default", None)):
        red = tsparse.TopKReducer(0.05)
        if group is not None:
            red.group_bytes = group
        state = red.init_state(trees[0])
        calls.clear()
        out = []
        for tree in trees[1:]:
            payload, state = red.compress(tree, state)
            out.append((payload, state))
        runs[name] = (out, list(calls))
    assert all(len(c) == 1 for c in runs["per_leaf"][1])
    split = runs["split"][1]                # two fires' calls
    assert 2 < len(split) // 2 < len(sizes) and [max(sizes)] in split
    assert all(sum(c) <= budget for c in split if len(c) > 1)
    assert [len(c) for c in runs["default"][1]] == [len(sizes)] * 2
    want, _ = runs["per_leaf"]
    for name in ("split", "default"):
        got, _ = runs[name]
        for (pw, sw), (pg, sg) in zip(want, got):
            assert len(pw) == len(pg) == len(sizes)
            for (vw, iw), (vg, ig) in zip(pw, pg):
                assert torch.equal(iw, ig) and torch.equal(_tbits(vw),
                                                           _tbits(vg))
            for a, b in zip(leaves(sw.err), leaves(sg.err)):
                assert torch.equal(_tbits(a), _tbits(b)), name
            for a, b in zip(leaves(sw.ref), leaves(sg.ref)):
                assert torch.equal(_tbits(a), _tbits(b)), name
            assert torch.equal(sw.key, sg.key)
