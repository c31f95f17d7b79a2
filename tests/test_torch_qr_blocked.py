"""The batched-QR kernel's plan and the emulation of its arithmetic.

``kernels/batched_qr.py::qr_plan`` maps the segments of a grouped call to
the CUDA kernel's CTAs (``csrc/batched_qr.cu``), and
``kernels/ref.py::batched_qr_blocked_plain`` runs the kernel's arithmetic
from that plan, operation for operation (each ``fmaf`` rounded once, the
sums in the kernel's fixed order).  The kernel itself needs the card;
``chip_smoke.py`` phase 8 holds it to the emulation bit for bit there.
Here on the CPU:

  * the plan covers every row of every panel exactly once, at every mode
    (a warp, a CTA, a cluster, a cluster in device memory) and past one
    launch's parameter block, and a panel's plan does not depend on the
    other segments of its call;
  * the emulation agrees with ``batched_qr_plain`` and with the Pallas
    kernel in interpret mode within QR_RTOL = 1e-5 of max|Q| (the same
    CGS2 recurrence, sums in another order), including a zero column and
    tall panels the plan splits over a cluster;
  * the grouped plain call equals per-panel calls bit for bit;
  * the constants the plan assumes are the kernel source's.
"""
import math
import re
from collections import defaultdict
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.batched_qr import batched_qr as pallas_qr  # noqa: E402
from repro_torch.kernels import batched_qr as kqr  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

QR_RTOL = 1e-5
SRC = Path(kqr.__file__).parent / "csrc" / "batched_qr.cu"

# one PowerSGD fire per leaf at chip_smoke's shapes, and shapes at every mode
RESNET_FIRE = ((16, 3, 2),) * 17 + ((16, 512, 2),)
RWKV_FIRE = ((4, 65536, 2), (4, 2048, 2)) + ((4, 4, 2),) * 22
GROUPS = {
    "resnet": RESNET_FIRE,
    "rwkv": RWKV_FIRE,
    "buckets": ((16, 1536, 2),) * 10,
    "modes": ((3, 7, 3), (2, 300, 5), (1, 10000, 2), (2, 40, 12),
              (1, 3000, 20), (1, 17000, 8), (2, 70000, 1)),
    "launches": ((2300, 300, 2), (280, 9000, 1), (5, 9, 1)),
    "pieces": ((1, 10, 2),) * 100,
}


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _panels(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_plan_covers_every_row_once(group):
    shapes = GROUPS[group]
    plan = kqr.qr_plan(shapes)
    spans = defaultdict(list)
    seen = set()
    for li, cta, s, panel, lo, hi in plan.cta_work():
        assert 0 <= lo <= hi <= shapes[s][1]
        ln = plan.launches[li]
        assert 0 <= cta < ln.ncta <= kqr.QR_MAX_CTAS
        seen.add((li, cta))
        if hi > lo:
            spans[(s, panel)].append((lo, hi))
    assert set(spans) == {(s, i) for s, (b, _, _) in enumerate(shapes)
                          for i in range(b)}
    for (s, _), got in spans.items():
        ends = [0] + [hi for _, hi in sorted(got)]
        # no gap, no overlap
        assert [lo for lo, _ in sorted(got)] == ends[:-1]
        assert ends[-1] == shapes[s][1]
    for li, ln in enumerate(plan.launches):
        assert len(ln.pieces) <= kqr.QR_MAX_SEGS
        assert ln.ncta % ln.cluster == 0
        # cluster panels first, each a whole cluster of the launch
        big = [c0 for (s, _, _), c0 in zip(ln.pieces, ln.ctas)
               if plan.panels[s].ctas > 1]
        assert all(c0 % kqr.QR_CLUSTER == 0 for c0 in big)
        assert ln.cluster == (kqr.QR_CLUSTER if big else 1)
        # only padding is idle
        idle = ln.ncta - len({c for i, c in seen if i == li})
        assert 0 <= idle < ln.cluster
    # each CTA's thread rows tile its range, in order, in whole units
    for s, pp in enumerate(plan.panels):
        a = shapes[s][1]
        for lo, hi in pp.row_ranges(a):
            owned = pp.thread_rows(lo, hi)
            assert sorted(r for t in owned for r in t) == list(range(lo, hi))
            assert all(t == sorted(t) for t in owned)
            assert max(len(t) for t in owned) <= (
                kqr.qr_thread_rows(shapes[s][2]) if pp.mode != "device"
                and shapes[s][2] <= 8 else a)


@pytest.mark.parametrize("a,r,mode", [
    (3, 2, "warp"), (256, 8, "warp"), (257, 8, "cta"), (8192, 2, "cta"),
    (8193, 2, "cluster"), (65536, 2, "cluster"), (65537, 2, "device"),
    (16384, 8, "cluster"), (65536, 8, "device"), (40, 12, "cta"),
    (1260, 12, "cta"), (1261, 12, "cluster"), (20000, 32, "device")])
def test_panel_plan_modes(a, r, mode):
    pp = kqr.panel_plan(a, r)
    assert pp.mode == mode
    if mode in ("cluster", "device"):
        assert pp.ctas == kqr.QR_CLUSTER and pp.span * pp.ctas >= a
    if r > 8 and mode in ("cta", "cluster"):
        assert 0 < pp.smem <= kqr.QR_SMEM_FLOATS * 4


@pytest.mark.parametrize("group", ["resnet", "rwkv", "modes"])
def test_panel_plan_independent_of_neighbours(group):
    """Each segment's panels get the same rows, ranks and packed fields
    alone as in the group: a panel's Q is the same bits either way."""
    shapes = GROUPS[group]
    grouped = kqr.qr_plan(shapes)

    def work(plan, seg):
        out = []
        for li, cta, s, panel, lo, hi in plan.cta_work():
            if s == seg:
                ln = plan.launches[li]
                k = [p[0] for p in ln.pieces].index(s)
                first = ln.ctas[k]
                ctas = plan.panels[s].ctas
                out.append((panel, lo, hi, (cta - first) % ctas))
        return sorted(out)

    for s, shape in enumerate(shapes):
        alone = kqr.qr_plan((shape,))
        assert grouped.panels[s] == alone.panels[0] \
            == kqr.panel_plan(*shape[1:])
        assert work(grouped, s) == work(alone, 0)


@pytest.mark.parametrize("shape", [
    (16, 3, 2), (4, 4, 2), (3, 7, 3), (16, 512, 2), (4, 1536, 2),
    (2, 300, 5), (2, 256, 8), (2, 40, 12), (1, 10000, 2), (1, 3000, 20),
    (1, 17000, 8)])
def test_blocked_emulation_matches_plain_and_pallas(shape):
    p = _panels(shape, sum(shape))
    q = tref.batched_qr_blocked_plain(_t(p)).numpy()
    plain = tref.batched_qr_plain(_t(p)).numpy()
    want = np.asarray(pallas_qr(jnp.asarray(p), interpret=True))
    for other in (plain, want):
        np.testing.assert_allclose(q, other, rtol=0,
                                   atol=QR_RTOL * np.abs(other).max())
    r = shape[-1]
    np.testing.assert_allclose(np.einsum("nar,nas->nrs", q, q),
                               np.broadcast_to(np.eye(r), (shape[0], r, r)),
                               rtol=0, atol=QR_RTOL)


@pytest.mark.parametrize("shape", [(3, 50, 4), (2, 9000, 2), (1, 1300, 12)])
def test_blocked_emulation_zero_column(shape):
    """A zero column and a whole zero panel come back as exact zeros, at a
    CTA and at a cluster, as the Pallas kernel gives them."""
    p = _panels(shape, 5)
    p[:, :, 1] = 0.0
    p[-1] = 0.0
    q = tref.batched_qr_blocked_plain(_t(p)).numpy()
    assert np.isfinite(q).all()
    assert (q[:, :, 1] == 0).all() and (q[-1] == 0).all()
    want = np.asarray(pallas_qr(jnp.asarray(p), interpret=True))
    np.testing.assert_allclose(q, want, rtol=0,
                               atol=QR_RTOL * np.abs(want).max())


def test_blocked_emulation_schedule_control():
    """The emulation follows the plan's schedule: the same panels with
    each thread taking one row at a time (another sum order) give other
    bits, so chip_smoke.py's 0-ulp limit against the emulation would catch
    a kernel that sums in another order."""
    p = _t(_panels((16, 1536, 2), 7))
    pp = kqr.panel_plan(1536, 2)
    q = tref.batched_qr_blocked_plain(p, pp)
    assert torch.equal(q, tref.batched_qr_blocked_plain(p))
    other = tref.batched_qr_blocked_plain(p, pp._replace(unit=1))
    assert not torch.equal(q.view(torch.int32), other.view(torch.int32))
    assert (q - other).abs().max() < QR_RTOL


def test_plain_many_equals_single_calls():
    shapes = RESNET_FIRE[-3:] + RWKV_FIRE[1:4] + ((2, 40, 12),)
    ps = [_t(_panels(s, i)) for i, s in enumerate(shapes)]
    ps.append(_t(_panels((2, 3, 30, 4), 9)))          # leading dims kept
    got = tops.batched_qr_many(ps, impl="plain")
    for q, p in zip(got, ps):
        assert q.shape == p.shape
        assert torch.equal(q.view(torch.int32),
                           tops.batched_qr(p, impl="plain").view(torch.int32))
    assert tops.batched_qr_many([], impl="plain") == []
    with pytest.raises(ValueError, match="CUDA"):
        tops.batched_qr_many(ps, impl="kernel")
    with pytest.raises(ValueError):
        tops.batched_qr_many(ps, impl="bogus")


def test_qr_rsqrt_correctly_rounded():
    """The kernel's inverse norm (``__frsqrt_rn``): the fp32 value nearest
    1 / sqrt(x), checked against exact rationals: x^(-1/2) lies between
    the midpoints to the result's neighbours, m_lo^2 x < 1 < m_hi^2 x."""
    rng = np.random.default_rng(11)
    x = np.concatenate([
        np.exp(rng.uniform(np.log(1e-30), np.log(3e38), 3000)),
        rng.uniform(0.5, 8.0, 2000),
        [1e-30, 2.0, 3.0, 0.3, 4.0, 1.0, 3.4e38]]).astype(np.float32)
    got = tref.qr_rsqrt(torch.from_numpy(x))
    inf = torch.tensor(math.inf)
    lo = torch.nextafter(got, torch.tensor(0.0))
    hi = torch.nextafter(got, inf)
    for xi, gi, li, hi_ in zip(x.tolist(), got.tolist(), lo.tolist(),
                               hi.tolist()):
        fx, fg = Fraction(xi), Fraction(gi)
        assert ((Fraction(li) + fg) / 2) ** 2 * fx < 1
        assert ((fg + Fraction(hi_)) / 2) ** 2 * fx > 1


def test_plan_constants_match_kernel_source():
    src = SRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))
    assert const("THREADS") == kqr.QR_THREADS
    assert const("CLUSTER") == kqr.QR_CLUSTER
    assert const("REG_FLOATS") == kqr.QR_REG_FLOATS
    assert const("SMEM_FLOATS") == kqr.QR_SMEM_FLOATS
    assert const("WARP_ROWS") == kqr.QR_WARP_ROWS
    assert const("RMAX") == kqr.MAX_RANK
    assert const("MAX_SEGS") == kqr.QR_MAX_SEGS
    assert const("PARAM_BYTES") == kqr.QR_PARAM_BYTES
    assert "int batch, a, r, mode, span, cta0;" in src
    assert kqr.MODES == ("warp", "cta", "cluster", "device")
    assert re.search(r"M_WARP = 0, M_CTA = 1, M_CLUSTER = 2, M_DEVICE = 3",
                     src)
    # the packed block's size, and an idle CTA's byte
    plan = kqr.qr_plan(RWKV_FIRE)
    assert all(len(ln.params) == kqr.QR_PARAM_BYTES for ln in plan.launches)
    assert "IDLE = 255" in src and kqr._IDLE == 255
