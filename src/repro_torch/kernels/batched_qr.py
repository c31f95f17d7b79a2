"""Batched thin-QR Q factor (CGS2): the plan and the wrapper of the
hand-written Hopper kernel ``csrc/batched_qr.cu``.

The kernel replaces the Pallas TPU kernel
``repro/kernels/batched_qr.py::batched_qr``; the source's header says what
bounds it (bytes, and at the trainer's sizes the latency of one load, a
few reductions and the launch) and what its design does about that.

One call serves many segments, each a stack of panels ``[batch, a, r]``
(the compressible leaves or the bucket of a PowerSGD fire):
:func:`batched_qr_many`.  :func:`qr_plan` maps the segments to the
kernel's work: each panel, by its own ``(a, r)`` alone (:func:`panel_plan`),
is one warp of a CTA that holds several small panels, one CTA, a
thread-block cluster of ``QR_CLUSTER`` CTAs that holds it on chip, or, past
what a cluster holds, a cluster that works it in place in device memory.
So a panel's result is the same bits alone or in a group, and
``kernels/ref.py::batched_qr_blocked_plain`` emulates it from the same
plan.  The wrapper checks device, shape and size, allocates the outputs,
hands the plan to the kernel as its 4 KB parameter block (no copy to the
device ahead of the launch), launches on PyTorch's current stream and
raises if the launch was refused.  It takes CUDA
tensors only: ``kernels/ops.py`` routes CPU tensors to the plain version
in ``kernels/ref.py``.

``batched_qr.launches`` counts the segments served by the kernel (and
nothing else); ``batched_qr.calls`` counts the grouped calls.
"""
from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels import _build

MAX_RANK = 32
# the kernel's shape (csrc/batched_qr.cu holds the same constants; the
# CPU tests read them from there)
QR_THREADS = 256           # threads a CTA
QR_CLUSTER = 8             # CTAs of a cluster panel
QR_REG_FLOATS = 64         # panel values a thread holds in registers
QR_SMEM_FLOATS = 16384     # panel values a CTA holds in shared memory
QR_WARP_ROWS = 256         # the most rows of a panel that a warp takes
MODES = ("warp", "cta", "cluster", "device")
# the kernel's parameter block (csrc/batched_qr.cu, Params): QR_MAX_SEGS
# pieces of 40 bytes (p, q, batch, a, r, mode, span, first CTA), the
# counts of pieces and CTAs, then a byte a CTA naming its piece (_IDLE:
# padding); 4 KB, the kernel parameter limit
QR_PARAM_BYTES = 4096
QR_MAX_SEGS = 48
_SEG_FMT = "<QQiiiiii"
_SEG_BYTES = struct.calcsize(_SEG_FMT)
_OWNER_AT = QR_MAX_SEGS * _SEG_BYTES + 8
QR_MAX_CTAS = QR_PARAM_BYTES - _OWNER_AT
_IDLE = 255


def qr_unit(r: int) -> int:
    """Rows a thread loads together: a whole number of 16-byte vectors
    (lcm(r, 4) / r) on the register path (r <= 8), one row otherwise."""
    return 4 // math.gcd(r, 4) if r <= 8 else 1


def qr_thread_rows(r: int) -> int:
    """The most rows a thread holds in registers (r <= 8): QR_REG_FLOATS
    values, in whole units."""
    return QR_REG_FLOATS // r // qr_unit(r) * qr_unit(r)


def qr_smem_stride(r: int) -> int:
    """Row stride in shared memory (r > 8): odd, so that the threads'
    rows fall in different banks."""
    return r | 1


def qr_cta_rows(r: int) -> int:
    """The most rows of a panel that one CTA holds on chip."""
    if r <= 8:
        return QR_THREADS * qr_thread_rows(r)
    return QR_SMEM_FLOATS // qr_smem_stride(r)


class PanelPlan(NamedTuple):
    """How the kernel works one panel of a segment."""
    mode: str        # one of MODES
    ctas: int        # CTAs over the panel's rows (1, or QR_CLUSTER)
    span: int        # rows of each of those CTAs (the last takes the rest)
    threads: int     # threads over a CTA's rows: 32 (warp) or QR_THREADS
    unit: int        # rows a thread takes together (qr_unit)
    per_cta: int     # panels a CTA holds (a warp each in "warp" mode)
    smem: int        # dynamic shared memory bytes it needs

    def row_ranges(self, a: int) -> List[Tuple[int, int]]:
        """The rows [lo, hi) of the panel that each of its CTAs holds."""
        return [(min(c * self.span, a), min((c + 1) * self.span, a))
                for c in range(self.ctas)]

    def thread_rows(self, lo: int, hi: int) -> List[List[int]]:
        """The panel rows that each thread of a CTA holding [lo, hi) owns,
        in the order its partial sums take them: units tid, tid + threads,
        ... of ``unit`` rows each."""
        out = []
        for t in range(self.threads):
            rows = []
            u = t
            while lo + u * self.unit < hi:
                rows += [lo + u * self.unit + i for i in range(self.unit)
                         if lo + u * self.unit + i < hi]
                u += self.threads
            out.append(rows)
        return out


@functools.lru_cache(maxsize=1024)
def panel_plan(a: int, r: int) -> PanelPlan:
    """The plan of one ``[a, r]`` panel: a function of (a, r) alone."""
    if not 1 <= r <= MAX_RANK or a < r:
        raise ValueError(f"batched_qr takes 1 <= r <= min(a, {MAX_RANK}), "
                         f"got a={a}, r={r}")
    unit, cap = qr_unit(r), qr_cta_rows(r)
    if r <= 8 and a <= QR_WARP_ROWS:
        return PanelPlan("warp", 1, a, 32, unit, QR_THREADS // 32, 0)
    if a <= cap:
        smem = a * qr_smem_stride(r) * 4 if r > 8 else 0
        return PanelPlan("cta", 1, a, QR_THREADS, unit, 1, smem)
    if a <= QR_CLUSTER * cap:
        per = -(-a // QR_CLUSTER)
        span = -(-per // unit) * unit
        smem = span * qr_smem_stride(r) * 4 if r > 8 else 0
        return PanelPlan("cluster", QR_CLUSTER, span, QR_THREADS, unit, 1,
                         smem)
    return PanelPlan("device", QR_CLUSTER, -(-a // QR_CLUSTER), QR_THREADS,
                     1, 1, 0)


class QRLaunch(NamedTuple):
    """One launch of a call: pieces of segments and the kernel's parameter
    block (``csrc/batched_qr.cu``'s ``Params``) without their pointers."""
    pieces: Tuple[Tuple[int, int, int], ...]   # (segment, first panel,
                                               # panels)
    ctas: Tuple[int, ...]                      # each piece's first CTA
    ncta: int                                  # grid, padded to clusters
    cluster: int                               # the launch's cluster size
    smem: int                                  # dynamic shared memory
    params: bytes


class QRPlan(NamedTuple):
    """The work of one grouped call: one launch unless its pieces overflow
    the kernel's parameter block (QR_MAX_SEGS pieces, QR_MAX_CTAS CTAs)."""
    shapes: Tuple[Tuple[int, int, int], ...]   # (batch, a, r) a segment
    panels: Tuple[PanelPlan, ...]              # each segment's panel plan
    launches: Tuple[QRLaunch, ...]

    def cta_work(self):
        """Each CTA's work as the kernel reads it from its launch's
        parameters: (launch, CTA, segment, panel, rows [lo, hi)) for every
        panel rows the CTA holds; an idle CTA gives none."""
        for li, ln in enumerate(self.launches):
            for (s, first, cnt), c0 in zip(ln.pieces, ln.ctas):
                pp, a = self.panels[s], self.shapes[s][1]
                for c in range(_piece_ctas(pp, cnt)):
                    if pp.ctas > 1:
                        lo, hi = pp.row_ranges(a)[c % pp.ctas]
                        yield li, c0 + c, s, first + c // pp.ctas, lo, hi
                    else:
                        for i in range(c * pp.per_cta,
                                       min((c + 1) * pp.per_cta, cnt)):
                            yield li, c0 + c, s, first + i, 0, a


def _piece_ctas(pp: PanelPlan, panels: int) -> int:
    return panels * pp.ctas if pp.ctas > 1 else -(-panels // pp.per_cta)


def _launch(shapes, plans, pieces) -> QRLaunch:
    """Cluster pieces first, QR_CLUSTER CTAs a panel (so each holds a
    whole cluster of the launch), then the rest; the grid padded to whole
    clusters with idle CTAs."""
    order = sorted(range(len(pieces)),
                   key=lambda k: plans[pieces[k][0]].ctas == 1)
    pieces = [pieces[k] for k in order]
    cluster = QR_CLUSTER if plans[pieces[0][0]].ctas > 1 else 1
    ctas, owner = [], []
    for k, (s, _, cnt) in enumerate(pieces):
        ctas.append(len(owner))
        owner += [k] * _piece_ctas(plans[s], cnt)
    owner += [_IDLE] * (-len(owner) % cluster)
    buf = bytearray(QR_PARAM_BYTES)
    for k, ((s, _, cnt), c0) in enumerate(zip(pieces, ctas)):
        _, a, r = shapes[s]
        pp = plans[s]
        struct.pack_into(_SEG_FMT, buf, k * _SEG_BYTES, 0, 0, cnt, a, r,
                         MODES.index(pp.mode), pp.span, c0)
    struct.pack_into("<ii", buf, QR_MAX_SEGS * _SEG_BYTES, len(pieces),
                     len(owner))
    buf[_OWNER_AT:_OWNER_AT + len(owner)] = bytes(owner)
    return QRLaunch(tuple(pieces), tuple(ctas), len(owner), cluster,
                    max(plans[s].smem for s, _, _ in pieces), bytes(buf))


@functools.lru_cache(maxsize=64)
def qr_plan(shapes: Tuple[Tuple[int, int, int], ...]) -> QRPlan:
    """The work of one call over segments of ``(batch, a, r)``: each
    segment's panels in pieces of at most QR_MAX_CTAS CTAs, the pieces in
    launches of at most QR_MAX_SEGS pieces and QR_MAX_CTAS CTAs (one
    launch for a PowerSGD fire of ResNet-18 or of phase 12's rwkv6).  A
    CTA's rank in its panel is its rank in the cluster."""
    shapes = tuple((int(b), int(a), int(r)) for b, a, r in shapes)
    plans = tuple(panel_plan(a, r) for _, a, r in shapes)
    launches, cur, n = [], [], 0
    for s, ((b, _, _), pp) in enumerate(zip(shapes, plans)):
        most = (QR_MAX_CTAS - QR_CLUSTER) // _piece_ctas(pp, 1) * (
            1 if pp.ctas > 1 else pp.per_cta)
        for first in range(0, b, most):
            cnt = min(most, b - first)
            need = _piece_ctas(pp, cnt)
            if cur and (len(cur) == QR_MAX_SEGS
                        or n + need + QR_CLUSTER > QR_MAX_CTAS):
                launches.append(_launch(shapes, plans, cur))
                cur, n = [], 0
            cur.append((s, first, cnt))
            n += need
    launches.append(_launch(shapes, plans, cur))
    return QRPlan(shapes, plans, tuple(launches))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entry point's argument types on a build of the source."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.batched_qr_run.argtypes = [
        ctypes.c_char_p, ci, ci,         # parameter block, cluster, smem
        ci, vp]                          # device index, stream
    lib.batched_qr_run.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return declare(_build.load("batched_qr"))


def _check(ps: Sequence[torch.Tensor]) -> None:
    if not ps:
        raise ValueError("batched_qr_many needs at least one panel stack")
    if not all(p.is_cuda for p in ps):
        raise ValueError("batched_qr kernel takes CUDA tensors only; use "
                         "kernels.ops.batched_qr for CPU tensors")
    if len({p.device for p in ps}) != 1:
        raise ValueError("batched_qr inputs lie on different devices")
    for p in ps:
        if p.dim() < 2:
            raise ValueError(f"p must be [..., a, r], got {tuple(p.shape)}")
        a, r = p.shape[-2:]
        if a < r:
            raise ValueError(
                f"batched_qr needs a tall panel (a >= r), got "
                f"{tuple(p.shape)}")
        if not 1 <= r <= MAX_RANK:
            raise ValueError(f"batched_qr kernel takes 1 <= r <= "
                             f"{MAX_RANK}, got r={r}")
        if not 1 <= p.numel() // (a * r) < 2 ** 31 or a * r >= 2 ** 31:
            raise ValueError(f"unsupported panel batch {tuple(p.shape)}")


def batched_qr_many(ps: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each p [..., a, r] (1 <= r <= min(a, 32)) -> its Q [..., a, r] in
    p's dtype (computed in fp32), in one launch (more only past the
    parameter block's QR_MAX_SEGS pieces or QR_MAX_CTAS CTAs); a
    rank-deficient column comes back zero."""
    ps = list(ps)
    _check(ps)
    # few tensor calls a segment: the host's time a fire is the wrapper's
    xs = [p if p.dim() == 3 and p.dtype == torch.float32 and p.is_contiguous()
          else p.reshape(-1, *p.shape[-2:]).float().contiguous() for p in ps]
    sizes = [x.numel() for x in xs]
    dev = xs[0].device
    out = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    plan = qr_plan(tuple(tuple(x.shape) for x in xs))
    ins = [x.data_ptr() for x in xs]
    outs, at = [], out.data_ptr()
    for n in sizes:
        outs.append(at)
        at += n * 4
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    for ln in plan.launches:
        buf = bytearray(ln.params)
        for k, (s, first, _) in enumerate(ln.pieces):
            off = first * plan.shapes[s][1] * plan.shapes[s][2] * 4
            struct.pack_into("<QQ", buf, k * _SEG_BYTES, ins[s] + off,
                             outs[s] + off)
        err = lib.batched_qr_run(bytes(buf), ln.cluster, ln.smem, dev.index,
                                 stream)
        if err != 0:
            raise RuntimeError(f"batched_qr launch failed: cudaError {err} "
                               f"(segments {plan.shapes})")
    batched_qr.launches += len(xs)
    batched_qr.calls += 1
    return [q.view(p.shape) if p.dtype == torch.float32
            else q.view(p.shape).to(p.dtype)
            for q, p in zip(out.split(sizes), ps)]


def batched_qr(p: torch.Tensor) -> torch.Tensor:
    """[..., a, r] -> Q [..., a, r] in p's dtype (computed in fp32), with
    a >= r and r <= 32; a rank-deficient column comes back zero.  A
    one-segment :func:`batched_qr_many`."""
    return batched_qr_many([p])[0]


batched_qr.launches = 0
batched_qr.calls = 0
