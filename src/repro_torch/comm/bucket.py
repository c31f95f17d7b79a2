"""Bucketed flat-buffer reductions (PyTorch port of
``repro/comm/bucket.py``): pack the tree once, compress and average a few
big contiguous buckets instead of one reduction per leaf.

  * :class:`BucketLayout` — computed once per (structure, shapes, dtypes)
    of the parameter tree: dtype-grouped, size-capped buckets of the
    per-learner trailing dims, keeping the stacked ``[pods, G, S]``
    learner axes.  ``pack`` is one reshape per leaf and one concat per
    bucket; ``unpack`` is slices.
  * :class:`Bucketed` — wraps any comm/ Reducer so that it sees whole
    buckets as its leaves: a *global* k-of-the-bucket selection for
    topk/randk, one codec launch per bucket instead of many ragged ones.
  * :class:`Pipelined` — the same codec on the reference's double-buffered
    stage order, as a Python loop over uniform buckets.

Buckets carry the same learner axes as the leaves they pack
(``[pods, G, S, n]``; matrix mode ``[pods, G, S, a, b]``), so the grouped
means of core/topology.py apply to them unchanged.  Packing permutes no
values and the learner-axis mean is elementwise in a fixed order, so
bucketed and pipelined mean/cast are bit-identical to the per-leaf path.

Error-feedback state lives in bucket space: ``Bucketed.init_state`` packs
the params first, and every compress checks the carried state against the
layout, so a mismatch fails loudly instead of misaligning residuals.

Not ported: shard-aware layouts (``shards=``, the wire and codec views,
``bucket_shardings``), ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.comm.reducer import N_LEARNER_AXES, Reducer, serial_reduce
from repro_torch.tree import flatten, leaves, unflatten

# Default per-bucket cap (bytes of one learner's slice); HierAvgParams.
# bucket_bytes defaults to it.
DEFAULT_BUCKET_BYTES = 4 << 20


_NO_SHARDS = ("shard-aware bucket layouts (shards=, bucket_shardings) are "
              "not ported yet: ROADMAP Queue 1 item 7")


def _no_shards(shards) -> None:
    if shards is not None:
        raise NotImplementedError(_NO_SHARDS)


def dtype_name(dtype: torch.dtype) -> str:
    """The dtype's name as numpy and JAX spell it ("float32")."""
    return str(dtype).replace("torch.", "")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclass(frozen=True)
class BucketSlot:
    """Where one leaf lives inside its bucket."""

    leaf: int                  # index into the flattened tree
    offset: int                # element offset within the bucket
    size: int                  # per-learner element count
    shape: Tuple[int, ...]     # per-learner trailing shape


@dataclass(frozen=True)
class BucketSpec:
    """One contiguous, single-dtype bucket."""

    dtype: str                 # dtype name (hashable)
    size: int                  # unpadded run length
    shape: Tuple[int, ...]     # per-learner bucket shape: (run,) flat, or
                               # (a, b) zero-padded in matrix mode
    slots: Tuple[BucketSlot, ...]

    @property
    def padded_size(self) -> int:
        return math.prod(self.shape)


def _matrix_shape(size: int) -> Tuple[int, int]:
    """Near-square (a, b) with a*b >= size — matrix view for low-rank
    reducers (the pad is zero-filled and stripped on unpack)."""
    a = max(1, int(math.isqrt(size)))
    b = -(-size // a)
    return a, b


@dataclass(frozen=True)
class BucketLayout:
    """Static packing plan for one tree (shape/dtype) signature.

    ``lead_axes`` is the number of leading stacked-learner axes every leaf
    carries (3 for train-state trees, 0 for the single-learner templates
    ``payload_bytes`` sizes).
    """

    treedef: Any
    lead_axes: int
    buckets: Tuple[BucketSpec, ...]

    @classmethod
    def build(cls, tree, *, bucket_bytes: int = DEFAULT_BUCKET_BYTES,
              lead_axes: int = N_LEARNER_AXES,
              matrix: bool = False, uniform: bool = False,
              shards: Optional[Any] = None) -> "BucketLayout":
        """Dtype-grouped, size-capped buckets in leaf order.

        A leaf larger than ``bucket_bytes`` gets a bucket of its own
        (leaves are never split); ``bucket_bytes <= 0`` means one bucket
        per dtype.  ``matrix=True`` gives each bucket a near-square
        ``(a, b)`` shape.  ``uniform=True`` zero-pads every bucket of a
        multi-bucket dtype group to the group's largest run (matrix mode:
        to the elementwise-max panel), the rectangular schedule the
        pipelined engine iterates; single-bucket groups keep their size.
        Only shapes and dtypes are read, so a tree of meta tensors will
        do.
        """
        _no_shards(shards)
        flat, treedef = flatten(tree)
        groups: Dict[str, List[Tuple[int, Tuple[int, ...], int]]] = {}
        for i, leaf in enumerate(flat):
            if leaf.dim() < lead_axes:
                raise ValueError(
                    f"leaf {i} has shape {tuple(leaf.shape)} but the layout "
                    f"expects {lead_axes} leading learner axes")
            shape = tuple(leaf.shape[lead_axes:])
            size = math.prod(shape) if shape else 1
            groups.setdefault(dtype_name(leaf.dtype), []).append(
                (i, shape, size))

        buckets: List[BucketSpec] = []
        for name, entries in groups.items():          # insertion order
            itemsize = _dtype(name).itemsize
            cap = (bucket_bytes // itemsize) if bucket_bytes > 0 else 0
            slots: List[BucketSlot] = []
            filled = 0

            def flush():
                nonlocal slots, filled
                if not slots:
                    return
                shape: Tuple[int, ...] = (_matrix_shape(filled) if matrix
                                          else (filled,))
                buckets.append(BucketSpec(name, filled, shape, tuple(slots)))
                slots, filled = [], 0

            group_start = len(buckets)
            for i, shape, size in entries:
                if cap and slots and filled + size > cap:
                    flush()
                slots.append(BucketSlot(i, filled, size, shape))
                filled += size
            flush()
            group = buckets[group_start:]
            if uniform and len(group) > 1:
                pad_shape = tuple(max(b.shape[d] for b in group)
                                  for d in range(len(group[0].shape)))
                buckets[group_start:] = [
                    BucketSpec(b.dtype, b.size, pad_shape, b.slots)
                    for b in group]
        return cls(treedef, lead_axes, tuple(buckets))

    # -- derived facts ---------------------------------------------------- #

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def n_leaves(self) -> int:
        return sum(len(b.slots) for b in self.buckets)

    def bucket_structs(self, lead: Tuple[int, ...] = ()
                       ) -> List[torch.Tensor]:
        """Shape/dtype templates of the packed buckets, as meta tensors
        (nothing allocated): for accounting, and as the template argument
        of a codec's ``decompress``/``finalize``, which read only shapes
        and dtypes from it, so the tree is not packed a second time."""
        return [torch.empty(lead + b.shape, dtype=_dtype(b.dtype),
                            device="meta") for b in self.buckets]

    def describe(self) -> str:
        return (f"{self.n_leaves} leaves -> {self.n_buckets} bucket(s): "
                + ", ".join(f"{b.dtype}[{b.size}]" for b in self.buckets))

    def bucket_shardings(self):
        """The shard-aware lowering's per-bucket shardings: ROADMAP Queue 1
        item 7."""
        raise NotImplementedError(_NO_SHARDS)

    # -- pack / unpack ---------------------------------------------------- #

    def pack(self, tree) -> List[torch.Tensor]:
        """Tree -> list of bucket tensors ``[*lead, *bucket.shape]``.

        One reshape per leaf and one concat (into a new buffer) per
        bucket, then the zero pad; values are never permuted across
        learners.  A bucket of one unpadded leaf may be a view of it."""
        flat = leaves(tree)
        if len(flat) != self.n_leaves:
            raise ValueError(f"tree has {len(flat)} leaves, the layout "
                             f"{self.n_leaves}")
        out: List[torch.Tensor] = []
        for b in self.buckets:
            lead = tuple(flat[b.slots[0].leaf].shape[:self.lead_axes])
            parts = [flat[s.leaf].reshape(lead + (s.size,))
                     for s in b.slots]
            x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
            pad = b.padded_size - b.size
            if pad:
                x = torch.nn.functional.pad(x, (0, pad))
            out.append(x.reshape(lead + b.shape))
        return out

    def unpack(self, buckets) -> Any:
        """Inverse of :meth:`pack` (padding stripped).  Each leaf is a
        contiguous copy of its slice, so no leaf keeps its bucket alive."""
        out: List[Any] = [None] * self.n_leaves
        for b, arr in zip(self.buckets, buckets):
            lead = tuple(arr.shape[:arr.dim() - len(b.shape)])
            flat = arr.reshape(lead + (b.padded_size,))
            for s in b.slots:
                piece = flat[..., s.offset:s.offset + s.size]
                out[s.leaf] = piece.reshape(lead + s.shape).contiguous()
        return unflatten(self.treedef, out)


# --------------------------------------------------------------------- #
# the Bucketed reducer wrapper


def _signature(tree, lead_axes: int):
    flat, treedef = flatten(tree)
    return (treedef, lead_axes,
            tuple((tuple(x.shape), dtype_name(x.dtype)) for x in flat))


def _lead(tree, lead_axes: int) -> Tuple[int, ...]:
    return tuple(leaves(tree)[0].shape[:lead_axes])


class Bucketed(Reducer):
    """Run any comm/ Reducer on packed buckets instead of raw leaves.

    The wrapped reducer's codec is unchanged: it sees ``n_buckets`` flat
    (or, for ``wants_matrix`` reducers like PowerSGD, near-square) leaves
    instead of ``n_leaves`` ragged ones.  Stateful reducers carry their
    EF/warm-start state in bucket space, so ``init_state`` must be built
    from the layout the round uses (``compress`` checks).
    """

    name = "bucketed"
    # Pipelined sets it: uniform (rectangular) bucket shapes
    uniform_layout = False
    # set by the explicit ":pipelined" spec modifier: plan resolution keeps
    # the pipelined engine even when the plan's overlap knob is off
    pipeline_pin = False

    def __init__(self, inner: Reducer, bucket_bytes: Optional[int] = None,
                 shards: Optional[Any] = None):
        """``bucket_bytes=None`` means "inherit": DEFAULT_BUCKET_BYTES
        until plan resolution (core/plan.py apply_bucketing) re-caps the
        wrapper with ``HierAvgParams.bucket_bytes``."""
        _no_shards(shards)
        if isinstance(inner, Bucketed):
            inner = inner.inner
        if bucket_bytes is not None and bucket_bytes < 0:
            raise ValueError(
                f"bucket_bytes must be >= 0, got {bucket_bytes}")
        self.inner = inner
        self.bucket_bytes = None if bucket_bytes is None \
            else int(bucket_bytes)
        self.stateful = inner.stateful
        self._layouts: Dict[Any, BucketLayout] = {}

    @property
    def effective_bucket_bytes(self) -> int:
        return DEFAULT_BUCKET_BYTES if self.bucket_bytes is None \
            else self.bucket_bytes

    @property
    def has_codec(self) -> bool:
        return self.inner.has_codec

    @property
    def codec_name(self) -> str:
        return self.inner.codec_name

    # -- layout ---------------------------------------------------------- #

    def layout_for(self, tree, lead_axes: int = N_LEARNER_AXES
                   ) -> BucketLayout:
        """The (cached) layout for this tree's signature."""
        key = _signature(tree, lead_axes)
        lay = self._layouts.get(key)
        if lay is None:
            lay = BucketLayout.build(
                tree, bucket_bytes=self.effective_bucket_bytes,
                lead_axes=lead_axes,
                matrix=getattr(self.inner, "wants_matrix", False),
                uniform=self.uniform_layout)
            self._layouts[key] = lay
        return lay

    def _check_state(self, lay: BucketLayout, state, lead: Tuple[int, ...]):
        refs = getattr(state, "ref", None)
        if refs is None:
            return
        got = [tuple(r.shape) for r in leaves(refs)]
        want = [lead + b.shape for b in lay.buckets]
        if got != want:
            raise ValueError(
                "bucketed reducer state does not match the bucket layout "
                f"(state buckets {got}, layout wants {want}); build the "
                "initial state with init_state(..., plan=...) using the "
                "same plan/bucket_bytes the round was built with")

    # -- carried state --------------------------------------------------- #

    def init_state(self, params):
        return self.inner.init_state(self.layout_for(params).pack(params))

    # -- codec ----------------------------------------------------------- #

    def compress(self, tree, state):
        lay = self.layout_for(tree)
        if self.stateful:
            self._check_state(lay, state, _lead(tree, lay.lead_axes))
        return self.inner.compress(lay.pack(tree), state)

    def decompress(self, payload, like, state):
        # the reconstruction stays in bucket space: the grouped mean that
        # follows is elementwise over the lead axes, so it averages
        # buckets exactly as it would leaves
        lay = self.layout_for(like)
        return self.inner.decompress(
            payload, lay.bucket_structs(_lead(like, lay.lead_axes)), state)

    def finalize(self, avg_tree, orig_tree, state):
        lay = self.layout_for(orig_tree)
        out, state = self.inner.finalize(
            avg_tree, lay.bucket_structs(_lead(orig_tree, lay.lead_axes)), state)
        return lay.unpack(out), state

    def reduce(self, avg_fn, tree, state, constraint_fn=None):
        """The serial schedule: compress every bucket, reconstruct,
        average, finalize."""
        return serial_reduce(self, avg_fn, tree, state, constraint_fn)

    # -- accounting ------------------------------------------------------ #

    def payload_bytes(self, tree) -> int:
        lay = self.layout_for(tree, lead_axes=0)
        return self.inner.payload_bytes(lay.bucket_structs())

    def n_messages(self, tree) -> int:
        """What the inner codec dispatches per *bucket*: one for single-
        buffer codecs, two for two-pass qint8 and for compressible
        PowerSGD buckets."""
        lay = self.layout_for(tree, lead_axes=0)
        return self.inner.n_messages(lay.bucket_structs())

    def _describe(self) -> str:
        return f"{self.inner.describe()}:bucketed"


# --------------------------------------------------------------------- #
# the pipelined bucket schedule


class Pipelined(Bucketed):
    """Bucketed reductions in the reference's double-buffered stage order.

    The reference runs a ``lax.scan`` over uniform buckets whose iteration
    *i* issues stage *i-1*'s grouped mean, finalizes that stage, then
    compresses bucket *i*, so an async-collective backend overlaps the
    two.  Here the scan is a Python loop with the same order over the same
    uniform (zero-padded) layout.  On one card the mean is a local tensor
    op, so nothing overlaps yet: that needs a side-stream collective
    (ROADMAP Queue 1 item 7).

    Semantics: a schedule change only.  On the same layout it is bit-
    identical to the serial schedule for every codec (mean, cast, qint8,
    topk, randk, powersgd), state included.  Against the ragged serial
    layout ``topk`` picks k of the padded bucket and ``powersgd``
    factorizes the common panel, as in the reference.  A layout of one
    bucket, or a state that cannot be split per bucket, takes the serial
    schedule.
    """

    name = "pipelined"
    overlaps = True
    uniform_layout = True

    def _stage(self, bucket, st):
        """Compress and reconstruct one bucket."""
        payload, st2 = self.inner.compress([bucket], st)
        xhat = self.inner.decompress(payload, [bucket], st2)
        return xhat[0], st2

    def reduce(self, avg_fn, tree, state, constraint_fn=None):
        lay = self.layout_for(tree)
        n = lay.n_buckets
        sts = (self.inner.split_bucket_states(state, n) if self.stateful
               else [() for _ in range(n)])
        if n < 2 or sts is None:
            return Bucketed.reduce(self, avg_fn, tree, state, constraint_fn)
        lead = _lead(tree, lay.lead_axes)
        if self.stateful:
            self._check_state(lay, state, lead)
        buckets = lay.pack(tree)

        def gavg(xhat):
            return avg_fn([xhat], constraint_fn)[0]

        outs: List[Any] = [None] * n
        fin: List[Any] = list(sts)
        # a run of equal (dtype, shape) buckets is one pipeline; a run of
        # one has no neighbour to overlap
        groups: Dict[Tuple[str, Tuple[int, ...]], List[int]] = {}
        for i, b in enumerate(lay.buckets):
            groups.setdefault((b.dtype, b.shape), []).append(i)
        for idxs in groups.values():
            xh, st = self._stage(buckets[idxs[0]], sts[idxs[0]])
            for prev, i in zip(idxs, idxs[1:]):
                # stage prev's mean first, then its finalize (bucket i of
                # the same shape and dtype stands in as the template),
                # then the compress of bucket i
                outb, fin[prev] = self.inner.finalize(
                    [gavg(xh)], [buckets[i]], st)
                outs[prev] = outb[0]
                xh, st = self._stage(buckets[i], sts[i])
            # drain: the last stage's mean and finalize
            outb, fin[idxs[-1]] = self.inner.finalize(
                [gavg(xh)], [buckets[idxs[-1]]], st)
            outs[idxs[-1]] = outb[0]
        new_state = (self.inner.join_bucket_states(state, fin)
                     if self.stateful else state)
        return lay.unpack(outs), new_state

    def _describe(self) -> str:
        # only an explicit ':pipelined' pin round-trips as one: auto
        # wrappers (engine chosen by the plan's overlap knob) describe as
        # ':bucketed', so re-parsing under another overlap re-chooses
        suffix = ":pipelined" if self.pipeline_pin else ":bucketed"
        return f"{self.inner.describe()}{suffix}"
