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

Shard-aware layouts (``fsdp > 1``): built with a
:class:`~repro_torch.parallel.sharding.ShardPlan`, leaves whose trailing
dims the plan shards pack into *per-shard runs*, bucket shape
``[pods, G, S, F, run]`` with ``F`` the shard coordinate (the *wire*
view).  The codec sees the merged view ``[pods, G, S*F, run]`` (shards act
as extra learners), so top-k/EF selection is per shard and EF state lives
in shard space.  Runs are padded to a multiple of the learner count on
the mesh, so every level's reduce-scatter tiles evenly.  On a mesh of
ranks each rank holds one shard of its learners: it packs only its own
runs (``F`` is 1 in its tensors), its grouped means run as reduce-scatter
+ all-gather over its same-shard peers (core/topology.py), and one
all-gather over the learner's fsdp group (:meth:`BucketLayout.regather`)
rebuilds the full buckets before unpacking.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.comm.reducer import N_LEARNER_AXES, Reducer, serial_reduce
from repro_torch.telemetry.spans import span
from repro_torch.tree import flatten, leaf_paths, leaves, tree_map, unflatten

# Default per-bucket cap (bytes of one learner's slice); HierAvgParams.
# bucket_bytes defaults to it.
DEFAULT_BUCKET_BYTES = 4 << 20


def dtype_name(dtype: torch.dtype) -> str:
    """The dtype's name as numpy and JAX spell it ("float32")."""
    return str(dtype).replace("torch.", "")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclass(frozen=True)
class BucketSlot:
    """Where one leaf lives inside its bucket.  In a sharded bucket
    (``BucketSpec.shards > 1``) ``offset``/``size`` count *per-shard*
    elements, ``size = leaf_size / F``."""

    leaf: int                  # index into the flattened tree
    offset: int                # element offset within the bucket (run)
    size: int                  # per-learner (per-shard if sharded) count
    shape: Tuple[int, ...]     # per-learner trailing shape
    shard_dim: Optional[int] = None   # which trailing dim fsdp shards


@dataclass(frozen=True)
class BucketSpec:
    """One contiguous, single-dtype bucket."""

    dtype: str                 # dtype name (hashable)
    size: int                  # unpadded run length (per shard if sharded)
    shape: Tuple[int, ...]     # per-learner bucket shape: (run,) flat,
                               # (F, run) sharded, or (a, b) zero-padded
                               # in matrix mode
    slots: Tuple[BucketSlot, ...]
    shards: int = 1            # fsdp shard count F (1 == replicated run)

    @property
    def padded_size(self) -> int:
        return math.prod(self.shape)


def _matrix_shape(size: int) -> Tuple[int, int]:
    """Near-square (a, b) with a*b >= size — matrix view for low-rank
    reducers (the pad is zero-filled and stripped on unpack)."""
    a = max(1, int(math.isqrt(size)))
    b = -(-size // a)
    return a, b


def _split_shard(x, lead: int, sd: int, F: int):
    """``[*lead, *trailing]`` -> ``[*lead, F, run]``: the fsdp shard
    coordinate of trailing dim ``sd`` as an explicit F-major axis (a dim
    shards into F contiguous blocks, as GSPMD shards it)."""
    a = lead + sd
    d = x.shape[a]
    y = x.reshape(tuple(x.shape[:a]) + (F, d // F) + tuple(x.shape[a + 1:]))
    y = torch.movedim(y, a, lead)
    return y.reshape(tuple(y.shape[:lead + 1]) + (-1,))


def _join_shard(y, lead: int, sd: int, shape: Tuple[int, ...], F: int):
    """Inverse of :func:`_split_shard`: ``[*lead, F, run]`` back to the
    leaf's per-learner ``shape``."""
    rest = shape[:sd] + (shape[sd] // F,) + shape[sd + 1:]
    y = y.reshape(tuple(y.shape[:lead]) + (F,) + rest)
    y = torch.movedim(y, lead, lead + sd)
    return y.reshape(tuple(y.shape[:lead]) + tuple(shape))


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
    shards: Optional[Any] = None       # parallel/sharding.py ShardPlan

    @property
    def lead_invariant(self) -> bool:
        """True when the packed runs do not depend on the learner count,
        which the elastic fleet reshape (elastic/reshape.py) needs to
        re-index bucket-space EF state.  Shard-aware layouts pad runs to
        the mesh's learner count and merge shards into the codec view, so
        their reducer state is dropped loudly on a reshape instead."""
        return self.shards is None

    @property
    def local_shards(self) -> int:
        """Shards of each learner this process holds (1 on a mesh of
        ranks, F in one process)."""
        return 1 if self.shards is None else self.shards.local_shards

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

        ``shards`` (a ``ShardPlan`` of an ``fsdp > 1`` mesh) makes the
        layout shard-aware: leaves whose trailing dims the plan shards
        (per leaf path, with ``safe_pspec``'s divisibility fallback) go to
        sharded buckets of shape ``(F, run)``, the others pack flat, and
        every run is padded to a multiple of the mesh's learner count.
        Matrix-mode (low-rank) reducers cannot act on a per-shard run, so
        matrix + sharded leaves refuses.
        """
        flat, treedef = flatten(tree)
        paths = leaf_paths(tree)
        F = shards.size if shards is not None else 1
        n_lead = shards.n_lead if shards is not None else 1
        groups: Dict[Tuple[str, bool],
                     List[Tuple[int, Tuple[int, ...], int,
                                Optional[int]]]] = {}
        for i, leaf in enumerate(flat):
            if leaf.dim() < lead_axes:
                raise ValueError(
                    f"leaf {i} has shape {tuple(leaf.shape)} but the layout "
                    f"expects {lead_axes} leading learner axes")
            shape = tuple(leaf.shape[lead_axes:])
            size = math.prod(shape) if shape else 1
            sd = None
            if shards is not None and F > 1:
                sd = shards.leaf_shard_dim(paths[i], shape)
            if sd is not None and matrix:
                raise NotImplementedError(
                    f"matrix-mode (low-rank) reducers cannot pack "
                    f"fsdp-sharded leaves: leaf {paths[i]} is sharded on "
                    f"trailing dim {sd}; use a coordinate-wise reducer "
                    f"(mean/cast/topk/randk/qint8) under fsdp>1, or run "
                    f"PowerSGD with fsdp=1")
            run = size // F if sd is not None else size
            groups.setdefault((dtype_name(leaf.dtype), sd is not None),
                              []).append((i, shape, run, sd))

        buckets: List[BucketSpec] = []
        for (name, sharded), entries in groups.items():   # insertion order
            itemsize = _dtype(name).itemsize
            shard_n = F if sharded else 1
            cap = (bucket_bytes // itemsize) if bucket_bytes > 0 else 0
            cap = max(1, cap // shard_n) if cap else 0     # per-shard units
            slots: List[BucketSlot] = []
            filled = 0

            def flush():
                nonlocal slots, filled
                if not slots:
                    return
                if matrix:
                    shape: Tuple[int, ...] = _matrix_shape(filled)
                else:
                    run_p = filled if shards is None \
                        else -(-filled // n_lead) * n_lead
                    shape = (shard_n, run_p) if sharded else (run_p,)
                buckets.append(BucketSpec(name, filled, shape,
                                          tuple(slots), shard_n))
                slots, filled = [], 0

            group_start = len(buckets)
            for i, shape, run, sd in entries:
                if cap and slots and filled + run > cap:
                    flush()
                slots.append(BucketSlot(i, filled, run, shape, sd))
                filled += run
            flush()
            group = buckets[group_start:]
            if uniform and len(group) > 1:
                if matrix:
                    pad_shape = tuple(max(b.shape[d] for b in group)
                                      for d in range(len(group[0].shape)))
                else:
                    pad_n = max(b.shape[-1] for b in group)
                    pad_shape = group[0].shape[:-1] + (pad_n,)
                buckets[group_start:] = [
                    BucketSpec(b.dtype, b.size, pad_shape, b.slots, b.shards)
                    for b in group]
        return cls(treedef, lead_axes, tuple(buckets), shards)

    # -- derived facts ---------------------------------------------------- #

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def n_leaves(self) -> int:
        return sum(len(b.slots) for b in self.buckets)

    def bucket_structs(self, lead: Tuple[int, ...] = ()
                       ) -> List[torch.Tensor]:
        """Shape/dtype templates of the packed buckets (all F shards), as
        meta tensors (nothing allocated): for accounting."""
        return [torch.empty(lead + b.shape, dtype=_dtype(b.dtype),
                            device="meta") for b in self.buckets]

    def codec_structs(self, lead: Tuple[int, ...]) -> List[torch.Tensor]:
        """Meta templates of this process's buckets in the codec view
        (sharded: ``lead[:-1] + (lead[-1] * local_shards, run)``): the
        template argument of a codec's ``decompress``/``finalize``, which
        read only shapes and dtypes from it, so the tree is not packed a
        second time."""
        return [torch.empty(self._codec_shape(b, lead),
                            dtype=_dtype(b.dtype), device="meta")
                for b in self.buckets]

    def _codec_shape(self, b: BucketSpec, lead: Tuple[int, ...]):
        if b.shards == 1:
            return lead + b.shape
        return lead[:-1] + (lead[-1] * self.local_shards,) + b.shape[1:]

    def describe(self) -> str:
        return (f"{self.n_leaves} leaves -> {self.n_buckets} bucket(s): "
                + ", ".join(
                    (f"{b.dtype}[{b.shards}x{b.size}]" if b.shards > 1
                     else f"{b.dtype}[{b.size}]")
                    for b in self.buckets))

    def bucket_shardings(self):
        """Per-bucket ``RankSharding``\\ s of the wire view (None entries
        keep the all-reduce mean), or None when the layout is replicated
        (fsdp=1) or an accounting layout (``lead_axes=0``)."""
        if self.shards is None:
            return None
        from repro_torch.parallel.sharding import P, RankSharding
        lead = tuple(self.shards.lead)
        if self.lead_axes != len(lead):
            return None
        mesh = self.shards.mesh
        specs = []
        for b in self.buckets:
            if b.shards > 1:
                specs.append(RankSharding(mesh, P(*lead, self.shards.axis,
                                                  None)))
            elif len(b.shape) == 1:
                specs.append(RankSharding(mesh, P(*lead, None)))
            else:                     # matrix buckets: the all-reduce
                specs.append(None)
        return specs

    # -- pack / unpack ---------------------------------------------------- #

    def pack(self, tree) -> List[torch.Tensor]:
        """Tree -> list of bucket tensors ``[*lead, *bucket.shape]`` (the
        *wire* view: a sharded bucket is ``[*lead, F, run]``, with F = 1
        on a mesh of ranks, where a rank packs only its own shard).

        One reshape per leaf and one concat (into a new buffer) per
        bucket, then the zero pad; values are never permuted across
        learners.  A bucket of one unpadded leaf may be a view of it."""
        flat = leaves(tree)
        if len(flat) != self.n_leaves:
            raise ValueError(f"tree has {len(flat)} leaves, the layout "
                             f"{self.n_leaves}")
        idx = None if self.shards is None else self.shards.shard_index
        out: List[torch.Tensor] = []
        for b in self.buckets:
            lead = tuple(flat[b.slots[0].leaf].shape[:self.lead_axes])
            nl = len(lead)
            if b.shards > 1:
                parts = [_split_shard(flat[s.leaf], nl, s.shard_dim,
                                      b.shards) for s in b.slots]
                if idx is not None:
                    parts = [p.narrow(nl, idx, 1) for p in parts]
            else:
                parts = [flat[s.leaf].reshape(lead + (s.size,))
                         for s in b.slots]
            x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
            if b.shards > 1 or len(b.shape) == 1:
                pad = b.shape[-1] - b.size
                if pad:
                    x = torch.nn.functional.pad(x, (0, pad))
                out.append(x)
                continue
            pad = b.padded_size - b.size             # matrix view
            if pad:
                x = torch.nn.functional.pad(x, (0, pad))
            out.append(x.reshape(lead + b.shape))
        return out

    def unpack(self, buckets) -> Any:
        """Inverse of :meth:`pack` (padding stripped; wire view in, all F
        shards: see :meth:`regather`).  Each leaf is a contiguous copy of
        its slice, so no leaf keeps its bucket alive."""
        out: List[Any] = [None] * self.n_leaves
        for b, arr in zip(self.buckets, buckets):
            lead = tuple(arr.shape[:arr.dim() - len(b.shape)])
            if b.shards > 1:
                if arr.shape[len(lead)] != b.shards:
                    raise ValueError(
                        f"a sharded bucket unpacks from all {b.shards} "
                        f"shards, got {tuple(arr.shape)}: regather first")
                for s in b.slots:
                    piece = arr[..., s.offset:s.offset + s.size]
                    out[s.leaf] = _join_shard(piece, len(lead), s.shard_dim,
                                              s.shape, b.shards).contiguous()
                continue
            flat = arr.reshape(lead + (b.padded_size,))
            for s in b.slots:
                piece = flat[..., s.offset:s.offset + s.size]
                out[s.leaf] = piece.reshape(lead + s.shape).contiguous()
        return unflatten(self.treedef, out)

    def regather(self, buckets) -> List[torch.Tensor]:
        """The fsdp regather: on a mesh of ranks, each sharded bucket
        ``[*lead, 1, run]`` becomes ``[*lead, F, run]`` by one all-gather
        over the learner's fsdp group; anything else passes through."""
        if self.local_shards == (1 if self.shards is None
                                 else self.shards.size):
            return list(buckets)
        from repro_torch.parallel import collectives
        group = self.shards.mesh.process_group((self.shards.axis,))
        out = []
        for b, arr in zip(self.buckets, buckets):
            if b.shards > 1:
                nl = arr.dim() - 2
                arr = torch.movedim(collectives.all_gather(
                    torch.movedim(arr, nl, 0), group, b.shards), 0, nl)
            out.append(arr)
        return out

    # -- wire view <-> codec view (shard-aware layouts) -------------------- #
    #
    # A sharded bucket has two reshapes: the wire view [pods, G, S, F, run]
    # (what pack emits and the grouped mean consumes: the collectives never
    # mix shard coordinates) and the codec view [pods, G, S*F, run] (what
    # the wrapped reducer sees: shards act as extra learner rows, so top-k
    # selection, EF residuals and qint8 blocks are per shard, and EF state
    # lives in shard space).  Flat buckets pass through unchanged.

    def _to_codec(self, b: BucketSpec, arr):
        if b.shards == 1:
            return arr
        la = self.lead_axes
        return arr.reshape(tuple(arr.shape[:la - 1])
                           + (arr.shape[la - 1] * arr.shape[la],)
                           + tuple(arr.shape[la + 1:]))

    def _to_wire(self, b: BucketSpec, arr):
        if b.shards == 1:
            return arr
        la, f = self.lead_axes, self.local_shards
        return arr.reshape(tuple(arr.shape[:la - 1])
                           + (arr.shape[la - 1] // f, f)
                           + tuple(arr.shape[la:]))

    def codec_view(self, buckets) -> List[torch.Tensor]:
        return [self._to_codec(b, a) for b, a in zip(self.buckets, buckets)]

    def wire_view(self, buckets) -> List[torch.Tensor]:
        return [self._to_wire(b, a) for b, a in zip(self.buckets, buckets)]


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
        wrapper with ``HierAvgParams.bucket_bytes``.

        ``shards`` (a ``ShardPlan``, from an ``fsdp > 1`` mesh) makes every
        layout this wrapper builds shard-aware and takes the grouped means
        through reduce-scatter + all-gather; None keeps the replicated
        path unchanged."""
        if isinstance(inner, Bucketed):
            if shards is None:
                shards = inner.shards
            inner = inner.inner
        if bucket_bytes is not None and bucket_bytes < 0:
            raise ValueError(
                f"bucket_bytes must be >= 0, got {bucket_bytes}")
        self.inner = inner
        self.bucket_bytes = None if bucket_bytes is None \
            else int(bucket_bytes)
        self.shards = shards
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
        key = (_signature(tree, lead_axes), self.shards)
        lay = self._layouts.get(key)
        if lay is None:
            lay = BucketLayout.build(
                tree, bucket_bytes=self.effective_bucket_bytes,
                lead_axes=lead_axes,
                matrix=getattr(self.inner, "wants_matrix", False),
                uniform=self.uniform_layout, shards=self.shards)
            self._layouts[key] = lay
        return lay

    def _check_state(self, lay: BucketLayout, state, lead: Tuple[int, ...]):
        refs = getattr(state, "ref", None)
        if refs is None:
            return
        got = [tuple(r.shape) for r in leaves(refs)]
        # EF state lives in shard space: codec-view shapes
        want = [tuple(t.shape) for t in lay.codec_structs(lead)]
        if got != want:
            raise ValueError(
                "bucketed reducer state does not match the bucket layout "
                f"(state buckets {got}, layout wants {want}); build the "
                "initial state with init_state(..., plan=...) using the "
                "same plan/bucket_bytes the round was built with")

    # -- carried state --------------------------------------------------- #

    def init_state(self, params):
        # codec view: a shard-aware layout's state is per shard (shard
        # space), this process's shards only
        lay = self.layout_for(params)
        return self.inner.init_state(lay.codec_view(lay.pack(params)))

    # -- codec ----------------------------------------------------------- #

    def compress(self, tree, state):
        lay = self.layout_for(tree)
        if self.stateful:
            self._check_state(lay, state, _lead(tree, lay.lead_axes))
        return self.inner.compress(lay.codec_view(lay.pack(tree)), state)

    def decompress(self, payload, like, state):
        # the reconstruction stays in bucket space: the grouped mean that
        # follows is elementwise over the lead axes, so it averages
        # buckets exactly as it would leaves.  It is returned in the wire
        # view, so the mean never mixes shard coordinates
        lay = self.layout_for(like)
        return lay.wire_view(self.inner.decompress(
            payload, lay.codec_structs(_lead(like, lay.lead_axes)), state))

    def finalize(self, avg_tree, orig_tree, state):
        lay = self.layout_for(orig_tree)
        out, state = self.inner.finalize(
            lay.codec_view(avg_tree),
            lay.codec_structs(_lead(orig_tree, lay.lead_axes)), state)
        return lay.unpack(lay.regather(lay.wire_view(out))), state

    def reduce(self, avg_fn, tree, state, constraint_fn=None):
        """The serial schedule: compress every bucket, reconstruct,
        average, finalize.  A shard-aware layout hands the grouped mean
        its bucket shardings (the reduce-scatter + all-gather path)."""
        specs = self.layout_for(tree).bucket_shardings()
        if specs is not None:
            inner_avg = avg_fn

            def avg_fn(t, cf=None):            # noqa: F811
                return inner_avg(t, cf, specs)
        return serial_reduce(self, avg_fn, tree, state, constraint_fn)

    def state_rows(self, state, params):
        """Which leaves of this reducer's ``state`` are shard rows (codec
        view of a sharded bucket), as a tree of bools: what a checkpoint
        gathered from a mesh of ranks interleaves by shard."""
        lay = self.layout_for(params)
        n = lay.n_buckets

        def mark(node):
            if isinstance(node, list) and len(node) == n and all(
                    isinstance(x, torch.Tensor) for x in node):
                return [b.shards > 1 for b in lay.buckets]
            return tree_map(lambda _: False, node)

        if isinstance(state, tuple) and hasattr(state, "_fields"):
            return type(state)(*(mark(v) for v in state))
        return tree_map(lambda _: False, state)

    # -- accounting ------------------------------------------------------ #

    def payload_bytes(self, tree) -> int:
        lay = self.layout_for(tree, lead_axes=0)
        return self.inner.payload_bytes(lay.bucket_structs())

    def wire_payload_bytes(self, tree) -> int:
        """Bytes per *device*: a sharded bucket moves only its 1/F shard
        slice through its reduce-scatter/all-gather (the ring moves the
        same total volume as an all-reduce of the slice), so each sharded
        bucket bills at payload / F."""
        lay = self.layout_for(tree, lead_axes=0)
        total = 0
        for b, struct in zip(lay.buckets, lay.bucket_structs()):
            total += self.inner.payload_bytes([struct]) // max(1, b.shards)
        return int(total)

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
    uniform (zero-padded) layout.  In one process the mean is a tensor op,
    and on a mesh of ranks its collectives run on the default stream and
    block, so nothing overlaps yet: that needs the collective on a side
    stream (ROADMAP, perf work).

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
        with span("comm.compress"):
            payload, st2 = self.inner.compress([bucket], st)
        with span("comm.decompress"):
            xhat = self.inner.decompress(payload, [bucket], st2)
        return xhat[0], st2

    def reduce(self, avg_fn, tree, state, constraint_fn=None):
        lay = self.layout_for(tree)
        n = lay.n_buckets
        sts = (self.inner.split_bucket_states(state, n) if self.stateful
               else [() for _ in range(n)])
        if n < 2 or sts is None:
            return Bucketed.reduce(self, avg_fn, tree, state, constraint_fn)
        if self.stateful:
            self._check_state(lay, state, _lead(tree, lay.lead_axes))
        specs = lay.bucket_shardings()
        # stages and state run in the codec view (shard space); only the
        # grouped mean round-trips through the wire view
        buckets = lay.codec_view(lay.pack(tree))

        def bucket_avg(i):
            """The grouped-mean half of bucket *i*'s stage."""
            b = lay.buckets[i]
            sp = None if specs is None else [specs[i]]

            def gavg(xhat):
                wire = [lay._to_wire(b, xhat)]
                with span("comm.mean"):
                    out = avg_fn(wire, constraint_fn) if sp is None \
                        else avg_fn(wire, constraint_fn, sp)
                return lay._to_codec(b, out[0])
            return gavg

        outs: List[Any] = [None] * n
        fin: List[Any] = list(sts)
        # a run of equal (dtype, shape) buckets is one pipeline; a run of
        # one has no neighbour to overlap
        groups: Dict[Tuple[str, Tuple[int, ...], int], List[int]] = {}
        for i, b in enumerate(lay.buckets):
            groups.setdefault((b.dtype, b.shape, b.shards), []).append(i)
        for idxs in groups.values():
            gavg = bucket_avg(idxs[0])
            xh, st = self._stage(buckets[idxs[0]], sts[idxs[0]])
            for prev, i in zip(idxs, idxs[1:]):
                # stage prev's mean first, then its finalize (bucket i of
                # the same shape and dtype stands in as the template),
                # then the compress of bucket i
                avg = gavg(xh)
                with span("comm.finalize"):
                    outb, fin[prev] = self.inner.finalize(
                        [avg], [buckets[i]], st)
                outs[prev] = outb[0]
                xh, st = self._stage(buckets[i], sts[i])
            # drain: the last stage's mean and finalize
            avg = gavg(xh)
            with span("comm.finalize"):
                outb, fin[idxs[-1]] = self.inner.finalize(
                    [avg], [buckets[idxs[-1]]], st)
            outs[idxs[-1]] = outb[0]
        new_state = (self.inner.join_bucket_states(state, fin)
                     if self.stateful else state)
        return lay.unpack(lay.regather(lay.wire_view(outs))), new_state

    def _describe(self) -> str:
        # only an explicit ':pipelined' pin round-trips as one: auto
        # wrappers (engine chosen by the plan's overlap knob) describe as
        # ':bucketed', so re-parsing under another overlap re-chooses
        suffix = ":pipelined" if self.pipeline_pin else ":bucketed"
        return f"{self.inner.describe()}{suffix}"
