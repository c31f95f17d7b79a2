"""Pluggable compressed reducers for Hier-AVG's local/global reductions
(PyTorch port of ``repro/comm/reducer.py``).

A :class:`Reducer` defines what each learner puts on the wire:

    payload, state = reducer.compress(tree, state)     # per-learner payload
    xhat = reducer.decompress(payload, tree, state)    # learner approximation
    out = avg_fn(xhat, constraint_fn)                  # grouped mean
    out, state = reducer.finalize(out, tree, state)    # dtype/EF bookkeeping

so the reduction becomes ``mean_j xhat_j`` over each learner's
reconstruction.  As in the reference, ``payload_bytes`` models what a
payload-aware collective would transmit; the numerics are exact.

Layout contract: every leaf carries the stacked-learner axes
[pods, G, S, *shape] (core/topology.py); reducers compress each learner's
trailing ``*shape`` dims independently.  ``payload_bytes`` expects a
*single-learner* tree (no learner axes).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.telemetry.spans import span
from repro_torch.tree import leaves, tree_map

N_LEARNER_AXES = 3   # [pods, G, S] — the stacked-learner leading axes

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32, "float8_e4m3fn": torch.float8_e4m3fn,
           "float8_e5m2": torch.float8_e5m2}


def learner_shape(leaf) -> Tuple[int, ...]:
    """Per-learner trailing shape of a stacked leaf."""
    return tuple(leaf.shape[N_LEARNER_AXES:])


def per_learner_size(leaf) -> int:
    n = 1
    for d in learner_shape(leaf):
        n *= d
    return n


class Reducer:
    """Base reducer == the dense full-precision mean (identity codec).

    Subclasses override ``compress``/``decompress`` (and ``finalize`` for
    dtype restoration or error-feedback reference updates).  Stateless
    reducers keep ``init_state`` returning ``()``.
    """

    name = "mean"
    stateful = False
    # -- bucketing hints (comm/bucket.py, core/plan.py apply_bucketing) -- #
    # wrap this reducer in the bucket engine automatically when the plan's
    # bucket_bytes knob is on?  True for coordinate-wise codecs (cast /
    # topk / randk / qint8); False for the dense mean and for PowerSGD,
    # which opt in with the ":bucketed" spec modifier
    bucket_by_default = False
    # instance-level opt-out set by the ":perleaf" spec modifier
    bucket_opt_out = False
    # instance-level schedule pin set by the ":serial" spec modifier
    overlap_opt_out = False
    # does compress/decompress do per-element work?  False for the mean
    has_codec = False
    # pack buckets as near-square matrices instead of flat vectors (what a
    # low-rank codec needs to act on a bucket at all)
    wants_matrix = False

    @property
    def codec_name(self) -> str:
        """Codec family label: the spec name for codec reducers, "" for
        the identity mean."""
        return self.name if self.has_codec else ""

    # -- carried state -------------------------------------------------- #
    def init_state(self, params) -> Any:
        return ()

    def split_bucket_states(self, state, n: int):
        """Per-bucket views of the carried state, for the pipelined bucket
        schedule (comm/bucket.py Pipelined): entry ``i`` is the state
        ``compress``/``decompress`` need when handed bucket ``i`` alone.
        ``None`` means the state cannot be split (per-leaf state handed to
        the bucket engine) and the engine falls back to the serial
        schedule.  Stateful reducers with per-bucket state override this
        together with :meth:`join_bucket_states`."""
        if self.stateful:
            return None
        return [() for _ in range(n)]

    def join_bucket_states(self, state, per_bucket):
        """Inverse of :meth:`split_bucket_states`."""
        return state

    # -- codec ---------------------------------------------------------- #
    def compress(self, tree, state) -> Tuple[Any, Any]:
        return tree, state

    def decompress(self, payload, like, state):
        """Reconstruct each learner's approximation.  ``like`` is the
        original tree, used only as a shape/dtype template."""
        return payload

    def finalize(self, avg_tree, orig_tree, state) -> Tuple[Any, Any]:
        """Post-reduction hook: restore dtypes / update EF references.

        Contract: ``orig_tree`` is only a shape/dtype template (EF
        references update from ``avg_tree``).  The bucket engine relies on
        it: it hands ``finalize`` (and ``decompress``) meta-device
        templates, and the pipelined schedule finalizes a carried stage
        with the next bucket, of the same shape, as the template."""
        return avg_tree, state

    # -- accounting ----------------------------------------------------- #
    def payload_bytes(self, tree) -> int:
        """Wire bytes one learner transmits per reduction (single-learner
        tree)."""
        return int(sum(leaf.numel() * leaf.element_size()
                       for leaf in leaves(tree)))

    def wire_payload_bytes(self, tree) -> int:
        """Bytes one *device* puts on the wire per reduction: equal to
        :meth:`payload_bytes` on the replicated (fsdp=1) path; the
        shard-aware bucket engine (comm/bucket.py) overrides it to bill
        the reduce-scatter/all-gather path, where each device moves only
        its 1/F shard slice of every sharded bucket."""
        return self.payload_bytes(tree)

    def n_messages(self, tree) -> int:
        """Grouped collectives one reduction dispatches (single-learner
        tree): one per leaf; the bucket engine bills one per bucket."""
        return len(leaves(tree))

    def describe(self) -> str:
        """Spec string this reducer round-trips through ``get_reducer``."""
        out = self._describe()
        if self.bucket_opt_out:
            out += ":perleaf"
        if self.overlap_opt_out:
            out += ":serial"
        return out

    def _describe(self) -> str:
        return self.name

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.describe()})"


MeanReducer = Reducer


class CastReducer(Reducer):
    """Narrow-dtype payload (bf16/fp16/fp8): the mean runs in the payload
    dtype for >=16-bit payloads and in bf16 for fp8; master params keep
    their dtype."""

    name = "cast"
    bucket_by_default = True
    has_codec = True

    def __init__(self, dtype="bfloat16"):
        if isinstance(dtype, str):
            if dtype not in _DTYPES:
                raise ValueError(f"cast dtype {dtype!r} not in "
                                 f"{sorted(_DTYPES)}")
            dtype = _DTYPES[dtype]
        self.payload_dtype = dtype
        self.acc_dtype = (dtype if dtype.itemsize >= 2 else torch.bfloat16)

    def compress(self, tree, state):
        return tree_map(lambda x: x.to(self.payload_dtype), tree), state

    def decompress(self, payload, like, state):
        if self.acc_dtype == self.payload_dtype:
            return payload
        return tree_map(lambda x: x.to(self.acc_dtype), payload)

    def finalize(self, avg_tree, orig_tree, state):
        return tree_map(lambda a, o: a.to(o.dtype), avg_tree,
                        orig_tree), state

    def payload_bytes(self, tree) -> int:
        return int(sum(leaf.numel() * self.payload_dtype.itemsize
                       for leaf in leaves(tree)))

    def _describe(self) -> str:
        # the dtype's name as numpy and JAX spell it ("bfloat16")
        return f"cast:{str(self.payload_dtype).replace('torch.', '')}"


def serial_reduce(reducer: Reducer, avg_fn: Callable, tree, state,
                  constraint_fn: Optional[Callable] = None):
    """The serial composition: compress the whole tree, reconstruct,
    average, finalize — every stage completes before the next starts, in
    a span of its own (``comm.<stage>``, telemetry/spans.py)."""
    with span("comm.compress"):
        payload, state = reducer.compress(tree, state)
    with span("comm.decompress"):
        xhat = reducer.decompress(payload, tree, state)
    with span("comm.mean"):
        out = avg_fn(xhat, constraint_fn)
    with span("comm.finalize"):
        return reducer.finalize(out, tree, state)


def reduce_with(reducer: Reducer, avg_fn: Callable, tree, state,
                constraint_fn: Optional[Callable] = None):
    """Run one compressed reduction: compress -> decompress -> average ->
    finalize, or the reducer's own ``reduce`` where it defines one.
    ``avg_fn(tree, constraint_fn)`` is one of the grouped means of
    core/topology.py.  Returns ``(averaged_tree, new_reducer_state)``."""
    own = getattr(reducer, "reduce", None)
    if own is not None:
        return own(avg_fn, tree, state, constraint_fn)
    return serial_reduce(reducer, avg_fn, tree, state, constraint_fn)
