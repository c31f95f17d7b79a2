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

from repro_torch.tree import leaves, tree_map

N_LEARNER_AXES = 3   # [pods, G, S] — the stacked-learner leading axes

# The bucket engine's default cap (``HierAvgParams.bucket_bytes``).  The
# reference defines it in repro/comm/bucket.py; the port has no bucket
# engine yet (ROADMAP Queue 1 item 3), so its one definition lives here.
DEFAULT_BUCKET_BYTES = 4 << 20

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
    # -- bucketing hints (read by core/plan.py apply_bucketing) ---------- #
    # would the reference pack this reducer into flat buckets when the
    # plan's bucket_bytes knob is on?  True for coordinate-wise codecs
    # (cast / topk); the port has no bucket engine yet, so plan
    # resolution refuses such a level instead (ROADMAP Queue 1 item 3)
    bucket_by_default = False
    # instance-level opt-out set by the ":perleaf" spec modifier
    bucket_opt_out = False
    # instance-level schedule pin set by the ":serial" spec modifier
    overlap_opt_out = False

    # -- carried state -------------------------------------------------- #
    def init_state(self, params) -> Any:
        return ()

    # -- codec ---------------------------------------------------------- #
    def compress(self, tree, state) -> Tuple[Any, Any]:
        return tree, state

    def decompress(self, payload, like, state):
        """Reconstruct each learner's approximation.  ``like`` is the
        original tree, used only as a shape/dtype template."""
        return payload

    def finalize(self, avg_tree, orig_tree, state) -> Tuple[Any, Any]:
        """Post-reduction hook: restore dtypes / update EF references
        (from ``avg_tree``; ``orig_tree`` is only a shape/dtype template)."""
        return avg_tree, state

    # -- accounting ----------------------------------------------------- #
    def payload_bytes(self, tree) -> int:
        """Wire bytes one learner transmits per reduction (single-learner
        tree)."""
        return int(sum(leaf.numel() * leaf.element_size()
                       for leaf in leaves(tree)))

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
    average, finalize — every stage completes before the next starts."""
    payload, state = reducer.compress(tree, state)
    xhat = reducer.decompress(payload, tree, state)
    out = avg_fn(xhat, constraint_fn)
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
