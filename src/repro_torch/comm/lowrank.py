"""PowerSGD-style low-rank reducer with error feedback and warm-started Q
(PyTorch port of ``repro/comm/lowrank.py``).

Vogels et al. (arXiv:1905.13727): compress each parameter matrix M [a, b]
to a rank-r factorization by one step of subspace iteration, warm-started
from the previous fire's right factor Q:

    P  = M Q                 # [a, r] left factor
    P^ = orthonormalize(P)   # batched QR: kernels/ops.py::batched_qr_many
    Q' = M^T P^              # [b, r] right factor (next fire's warm start)
    M^ = P^ Q'^T             # the rank-r approximation on the wire

Per learner the payload is (a + b) * r fp32 words instead of a * b.  Like
the sparse reducers, compression acts on the delta since the last
reduction plus the error-feedback residual, and the grouped mean runs
over each learner's reconstruction ``ref + P^ Q'^T``.  The three products
are plain large products (``torch.matmul``/``einsum``), as the reference
leaves them to XLA; the orthonormalization is the hand-written CGS2 kernel
``kernels/csrc/batched_qr.cu`` for CUDA tensors, one grouped call a fire
for every compressible leaf (or for the one bucket of a ``Pipelined``
stage).

Leaves whose per-learner shape is not a matrix with min(a, b) > r (biases,
norm gains) are transmitted dense, the paper's "rank-1 tensors
uncompressed" rule.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.comm.reducer import N_LEARNER_AXES, Reducer, learner_shape
from repro_torch.comm.sparse import stream_seed
from repro_torch.kernels import ops
from repro_torch.tree import flatten, flatten_up_to, leaves, tree_map, unflatten


class LowRankState(NamedTuple):
    """PowerSGD carry, stacked like the params ([pods, G, S, ...])."""
    ref: Any        # each learner's view of the last reduction result
    err: Any        # untransmitted residual, fp32
    q: Any          # per-leaf warm-start Q [pods, G, S, b, r]; () if dense


def _rows(leaf) -> int:
    r = 1
    for d in leaf.shape[:N_LEARNER_AXES]:
        r *= d
    return r


def _matrix_dims(shape) -> tuple:
    """Per-learner shape -> (a, b) matrix view: leading dim x the rest."""
    a = shape[0]
    b = 1
    for d in shape[1:]:
        b *= d
    return a, b


class PowerSGDReducer(Reducer):
    """Rank-r payload (``powersgd:<rank>``) with EF and warm-started Q."""

    name = "powersgd"
    stateful = True
    has_codec = True
    # NOT bucketed by default: the low-rank codec exploits each weight
    # matrix's own row/column structure, which flat packing destroys.
    # "powersgd:<r>:bucketed" still works: wants_matrix makes the layout
    # pack near-square [a, b] buckets the codec can factorize.
    bucket_by_default = False
    wants_matrix = True

    def __init__(self, rank: int = 2, impl: str = "auto"):
        if rank < 1:
            raise ValueError(f"powersgd rank must be >= 1, got {rank}")
        if impl not in ops.IMPLS:
            raise ValueError(f"impl {impl!r} not in {ops.IMPLS}")
        self.rank = int(rank)
        self.impl = impl

    def _compressible(self, leaf) -> bool:
        s = learner_shape(leaf)
        if len(s) < 2:
            return False
        a, b = _matrix_dims(s)
        return min(a, b) > self.rank

    def init_state(self, params) -> LowRankState:
        err = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                             device=x.device), params)
        flat, treedef = flatten(params)
        qs = []
        for i, leaf in enumerate(flat):
            if self._compressible(leaf):
                _, b = _matrix_dims(learner_shape(leaf))
                # leaf i's initial Q comes from a generator seeded with
                # stream_seed(0, 0, i).  The reference draws it with
                # jax.random.normal(fold_in(PRNGKey(0), i)), which torch
                # cannot reproduce: a converted TrainState carries its Q.
                g = torch.Generator(device=leaf.device).manual_seed(
                    stream_seed(0, 0, i))
                qs.append(torch.randn(
                    tuple(leaf.shape[:N_LEARNER_AXES]) + (b, self.rank),
                    generator=g, dtype=torch.float32, device=leaf.device))
            else:
                qs.append(())
        # ref gets its own buffers (an alias of the params would change
        # with every in-place write to them)
        return LowRankState(ref=tree_map(torch.clone, params), err=err,
                            q=unflatten(treedef, qs))

    def compress(self, tree, state: LowRankState):
        """Every compressible leaf's ``P = M Q`` first, then one grouped
        QR call for all of them (``ops.batched_qr_many``), then ``Q'``,
        the approximation and the residual.  Only the panels live across
        the call: each leaf's delta is formed again after it, which gives
        the same bits."""
        flat, treedef = flatten(tree)
        refs = leaves(state.ref)
        errs = leaves(state.err)
        qs = flatten_up_to(treedef, state.q)

        def delta(i):
            return (flat[i].float() - refs[i].float()) + errs[i]

        def matrix(i):
            a, b = _matrix_dims(learner_shape(flat[i]))
            return delta(i).reshape(_rows(flat[i]), a, b)

        def factors(i, p_hat):
            # a leaf's temporaries (its delta and approximation) die here,
            # before the next leaf's are formed
            m = matrix(i)
            q_new = torch.einsum("nab,nar->nbr", m, p_hat)
            err = m - torch.einsum("nar,nbr->nab", p_hat, q_new)
            return q_new, err.reshape(errs[i].shape)

        low = [i for i, x in enumerate(flat) if self._compressible(x)]
        panels = [torch.matmul(matrix(i), qs[i].reshape(
            _rows(flat[i]), -1, self.rank)) for i in low]
        p_hats = dict(zip(low, ops.batched_qr_many(panels, impl=self.impl)))
        del panels
        payload, new_errs, new_qs = [], [], []
        for i, (e, q) in enumerate(zip(errs, qs)):
            if i not in p_hats:
                payload.append(delta(i))       # dense fallback on the wire
                new_errs.append(torch.zeros_like(e))
                new_qs.append(q)
                continue
            p_hat = p_hats.pop(i)
            q_new, err = factors(i, p_hat)
            payload.append((p_hat, q_new))
            new_errs.append(err)
            new_qs.append(q_new.reshape(q.shape))
        return payload, LowRankState(state.ref, unflatten(treedef, new_errs),
                                     unflatten(treedef, new_qs))

    def decompress(self, payload, like, state: LowRankState):
        flat, treedef = flatten(like)
        refs = leaves(state.ref)
        xhat = []
        for pl, x, r in zip(payload, flat, refs):
            if isinstance(pl, tuple):
                p_hat, q_new = pl
                approx = torch.einsum("nar,nbr->nab", p_hat, q_new)
                xhat.append(r.float() + approx.reshape(x.shape))
            else:
                xhat.append(r.float() + pl)
        return unflatten(treedef, xhat)

    def finalize(self, avg_tree, orig_tree, state: LowRankState):
        out = tree_map(lambda a, o: a.to(o.dtype), avg_tree, orig_tree)
        # the next reference, copied so the output params and ref never
        # share a buffer
        return out, state._replace(ref=tree_map(torch.clone, out))

    # -- pipelined bucket schedule (comm/bucket.py Pipelined) ------------ #

    def split_bucket_states(self, state: LowRankState, n: int):
        """Per-bucket states: in the bucket engine ``init_state`` saw the
        list of packed buckets, so ref/err/q are parallel lists (q is
        ``()`` for a non-compressible bucket).  Anything else (per-leaf
        state) returns None: the serial schedule."""
        refs, errs, qs = state.ref, state.err, state.q
        if not (isinstance(refs, list) and isinstance(errs, list)
                and isinstance(qs, list) and len(refs) == n
                and len(errs) == n and len(qs) == n):
            return None
        return [LowRankState(ref=[refs[i]], err=[errs[i]], q=[qs[i]])
                for i in range(n)]

    def join_bucket_states(self, state: LowRankState,
                           per_bucket) -> LowRankState:
        return LowRankState(ref=[s.ref[0] for s in per_bucket],
                            err=[s.err[0] for s in per_bucket],
                            q=[s.q[0] for s in per_bucket])

    # -- accounting ------------------------------------------------------ #

    def _compressible_template(self, leaf) -> bool:
        s = tuple(leaf.shape)
        return len(s) >= 2 and min(_matrix_dims(s)) > self.rank

    def n_messages(self, tree) -> int:
        """Two collectives per compressible leaf (the P^ and Q' factors),
        one for each dense-fallback leaf."""
        return int(sum(2 if self._compressible_template(leaf) else 1
                       for leaf in leaves(tree)))

    def payload_bytes(self, tree) -> int:
        total = 0
        for leaf in leaves(tree):
            if self._compressible_template(leaf):
                a, b = _matrix_dims(tuple(leaf.shape))
                total += (a + b) * self.rank * 4
            else:
                total += leaf.numel() * 4     # fp32 dense fallback
        return int(total)

    def _describe(self) -> str:
        return f"powersgd:{self.rank}"
