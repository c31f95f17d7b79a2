"""Sparse (top-k / random-k) reducers with error feedback (PyTorch port
of ``repro/comm/sparse.py``).

Each learner transmits only k coordinates of its *delta since the last
reduction* plus the accumulated error-feedback residual (Stich et al.,
arXiv:1805.09767):

    delta_j = (w_j - ref_j) + e_j            # progress + carried residual
    payload = topk(delta_j)                  # magnitude top-k
    e_j'    = delta_j - dense(payload)       # what was NOT transmitted
    xhat_j  = ref_j + dense(payload)
    out     = mean_j xhat_j ; ref <- out     # reference tracks consensus

Top-k runs ``kernels/ops.py::topk_compress_many`` (the hand-written CUDA
kernel for CUDA tensors, the plain version for CPU tensors) on
``[pods * G * S, n]`` rows in fp32: one call for each group of consecutive
leaves (or buckets, under the bucket engine, comm/bucket.py) whose deltas
fit ``TopKReducer.group_bytes``, a larger one alone.  Random-k draws one
support shared by all learners from a ``torch.Generator`` seeded from the
carried RNG state, leaf by leaf.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.comm.reducer import (N_LEARNER_AXES, Reducer,
                                      per_learner_size)
from repro_torch.kernels import ops
from repro_torch.tree import flatten, leaves, tree_map, unflatten


class EFState(NamedTuple):
    """Error-feedback carry, stacked like the params ([pods, G, S, *shape])."""
    ref: Any        # each learner's view of the last reduction result
    err: Any        # untransmitted residual, fp32
    key: Any = None  # the RNG carry (rng_carry), read by random-k and
                     # carried by top-k


_MASK64 = (1 << 64) - 1


def _carry(seed: int, fire: int, offset: int) -> torch.Tensor:
    """An RNG carry: host data the reducers read back, so a real tensor
    even under a fake mode (the dry run's trace)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        return torch.tensor([int(seed), int(fire), int(offset)],
                            dtype=torch.int64)


def rng_carry(seed: int = 0) -> torch.Tensor:
    """The port's random-k RNG state: int64 ``[seed, fires, offset]`` on
    the CPU.  ``fires`` counts the reductions so far; ``offset`` is the
    index of the state's first leaf (non-zero only for the per-bucket
    states of the pipelined schedule).  The reference carries a JAX PRNG
    key instead, which torch cannot reproduce (convert.py maps one to the
    other)."""
    return _carry(seed, 0, 0)


def _advanced(key: torch.Tensor) -> torch.Tensor:
    """The carry after one reduction: one more fire, offset 0."""
    seed, fire, _ = key.tolist()
    return _carry(seed, fire + 1, 0)


def stream_seed(seed: int, fire: int, index: int) -> int:
    """A 63-bit generator seed for leaf (or bucket) ``index`` of reduction
    ``fire`` (splitmix64 of the three)."""
    z = (seed * 0x9E3779B97F4A7C15 + fire * 0xBF58476D1CE4E5B9
         + index * 0x94D049BB133111EB + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def _rows(leaf) -> int:
    r = 1
    for d in leaf.shape[:N_LEARNER_AXES]:
        r *= d
    return r


def _scatter_rows(vals: torch.Tensor, idx: torch.Tensor,
                  n: int) -> torch.Tensor:
    """Dense [rows, n] fp32 from per-row (vals, idx) — the decompress
    scatter (indices within a row are distinct)."""
    out = torch.zeros((vals.shape[0], n), dtype=torch.float32,
                      device=vals.device)
    return out.scatter_(1, idx.long(), vals.float())


def delta_groups(nbytes, budget: int):
    """Consecutive leaves of these fp32 delta sizes (bytes) in groups of at
    most ``budget`` bytes, a larger leaf alone: lists of leaf indices."""
    groups, held = [], 0
    for i, b in enumerate(nbytes):
        if groups and held + b <= budget:
            groups[-1].append(i)
            held += b
        else:
            groups.append([i])
            held = b
    return groups


class _SparseEFReducer(Reducer):
    """Shared machinery of top-k / random-k; subclasses pick the support."""

    stateful = True
    has_codec = True
    # bucketed by default: k-of-the-bucket approximates the global
    # k-of-the-model selection the EF analyses assume (comm/bucket.py)
    bucket_by_default = True

    def __init__(self, ratio: float = 0.1, impl: str = "auto"):
        if not 0.0 < ratio <= 1.0:
            raise ValueError(
                f"{self.name} ratio must be in (0, 1], got {ratio}")
        if impl not in ops.IMPLS:
            raise ValueError(f"impl {impl!r} not in {ops.IMPLS}")
        self.ratio = float(ratio)
        self.impl = impl

    def k_for(self, n: int) -> int:
        # Python's round: half to even, as the reference
        return max(1, min(n, int(round(self.ratio * n))))

    def init_state(self, params) -> EFState:
        err = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                             device=x.device), params)
        # ref gets its OWN buffers: an alias of the params would change
        # with every in-place write to them
        ref = tree_map(torch.clone, params)
        return EFState(ref=ref, err=err, key=rng_carry())

    # -- pipelined bucket schedule (comm/bucket.py Pipelined) ------------ #
    # Once bucketed, ref/err are lists of bucket tensors, one pair per
    # bucket.  Bucket i's state carries offset i, so random-k draws from
    # the stream a serial reduction gives bucket i: pipelined == serial
    # bit for bit for both codecs (the reference's pipelined random-k
    # draws from another stream than its serial one).

    def split_bucket_states(self, state: EFState, n: int):
        refs, errs = leaves(state.ref), leaves(state.err)
        if len(refs) != n or len(errs) != n:
            return None                      # not bucket-aligned state
        seed, fire, _ = state.key.tolist()
        return [EFState(ref=[refs[i]], err=[errs[i]],
                        key=_carry(seed, fire, i))
                for i in range(n)]

    def join_bucket_states(self, state: EFState, per_bucket):
        return EFState(ref=[s.ref[0] for s in per_bucket],
                       err=[s.err[0] for s in per_bucket],
                       key=_advanced(state.key))

    # bytes of fp32 deltas selected in one call: consecutive leaves are
    # grouped up to it, a larger leaf goes alone (0: one leaf a call)
    group_bytes = 0

    def _select(self, delta2d: torch.Tensor, k: int, stream: int):
        raise NotImplementedError

    def _select_many(self, deltas, ks, streams):
        return [self._select(d, k, s) for d, k, s in zip(deltas, ks, streams)]

    def compress(self, tree, state: EFState):
        seed, fire, offset = state.key.tolist()
        flat, treedef = flatten(tree)
        refs = leaves(state.ref)
        errs = leaves(state.err)
        payload, new_errs = [], []
        for group in delta_groups([4 * x.numel() for x in flat],
                                  self.group_bytes):
            deltas = []
            for i in group:
                x, r, e = flat[i], refs[i], errs[i]
                rows, n = _rows(x), per_learner_size(x)
                deltas.append((x.float() - r.float()).reshape(rows, n)
                              + e.reshape(rows, n))
            sel = self._select_many(
                deltas, [self.k_for(d.shape[1]) for d in deltas],
                [stream_seed(seed, fire, offset + i) for i in group])
            for j, (i, (vals, idx)) in enumerate(zip(group, sel)):
                delta, deltas[j] = deltas[j], None    # freed once used
                new_errs.append((delta - _scatter_rows(
                    vals, idx, delta.shape[1])).reshape(errs[i].shape))
                payload.append((vals, idx))
        return payload, EFState(state.ref, unflatten(treedef, new_errs),
                                _advanced(state.key))

    def decompress(self, payload, like, state: EFState):
        flat, treedef = flatten(like)
        refs = leaves(state.ref)
        xhat = []
        for (vals, idx), x, r in zip(payload, flat, refs):
            dense = _scatter_rows(vals, idx, per_learner_size(x))
            xhat.append(r.float() + dense.reshape(x.shape))
        return unflatten(treedef, xhat)

    def finalize(self, avg_tree, orig_tree, state: EFState):
        out = tree_map(lambda a, o: a.to(o.dtype), avg_tree, orig_tree)
        # the averaged result is every learner's next reference; copied so
        # the round's output params and ref never share a buffer
        ref = tree_map(torch.clone, out)
        return out, state._replace(ref=ref)

    def payload_bytes(self, tree) -> int:
        # fp32 value + int32 index per transmitted coordinate
        return int(sum(self.k_for(leaf.numel()) * 8
                       for leaf in leaves(tree)))

    def _describe(self) -> str:
        return f"{self.name}:{self.ratio:g}"


class TopKReducer(_SparseEFReducer):
    """Per-leaf (or per-bucket) magnitude top-k of the EF-corrected
    delta."""

    name = "topk"
    # 1 GiB: a ResNet-18 fire at 16 learners (715 MB) in one call, each
    # 2.15 GB embedding of rwkv6-1.6b at 4 learners alone
    group_bytes = 1 << 30

    def _select_many(self, deltas, ks, streams):
        return ops.topk_compress_many(deltas, ks, impl=self.impl)


class RandKReducer(_SparseEFReducer):
    """Random-k with a shared support: all learners transmit the same k
    coordinates each fire (drawn fresh from the carried RNG state), so the
    grouped mean of the sparse payloads is itself k-sparse.  Unselected
    coordinates ride the EF residual into a later fire."""

    name = "randk"

    def support(self, n: int, k: int, stream: int,
                device) -> torch.Tensor:
        """k distinct indices of [0, n), ascending, int32: the first k of
        a permutation drawn from a generator seeded with ``stream``."""
        g = torch.Generator(device=device).manual_seed(stream)
        idx = torch.randperm(n, generator=g, device=device)[:k]
        return torch.sort(idx).values.to(torch.int32)

    def _select(self, delta2d, k, stream):
        idx = self.support(delta2d.shape[1], k, stream, delta2d.device)
        idx2d = idx[None, :].expand(delta2d.shape[0], k)
        return torch.gather(delta2d, 1, idx2d.long()), idx2d
