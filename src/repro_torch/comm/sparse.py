"""Top-k reducer with error feedback (PyTorch port of the top-k half of
``repro/comm/sparse.py``; random-k arrives with the other codecs, ROADMAP
Queue 1 item 2).

Each learner transmits only k coordinates of its *delta since the last
reduction* plus the accumulated error-feedback residual (Stich et al.,
arXiv:1805.09767):

    delta_j = (w_j - ref_j) + e_j            # progress + carried residual
    payload = topk(delta_j)                  # magnitude top-k
    e_j'    = delta_j - dense(payload)       # what was NOT transmitted
    xhat_j  = ref_j + dense(payload)
    out     = mean_j xhat_j ; ref <- out     # reference tracks consensus

The per-leaf selection runs ``kernels/ops.py::topk_compress`` — the
hand-written CUDA kernel for CUDA tensors, the plain version for CPU
tensors — once per leaf, on ``[pods * G * S, per-learner size]`` rows in
fp32.
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
    key: Any = None  # the reference's PRNG key, read only by random-k;
                     # a placeholder until random-k is ported


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


class _SparseEFReducer(Reducer):
    """Shared machinery of the error-feedback sparse reducers."""

    stateful = True
    # the reference packs these into flat buckets by default
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
        return EFState(ref=ref, err=err, key=None)

    def _select(self, delta2d: torch.Tensor, k: int):
        raise NotImplementedError

    def compress(self, tree, state: EFState):
        flat, treedef = flatten(tree)
        refs = leaves(state.ref)
        errs = leaves(state.err)
        payload, new_errs = [], []
        for x, r, e in zip(flat, refs, errs):
            rows, n = _rows(x), per_learner_size(x)
            delta = (x.float() - r.float()).reshape(rows, n) \
                + e.reshape(rows, n)
            vals, idx = self._select(delta, self.k_for(n))
            new_errs.append(
                (delta - _scatter_rows(vals, idx, n)).reshape(e.shape))
            payload.append((vals, idx))
        return payload, EFState(state.ref, unflatten(treedef, new_errs),
                                state.key)

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
    """Per-leaf magnitude top-k of the EF-corrected delta."""

    name = "topk"

    def _select(self, delta2d, k):
        return ops.topk_compress(delta2d, k, impl=self.impl)
