"""Plain Hier-AVG (Zhou and Cong's Algorithm 1, generalised to a list of
levels) over P learners, in plain PyTorch.

A plan is "name@period[:codec[:arg]]" entries joined by "/", innermost
first.  A round takes the outermost period's SGD steps; after step t
(counted from 1) every level whose period divides t averages, innermost
first, and the first level whose period does not divide t ends the walk.
Learners are numbered row-major over (pods, groups, local); the level
"local" averages each group's learners, "pod" each pod's, "global" all.

Codecs, each learner's contribution to its level's mean:

  mean     its parameters
  qint8    its parameters quantised in blocks of ``block`` (256): scale =
           max(absmax / 127, 1e-12), q = clamp(round(x / scale), -127, 127)
           half to even, contributed as q * scale
  topk:r   Stich et al.'s sparsification with error feedback: delta =
           (x - ref) + err; the k = round(r * n) entries of delta largest
           in magnitude are sent; err <- delta - sent; the learner
           contributes ref + sent; afterwards ref <- the level's mean.
           ref starts at the learners' parameters, err at zero or at
           the residual carried in from earlier fires

Bucketing (``bucket_bytes`` > 0) runs the qint8 and top-k codecs on flat
buckets instead of leaves: leaves in order are packed into runs of at
most ``bucket_bytes`` (a larger leaf alone), and with ``uniform`` every
run of a layout of several buckets is zero-padded to the longest.  The
quantisation blocks and the top-k's n are then the padded bucket's, and
the error feedback lives in bucket space.  The plain mean is never
bucketed.  Nothing here imports the system under test.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

QINT8_BLOCK = 256
QINT8_FLOOR = 1e-12


@dataclass(frozen=True)
class Level:
    name: str
    period: int
    codec: str
    arg: Optional[float]


def parse_plan(spec: str) -> List[Level]:
    out = []
    for part in spec.split("/"):
        name, _, rest = part.strip().partition("@")
        period, _, codec = rest.partition(":")
        codec, _, arg = (codec or "mean").partition(":")
        out.append(Level(name, int(period), codec,
                         float(arg) if arg else None))
    return out


def groups_of(level: str, topo: Tuple[int, int, int]) -> int:
    """Learners per group of a level, learners numbered row-major."""
    pods, g, s = topo
    return {"local": s, "pod": g * s, "global": pods * g * s}[level]


def group_mean(x: torch.Tensor, size: int) -> torch.Tensor:
    """[L, ...] -> each learner's group mean, groups of ``size``
    consecutive learners."""
    lead = x.shape[0]
    y = x.reshape((lead // size, size) + tuple(x.shape[1:])).mean(dim=1)
    return y.repeat_interleave(size, dim=0)


def bucket_runs(sizes: List[int], bucket_bytes: int,
                uniform: bool) -> List[Tuple[List[int], int]]:
    """Leaf indices per bucket, and each bucket's padded length (fp32)."""
    cap = bucket_bytes // 4
    buckets, cur, filled = [], [], 0
    for i, n in enumerate(sizes):
        if cur and filled + n > cap:
            buckets.append((cur, filled))
            cur, filled = [], 0
        cur.append(i)
        filled += n
    if cur:
        buckets.append((cur, filled))
    if uniform and len(buckets) > 1:
        longest = max(n for _, n in buckets)
        buckets = [(b, longest) for b, _ in buckets]
    return buckets


def qint8_roundtrip(x: torch.Tensor, block: int = QINT8_BLOCK
                    ) -> torch.Tensor:
    """[L, n] -> its quantised values, per row and block."""
    rows, n = x.shape
    nb = -(-n // block)
    xb = torch.nn.functional.pad(x, (0, nb * block - n)).reshape(
        rows, nb, block)
    scale = torch.clamp(xb.abs().amax(-1, keepdim=True) / 127.0,
                        min=QINT8_FLOOR)
    q = torch.clamp(torch.round(xb / scale), -127, 127)
    return (q * scale).reshape(rows, nb * block)[:, :n]


def topk_sparse(delta: torch.Tensor, ratio: float) -> torch.Tensor:
    """[L, n] -> the same with all but each row's k largest-magnitude
    entries zeroed, k = round(ratio * n) (half to even), 1 <= k <= n."""
    n = delta.shape[1]
    k = max(1, min(n, int(round(ratio * n))))
    idx = torch.topk(delta.abs(), k, dim=1).indices
    return torch.zeros_like(delta).scatter_(1, idx, delta.gather(1, idx))


class PlainHierAvg:
    """The round, learner by learner in the codecs, with the model's
    ``learner_grads(params, batch) -> (grads, losses)`` for the step.
    Parameters are {path: [L, *shape]} in fp32, in the benchmark's leaf
    order."""

    def __init__(self, grads_fn: Callable, plan: str,
                 topo: Tuple[int, int, int], lr: float,
                 bucket_bytes: int, uniform: bool):
        self.grads_fn = grads_fn
        self.levels = parse_plan(plan)
        self.topo = tuple(topo)
        self.n = math.prod(self.topo)
        self.lr = lr
        self.bucket_bytes = bucket_bytes
        self.uniform = uniform
        self.steps = self.levels[-1].period
        # each leaf's norm over all learners of the first step's gradient
        self.first_grad_norms: Optional[Dict[str, float]] = None

    # -- state ------------------------------------------------------------ #

    def init(self, w0: Dict[str, torch.Tensor],
             residual: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Every learner starts from ``w0``, each top-k level's reference
        at ``w0`` and its residual at ``residual`` ({path: [L, *shape]},
        in leaf space) or zero."""
        self.names = list(w0)
        self.params = {k: v.float()[None].expand((self.n,) + v.shape)
                       .clone() for k, v in w0.items()}
        self.ef, self.ef_start = {}, {}
        for lvl in self.levels:
            if lvl.codec == "topk":
                ref = self._units(self.params, lvl)
                err = ([e.clone() for e in self._units(residual, lvl)]
                       if residual is not None
                       else [torch.zeros_like(r) for r in ref])
                self.ef[lvl.name] = ([r.clone() for r in ref], err)
                self.ef_start[lvl.name] = ref

    def _bucketed(self, lvl: Level) -> bool:
        return self.bucket_bytes > 0 and lvl.codec in ("topk", "qint8")

    def _layout(self):
        sizes = [self.params[k][0].numel() for k in self.names]
        return bucket_runs(sizes, self.bucket_bytes, self.uniform)

    def _units(self, params, lvl: Level) -> List[torch.Tensor]:
        """The level's codec units: each leaf as [L, n], or the buckets."""
        flat = [params[k].reshape(self.n, -1) for k in self.names]
        if not self._bucketed(lvl):
            return flat
        out = []
        for idx, padded in self._layout():
            run = torch.cat([flat[i] for i in idx], dim=1)
            out.append(torch.nn.functional.pad(run, (0, padded
                                                     - run.shape[1])))
        return out

    def _from_units(self, units, lvl: Level) -> Dict[str, torch.Tensor]:
        shapes = [self.params[k].shape for k in self.names]
        if not self._bucketed(lvl):
            return {k: u.reshape(s) for k, u, s in
                    zip(self.names, units, shapes)}
        out = {}
        for (idx, _), u in zip(self._layout(), units):
            at = 0
            for i in idx:
                n = shapes[i][1:].numel()
                out[self.names[i]] = u[:, at:at + n].reshape(shapes[i])
                at += n
        return out

    # -- one level's reduction -------------------------------------------- #

    def reduce(self, lvl: Level) -> None:
        size = groups_of(lvl.name, self.topo)
        units = self._units(self.params, lvl)
        if lvl.codec == "mean":
            new = [group_mean(u, size) for u in units]
        elif lvl.codec == "qint8":
            block = int(lvl.arg) if lvl.arg else QINT8_BLOCK
            new = [group_mean(qint8_roundtrip(u, block), size)
                   for u in units]
        elif lvl.codec == "topk":
            refs, errs = self.ef[lvl.name]
            new, new_errs = [], []
            for u, r, e in zip(units, refs, errs):
                delta = (u - r) + e
                sent = topk_sparse(delta, lvl.arg)
                new_errs.append(delta - sent)
                new.append(group_mean(r + sent, size))
            self.ef[lvl.name] = ([x.clone() for x in new], new_errs)
        else:
            raise ValueError(f"codec {lvl.codec!r} has no plain version")
        self.params = self._from_units(new, lvl)

    def ef_norms(self) -> Dict[str, float]:
        """Each error-feedback unit's residual norm over all learners,
        keyed "<level>/<unit>"."""
        return {f"{name}/{i}": float(torch.linalg.vector_norm(e.double()))
                for name, (_, errs) in self.ef.items()
                for i, e in enumerate(errs)}

    def ref_norms(self) -> Dict[str, float]:
        """Each error-feedback unit's norm of its reference's change since
        :meth:`init`, over all learners, keyed as :meth:`ef_norms`."""
        return {f"{name}/{i}": float(torch.linalg.vector_norm(
                    (r - r0).double()))
                for name, (refs, _) in self.ef.items()
                for i, (r, r0) in enumerate(zip(refs, self.ef_start[name]))}

    # -- the round -------------------------------------------------------- #

    def round(self, steps_batch: List[Dict[str, torch.Tensor]]
              ) -> torch.Tensor:
        """One round on its steps' batches (leaves [L, B, ...] each);
        returns the mean loss over the steps and learners."""
        if len(steps_batch) != self.steps:
            raise ValueError(f"a round takes {self.steps} steps")
        losses = []
        for t, batch in enumerate(steps_batch):
            grads, loss = self.grads_fn(self.params, batch)
            if self.first_grad_norms is None:
                self.first_grad_norms = {
                    k: float(torch.linalg.vector_norm(g.double()))
                    for k, g in grads.items()}
            self.params = {k: p - self.lr * grads[k]
                           for k, p in self.params.items()}
            losses.append(loss)
            for lvl in self.levels:
                if (t + 1) % lvl.period:
                    break
                self.reduce(lvl)
        return torch.stack(losses).mean()
