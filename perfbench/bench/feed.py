"""The general generator of a cell's inputs: one round's batch at a time,
fixed by the run's seed and the round's index.

A configuration names the kind of its inputs (``inputs``); a traffic mix
gives the numbers.  A round's batch has leaves shaped
``[steps, pods, groups, local, batch, ...]`` (the step axis split as the
plan's periods nest, ``batch_dims``), the layout the trainer takes.

  images   a Gaussian mixture shaped as images: per class a mean of norm
           2 in a random direction, each image its class's mean plus
           ``noise`` times N(0, 1) per entry; labels uniform.  Drawn on the
           device each round.
  tokens   chains of ``seq`` + 1 tokens of a first-order Markov chain over
           ``markov_vocab`` tokens, whose transition logits are
           ``markov_temperature`` times N(0, 1); the first token uniform.
           ``pool_rounds`` rounds are drawn at set-up in one call (the
           chain's steps are sequential), and round r takes pool entry
           r mod ``pool_rounds``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from perfbench.bench.seeds import derive


class Feed:
    def __init__(self, cfg: Dict, traffic: Dict, batch_dims: Tuple[int, ...],
                 seed: int, device):
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.device = seed, torch.device(device)
        self.lead = tuple(batch_dims) + tuple(cfg["topology"]) + (
            traffic["batch_per_learner"],)
        self.rows = math.prod(self.lead)
        kind = cfg["inputs"]
        if kind == "images":
            dim = cfg["image_size"] ** 2 * cfg["channels"]
            g = self._gen("means")
            means = torch.randn((cfg["n_classes"], dim), generator=g,
                                device=self.device)
            self.means = means / torch.linalg.vector_norm(
                means, dim=-1, keepdim=True) * 2.0
        elif kind == "tokens":
            v = traffic["markov_vocab"]
            logits = torch.randn((v, v), generator=self._gen("chain"),
                                 device=self.device) \
                * traffic["markov_temperature"]
            self.pool = self._chains(torch.softmax(logits, dim=-1),
                                     traffic["pool_rounds"] * self.rows)
        else:
            raise ValueError(f"unknown input kind {kind!r}")
        self.kind = kind

    def _gen(self, *tags) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            derive(self.seed, "feed", *tags))

    def _chains(self, probs: torch.Tensor, n: int) -> torch.Tensor:
        g = self._gen("chains")
        seq = self.traffic["seq"]
        tok = torch.randint(0, probs.shape[0], (n,), generator=g,
                            device=self.device)
        out = torch.empty((n, seq + 1), dtype=torch.int32,
                          device=self.device)
        out[:, 0] = tok
        for t in range(seq):
            tok = torch.multinomial(probs[tok], 1, generator=g)[:, 0]
            out[:, t + 1] = tok
        return out

    def round(self, r: int) -> Dict[str, torch.Tensor]:
        """Round ``r``'s batch."""
        if self.kind == "images":
            cfg = self.cfg
            g = self._gen("round", r)
            y = torch.randint(0, cfg["n_classes"], (self.rows,),
                              generator=g, device=self.device)
            x = self.means[y] + self.traffic["noise"] * torch.randn(
                (self.rows, self.means.shape[1]), generator=g,
                device=self.device)
            side = cfg["image_size"]
            return {"x": x.reshape(self.lead + (side, side,
                                                cfg["channels"])),
                    "y": y.reshape(self.lead)}
        at = (r % self.traffic["pool_rounds"]) * self.rows
        t = self.pool[at:at + self.rows]
        seq = self.traffic["seq"]
        return {"tokens": t[:, :-1].reshape(self.lead + (seq,)),
                "labels": t[:, 1:].reshape(self.lead + (seq,))}


def per_step(round_batch: Dict[str, torch.Tensor], n_step_dims: int,
             n_learners: int):
    """A round's batch as its steps' batches, leaves [learners, B, ...]:
    what the plain reference takes."""
    def split(x):
        steps = math.prod(x.shape[:n_step_dims])
        return x.reshape((steps, n_learners) + tuple(x.shape[n_step_dims
                                                              + 3:]))
    parts = {k: split(v) for k, v in round_batch.items()}
    steps = next(iter(parts.values())).shape[0]
    return [{k: v[t] for k, v in parts.items()} for t in range(steps)]
