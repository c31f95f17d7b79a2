"""Per-block int8 scale quantization reducer (PyTorch port of
``repro/comm/quant.py``).

Each learner quantizes its parameters blockwise (absmax scale per block of
``block`` consecutive elements, int8 mantissa): 1 byte per element plus 4
per block on the wire instead of 4 per element.  Stateless: the round-trip
error is bounded by ``absmax(block) / 254`` per element, so no error
feedback is carried.

Two wire layouts:

  * **fused** (default): ``kernels/ops.py::qint8_pack`` emits one int8
    buffer per leaf or bucket, payload and bitcast fp32 scale interleaved
    per block, so a reduction ships ONE message per leaf or bucket; the
    final partial block's zero tail rides along and is billed.  On a CUDA
    tensor the pack and unpack are the hand-written kernels of
    ``kernels/csrc/qint8_pack.cu``.
  * **twopass** (``qint8:<block>:twopass``): :func:`quantize_block` /
    :func:`dequantize_block`, int8 payload and fp32 scales as two
    messages per leaf or bucket (the plain tensor ops of
    ``kernels/ref.py``, as the reference's are plain jnp).

Both quantize with identical math, so the dequantized values are
bit-identical.
"""
from __future__ import annotations

import torch

from repro_torch.comm.reducer import N_LEARNER_AXES, Reducer, per_learner_size
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.tree import flatten, leaves, tree_map, unflatten


def quantize_block(x2d: torch.Tensor, block: int):
    """[rows, n] -> (q int8 [rows, nb, block], scale fp32 [rows, nb, 1])."""
    return kref.qint8_quantize_plain(x2d, block)


def dequantize_block(q: torch.Tensor, scale: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Inverse of quantize_block: -> [rows, n] fp32 (padding stripped)."""
    return kref.qint8_dequantize_plain(q, scale, n)


class QInt8Reducer(Reducer):
    """int8 payload with per-block fp32 scales; averaging in fp32."""

    name = "qint8"
    bucket_by_default = True
    has_codec = True

    def __init__(self, block: int = 256, fused: bool = True,
                 impl: str = "auto"):
        if block < 1:
            raise ValueError(f"qint8 block must be >= 1, got {block}")
        if impl not in ops.IMPLS:
            raise ValueError(f"impl {impl!r} not in {ops.IMPLS}")
        self.block = int(block)
        self.fused = bool(fused)
        self.impl = impl

    def _flat(self, leaf: torch.Tensor) -> torch.Tensor:
        rows = 1
        for d in leaf.shape[:N_LEARNER_AXES]:
            rows *= d
        return leaf.reshape(rows, per_learner_size(leaf)).contiguous()

    def compress(self, tree, state):
        if self.fused:
            payload = [ops.qint8_pack(self._flat(leaf), self.block,
                                      impl=self.impl)
                       for leaf in leaves(tree)]
        else:
            payload = [quantize_block(self._flat(leaf), self.block)
                       for leaf in leaves(tree)]
        return payload, state

    def decompress(self, payload, like, state):
        flat, treedef = flatten(like)
        if self.fused:
            out = [ops.qint8_unpack(w, per_learner_size(leaf),
                                    impl=self.impl).reshape(leaf.shape)
                   for w, leaf in zip(payload, flat)]
        else:
            out = [dequantize_block(q, s, per_learner_size(leaf)
                                    ).reshape(leaf.shape)
                   for (q, s), leaf in zip(payload, flat)]
        return unflatten(treedef, out)

    def finalize(self, avg_tree, orig_tree, state):
        return tree_map(lambda a, o: a.to(o.dtype), avg_tree,
                        orig_tree), state

    def n_messages(self, tree) -> int:
        """Fused: one packed buffer per leaf/bucket.  Two-pass: the int8
        payload and the fp32 scale array each ride as their own
        collective."""
        return (1 if self.fused else 2) * len(leaves(tree))

    def payload_bytes(self, tree) -> int:
        total = 0
        for leaf in leaves(tree):
            n = leaf.numel()
            nb = -(-n // self.block)
            # fused: whole blocks ship, the final block's zero tail too
            total += nb * (self.block + 4) if self.fused else n + nb * 4
        return int(total)

    def _describe(self) -> str:
        return f"qint8:{self.block}" + ("" if self.fused else ":twopass")
