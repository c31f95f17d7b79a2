"""Seeds derived from the run's ``--seed``: one 63-bit generator seed per
purpose, so that the weights, the data and each round's batch are fixed
by the run's seed and independent of one another."""
from __future__ import annotations

import hashlib

_MASK63 = (1 << 63) - 1


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for ``tags`` under ``seed`` (any whole number)."""
    text = ":".join([str(int(seed))] + [str(t) for t in tags])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") & _MASK63
