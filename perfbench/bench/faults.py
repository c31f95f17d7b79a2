"""Faults planted underneath the timed path, for the tests and the
readings that show the check fails them: each wraps the program's round
(``WRAPS``) or patches what it calls (``PATCHES``), and changes nothing
else."""
from __future__ import annotations

import contextlib


def unchanged(rnd):
    """A round that returns the state it was given (and the metrics of
    the work it did)."""
    def f(state, batch):
        _, metrics = rnd(state, batch)
        return state, metrics
    return f


def half_batch(rnd):
    """A round that leaves out the second half of every learner's batch
    (dim 5: after the step and learner axes), so each learner's loss is
    the mean over the rest."""
    def f(state, batch):
        return rnd(state, {k: v.narrow(5, 0, v.shape[5] // 2)
                           for k, v in batch.items()})
    return f


def no_exchange():
    """The learner mean left out: every level's average returns each
    learner's own values."""
    import repro_torch.core.hier_avg as hier_avg
    return _patched(hier_avg, "average_over",
                    lambda f: lambda tree, axes, *a, **k: tree)


def _patched(owner, attr: str, make):
    """A context in which ``owner.attr`` is ``make(the original)``."""
    @contextlib.contextmanager
    def ctx():
        saved = getattr(owner, attr)
        setattr(owner, attr, make(saved))
        try:
            yield
        finally:
            setattr(owner, attr, saved)
    return ctx()


def dropped_residual():
    """The top-k error feedback's carried residual left out: delta is
    x - ref alone, and what it does not send is all the residual kept."""
    import torch
    from repro_torch.comm.sparse import _SparseEFReducer
    from repro_torch.tree import tree_map

    def make(compress):
        def f(self, tree, state):
            return compress(self, tree, state._replace(
                err=tree_map(torch.zeros_like, state.err)))
        return f
    return _patched(_SparseEFReducer, "compress", make)


def stale_ref():
    """The top-k error feedback's reference left where it was after a
    fire, instead of moved to the level's mean."""
    from repro_torch.comm.sparse import _SparseEFReducer

    def make(finalize):
        def f(self, avg_tree, orig_tree, state):
            return finalize(self, avg_tree, orig_tree, state)[0], state
        return f
    return _patched(_SparseEFReducer, "finalize", make)


WRAPS = {"unchanged": unchanged, "half_batch": half_batch}
PATCHES = {"no_exchange": no_exchange, "dropped_residual": dropped_residual,
           "stale_ref": stale_ref}
