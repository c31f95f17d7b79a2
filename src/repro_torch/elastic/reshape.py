"""Checkpointed fleet reshape: resume a run onto a *different* learner count
(PyTorch port of ``repro/elastic/reshape.py``).

Hier-AVG state is learner-stacked — every params / opt-state / EF leaf
carries the ``[pods, G, S]`` lead axes — so joins and leaves at a round
boundary are a pure re-indexing of those lead axes:

  * **survivors** (old learners that stay) land in the new grid with
    their params, optimizer moments, and error-feedback residuals
    *bit-preserved* (the remap is a gather, never an arithmetic op);
  * **joiners** (new slots beyond the survivors) clone a donor learner's
    params/opt-state — the elastic analogue of the paper's shared-w_1
    init — and start with a ZERO error-feedback residual (a cloned
    residual would double-count the donor's untransmitted mass at the
    next fire).

Why this works for ``comm_state`` too: fsdp=1 :class:`BucketLayout`\\ s
pack per-learner runs with no learner-count-dependent padding
(comm/bucket.py pads runs to a multiple of the lead mesh size only when
a ShardPlan is attached), so bucket-space EF leaves keep their trailing
``(run,)`` — and PowerSGD's warm-start ``q`` its ``(b, rank)`` — across
any fleet size, and the same lead-axes gather applies.  Shard-aware
(fsdp>1) layouts break both properties: the codec view merges shards
into the local axis (``[pods, G, S*F, run]``) and run padding depends on
the lead count, so that state cannot be re-indexed — it is *dropped
loudly* (:class:`CommStateDropWarning`, naming the level and codec) and
re-initialized fresh, exactly like the ``PSpecDropWarning`` convention
for unshardable specs.  Dropping EF costs one round of compression error
(the residual restarts at zero), not correctness.

Entry points: :func:`reshape_state` (in-memory, round-boundary
join/leave), :func:`save_elastic_checkpoint` /
:func:`elastic_restore` (cross-process, stamps/reads the source
topology in the checkpoint manifest).
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.topology import HierTopology
from repro_torch.tree import tree_map


class CommStateDropWarning(UserWarning):
    """A reducer's carried state could not survive a fleet reshape and
    was re-initialized (EF residual restarts at zero)."""


def learner_index_map(old_topo: HierTopology, new_topo: HierTopology,
                      survivors: Optional[Sequence[int]] = None,
                      donor: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The lead-axes gather plan of a reshape.

    Returns ``(src, joiner)``: ``src[j]`` is the OLD flat learner id
    (row-major over ``[pods, G, S]``) whose state fills NEW flat slot
    ``j``, and ``joiner[j]`` marks slots filled by donor-cloning rather
    than survival.  ``survivors`` lists the old flat ids that stay, in
    the order they take the new slots (default: identity over the first
    ``min(old_P, new_P)`` learners); ``donor`` is the old flat id cloned
    into every remaining slot (default: the first survivor).
    """
    old_p, new_p = old_topo.n_learners, new_topo.n_learners
    if survivors is None:
        survivors = list(range(min(old_p, new_p)))
    survivors = [int(j) for j in survivors]
    if len(set(survivors)) != len(survivors):
        raise ValueError(f"duplicate survivor ids: {survivors}")
    if survivors and not all(0 <= j < old_p for j in survivors):
        raise ValueError(
            f"survivor ids must be old flat learner ids in [0, {old_p}), "
            f"got {survivors}")
    if len(survivors) > new_p:
        raise ValueError(
            f"{len(survivors)} survivors do not fit the new topology's "
            f"{new_p} learners ({new_topo.describe()})")
    if not survivors:
        raise ValueError("a reshape needs at least one survivor")
    if donor is None:
        donor = survivors[0]
    donor = int(donor)
    if not 0 <= donor < old_p:
        raise ValueError(f"donor must be an old flat learner id in "
                         f"[0, {old_p}), got {donor}")
    src = np.full(new_p, donor, dtype=np.int64)
    src[:len(survivors)] = survivors
    joiner = np.ones(new_p, dtype=bool)
    joiner[:len(survivors)] = False
    return src, joiner


def _remap_lead(x, old_shape, new_shape, src: np.ndarray):
    """Gather the flattened ``[pods*G*S, ...]`` lead onto the new grid —
    pure re-indexing, bit-preserving for every surviving row."""
    flat = x.reshape((-1,) + tuple(x.shape[3:]))
    idx = torch.as_tensor(src, dtype=torch.long, device=x.device)
    return flat.index_select(0, idx).reshape(
        tuple(new_shape) + tuple(x.shape[3:]))


def _leaf_kind(shape, old_topo: HierTopology) -> str:
    """'stacked' (remappable lead-3), 'codec' (shard-merged local axis —
    NOT remappable), or 'other' (keys/scalars — count-independent)."""
    shape = tuple(shape)
    if len(shape) >= 3 and shape[:3] == old_topo.shape:
        return "stacked"
    if (len(shape) >= 3 and shape[:2] == old_topo.shape[:2]
            and shape[2] != old_topo.local and shape[2] % old_topo.local == 0):
        return "codec"
    return "other"


def _remap_tree(tree, old_topo, new_topo, src):
    """Remap every stacked leaf; raises ValueError on codec-view leaves
    (callers catch it to drop the level's state instead)."""
    def go(x):
        kind = _leaf_kind(getattr(x, "shape", ()), old_topo)
        if kind == "stacked":
            return _remap_lead(x, old_topo.shape, new_topo.shape, src)
        if kind == "codec":
            raise _CodecLeaf(tuple(x.shape))
        return x
    return tree_map(go, tree)


class _CodecLeaf(Exception):
    pass


def _zero_joiner_err(lvl_state, new_topo, joiner: np.ndarray):
    """Zero the joiners' rows of a remapped level state's ``err`` leaves:
    a cloned residual is the donor's untransmitted mass, which the donor
    itself will still transmit — carrying a copy would inject it twice."""
    if not hasattr(lvl_state, "err") or not hasattr(lvl_state, "_replace"):
        return lvl_state
    keep = torch.from_numpy(~joiner.reshape(new_topo.shape))

    def zero(x):
        if _leaf_kind(getattr(x, "shape", ()), new_topo) != "stacked":
            return x
        k = keep.to(x.device).reshape(
            tuple(keep.shape) + (1,) * (x.dim() - keep.dim()))
        return torch.where(k, x, torch.zeros_like(x))

    return lvl_state._replace(err=tree_map(zero, lvl_state.err))


def reshape_comm_state(comm_state, old_topo: HierTopology,
                       new_topo: HierTopology, src: np.ndarray,
                       joiner: np.ndarray, *, plan=None, params=None):
    """Remap per-level reducer carry across a reshape.

    Levels whose state is pure lead-stacked arrays (param-space EF,
    fsdp=1 bucket-space EF, PowerSGD warm-start q) are gathered like the
    params, with joiners' ``err`` zeroed.  Levels carrying codec-view
    (shard-merged) leaves raise :class:`CommStateDropWarning` and take a
    fresh ``init_state`` — which needs ``plan`` and the already-remapped
    ``params``; without them the level's state is dropped to ``()``.
    """
    if comm_state == () or comm_state is None:
        return comm_state
    by_level = {}
    for name, lvl_state in comm_state.items():
        try:
            new_lvl = _remap_tree(lvl_state, old_topo, new_topo, src)
        except _CodecLeaf as e:
            reducer = None
            if plan is not None:
                reducer = next((l.reducer for l in plan.levels
                                if l.name == name), None)
            desc = reducer.describe() if reducer is not None else "?"
            can_reinit = reducer is not None and params is not None
            warnings.warn(
                f"fleet reshape {old_topo.shape} -> {new_topo.shape}: "
                f"level '{name}' ({desc}) carries shard-space (codec-view "
                f"{e.args[0]}) reducer state whose layout depends on the "
                f"learner count; "
                + ("re-initializing it fresh" if can_reinit
                   else "dropping it (pass plan= and params= to re-init)")
                + " — the EF residual restarts at zero.",
                CommStateDropWarning, stacklevel=3)
            new_lvl = (reducer.init_state(params) if can_reinit else ())
            by_level[name] = new_lvl
            continue
        by_level[name] = _zero_joiner_err(new_lvl, new_topo, joiner)
    return by_level


def reshape_state(state, old_topo: HierTopology, new_topo: HierTopology,
                  *, plan=None, survivors: Optional[Sequence[int]] = None,
                  donor: Optional[int] = None):
    """Join/leave at a round boundary: re-stack a ``TrainState`` from
    ``old_topo`` onto ``new_topo`` (module docstring for semantics).

    ``plan`` — the resolved
    :class:`~repro_torch.core.plan.ReductionPlan` of the run — is only
    needed to re-initialize reducer state that cannot be
    remapped (shard-aware layouts).  Survivors' params / opt-state / EF
    are bit-preserved (test-enforced).
    """
    src, joiner = learner_index_map(old_topo, new_topo, survivors, donor)
    params = _remap_tree(state.params, old_topo, new_topo, src)
    opt_state = _remap_tree(state.opt_state, old_topo, new_topo, src)
    comm_state = reshape_comm_state(
        state.comm_state, old_topo, new_topo, src, joiner,
        plan=plan, params=params)
    return state._replace(params=params, opt_state=opt_state,
                          comm_state=comm_state)


# ---------------------------------------------------------------------- #
# checkpointed reshape
# ---------------------------------------------------------------------- #

def save_elastic_checkpoint(path: str, state, topo: HierTopology, *,
                            step: int = 0, plan=None,
                            metadata=None) -> None:
    """``save_checkpoint`` stamping the source topology (and plan spec)
    into the manifest metadata, so :func:`elastic_restore` can infer the
    saved learner grid without the caller carrying it around."""
    from repro_torch.checkpoint import save_checkpoint
    md = dict(metadata or {})
    md["topology"] = list(topo.shape)
    if plan is not None:
        md["plan"] = plan.describe()
    save_checkpoint(path, state, step=step, metadata=md)


def checkpoint_topology(path: str) -> Optional[HierTopology]:
    """The ``HierTopology`` stamped by :func:`save_elastic_checkpoint`,
    or None for plain checkpoints."""
    import json
    import os
    with open(os.path.join(path, "manifest.json")) as f:
        md = json.load(f).get("metadata", {})
    shape = md.get("topology")
    return HierTopology(*shape) if shape else None


def elastic_restore(path: str, like, *, new_topo: HierTopology,
                    old_topo: Optional[HierTopology] = None,
                    plan=None, survivors: Optional[Sequence[int]] = None,
                    donor: Optional[int] = None):
    """Resume a checkpoint onto a *different* learner count.

    ``like`` is a freshly-initialized ``TrainState`` (or any matching
    tree) at the NEW topology — it supplies the target structure,
    dtypes, and devices exactly as ``restore_checkpoint`` does.
    ``old_topo`` is read from the manifest
    (:func:`save_elastic_checkpoint`) when not given.  Stacked leaves are
    gathered through :func:`learner_index_map` (survivors bit-preserved,
    joiners donor-cloned, joiner EF zeroed); codec-view reducer state
    follows the :func:`reshape_comm_state` drop-or-re-init policy; leaves
    whose saved shape already matches restore untouched.  Same learner
    count falls through to plain ``restore_checkpoint``.
    """
    import os
    import tempfile

    from repro_torch.checkpoint.checkpoint import (_leaf_paths,
                                                   _manifest_entries,
                                                   _validate_manifest,
                                                   load_checkpoint,
                                                   restore_checkpoint,
                                                   save_checkpoint,
                                                   to_tensor)
    from repro_torch.tree import flatten, unflatten

    if old_topo is None:
        old_topo = checkpoint_topology(path)
        if old_topo is None:
            raise ValueError(
                f"checkpoint at '{path}' carries no topology metadata — "
                f"pass old_topo= (or re-save with save_elastic_checkpoint)")
    if old_topo.shape == new_topo.shape and survivors is None:
        return restore_checkpoint(path, like)

    arrays = load_checkpoint(path)
    _validate_manifest(path, arrays)
    dtypes = {k: e["dtype"] for k, e in _manifest_entries(path).items()}
    src, joiner = learner_index_map(old_topo, new_topo, survivors, donor)

    # Re-stack every saved learner-stacked array onto the new grid in
    # numpy (host side, exact gather), then hand the result to the strict
    # restore path for structure/dtype validation and device placement.
    remapped = {}
    dropped = []
    for key, arr in arrays.items():
        kind = _leaf_kind(arr.shape, old_topo)
        if kind == "stacked":
            flat = arr.reshape((-1,) + arr.shape[3:])
            out = flat[src].reshape(new_topo.shape + arr.shape[3:])
            # EFState.err field component (named-tuple fields serialize
            # with a leading "." — ".comm_state/global/.err/0")
            if any(c.lstrip(".") == "err" for c in key.split("/")):
                out = out.copy()
                out.reshape((new_topo.n_learners,) + arr.shape[3:])[
                    joiner] = np.zeros((), out.dtype)
            remapped[key] = to_tensor(out, dtypes[key])
        elif kind == "codec":
            dropped.append(key)
        else:
            remapped[key] = to_tensor(arr, dtypes[key])

    like_flat = _leaf_paths(like)
    for key, leaf in like_flat:
        if key in remapped:
            continue
        # dropped codec-view state (or structural drift the strict
        # validator will flag): seed from the fresh `like` leaf
        if key in dropped or key not in arrays:
            if key in dropped:
                warnings.warn(
                    f"elastic restore {old_topo.shape} -> "
                    f"{new_topo.shape}: leaf '{key}' is shard-space "
                    f"(codec-view) reducer state whose layout depends on "
                    f"the learner count; keeping `like`'s fresh init — "
                    f"the EF residual restarts at zero.",
                    CommStateDropWarning, stacklevel=2)
            remapped[key] = leaf

    _, treedef = flatten(like)
    with tempfile.TemporaryDirectory() as tmp:
        tmp_ckpt = os.path.join(tmp, "reshaped")
        save_checkpoint(tmp_ckpt, unflatten(
            treedef, [remapped[k] for k, _ in like_flat]))
        return restore_checkpoint(tmp_ckpt, like)
