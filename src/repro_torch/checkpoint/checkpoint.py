"""Tree checkpointing in the reference's format: npz + json manifest
(PyTorch port of ``repro/checkpoint/checkpoint.py``).

save_checkpoint writes:
  <dir>/manifest.json   — leaf paths, shapes, dtypes, step, user metadata
  <dir>/arrays.npz      — leaves keyed by their flattened path

The format is the reference's, so either package loads what the other
saved.  A leaf's path is the reference's ``_path_str``: dict keys bare,
sequence indices as digits, and a named-tuple field with a leading dot
(``.params/<name>``, ``.comm_state/global/.err/0``), joined by ``/``.
bf16 leaves are stored as 2-byte void records (what numpy writes for the
reference's bf16 arrays) with ``bfloat16`` in the manifest; loading
reinterprets them as ``uint16`` bits and views those as
``torch.bfloat16``, so no bf16 numpy type is needed.

restore_checkpoint(dir, like) validates every array against the manifest
and against ``like`` (exact path set, shape, dtype; nothing is silently
cast) and places each leaf on the device of the matching ``like`` leaf.

On a mesh of ranks (``mesh=``, a bound ``RankMesh``, with the whole
grid's ``topo``) each rank holds a block of the learners.  Saving gathers
the blocks, and the shard rows of shard-space reducer state (``rows=``,
from ``core.hier_avg.state_rows``), into the whole grid's tree and rank
0 writes it, in the reference's format; restoring reads the whole tree
on every rank and keeps the rank's block (the counterpart of the
reference's ``shardings=``).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten

_BF16 = "bfloat16"


def _leaf_paths(tree: Any) -> List[Tuple[str, Any]]:
    """(path string, leaf) in the port's (and the reference's) leaf
    order: dicts by sorted key, sequences and named tuples in order,
    ``None`` as an empty node."""
    out: List[Tuple[str, Any]] = []

    def walk(node, parts):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], parts + [str(k)])
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for f, v in zip(node._fields, node):
                walk(v, parts + ["." + f])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, parts + [str(i)])
        elif node is not None:
            out.append(("/".join(parts), node))

    walk(tree, [])
    return out


def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    if isinstance(leaf, bool):
        return "bool"
    if isinstance(leaf, int):
        return "int32"           # a TrainState step, as the reference's
    return str(np.asarray(leaf).dtype)


def _to_numpy(leaf: Any) -> np.ndarray:
    """A leaf as the numpy array the reference would write."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy().view(np.dtype("V2"))
        return t.numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, dtype=np.int32)
    return np.asarray(leaf)


def _array_dtype(arr: np.ndarray, recorded: Optional[str] = None) -> str:
    """The dtype name of a loaded array: 2-byte void records are bf16
    when the manifest says so."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2 \
            and recorded == _BF16:
        return _BF16
    return str(arr.dtype)


def to_tensor(arr: np.ndarray, dtype: Optional[str] = None,
              device="cpu") -> torch.Tensor:
    """A loaded array as a tensor; ``dtype`` is the manifest's name
    (``bfloat16`` reinterprets 2-byte records as bf16 bits)."""
    if _array_dtype(arr, dtype) == _BF16 or str(arr.dtype) == _BF16:
        bits = np.ascontiguousarray(arr).view(np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _grid_leaves(tree: Any, mesh, topo, rows: Any):
    """(leaves, kinds): each leaf's kind on a rank's block is "rows" (a
    shard-space codec view ``[p, g, s*F_local, ...]``), "learner" (a
    stacked leaf ``[p, g, s, ...]``) or "same" (equal on every rank)."""
    flat, _ = flatten(tree)
    marks = [False] * len(flat) if rows is None else flatten(rows)[0]
    if len(marks) != len(flat):
        raise ValueError("rows= does not match the tree")
    block = mesh.block_topology(topo).shape
    kinds = []
    for x, m in zip(flat, marks):
        if m:
            kinds.append("rows")
        elif isinstance(x, torch.Tensor) and tuple(x.shape[:3]) == block:
            kinds.append("learner")
        else:
            kinds.append("same")
    return flat, kinds


def gather_blocks(tree: Any, mesh, topo, rows: Any = None) -> Any:
    """The whole grid's tree, on every rank, from each rank's block: one
    all-gather over the world per stacked leaf (the reference's arrays
    are global by construction)."""
    from repro_torch.parallel import collectives
    flat, kinds = _grid_leaves(tree, mesh, topo, rows)
    grid = tuple(mesh.devices.shape)
    fs = mesh.shape.get("fsdp", 1)
    out = []
    for x, kind in zip(flat, kinds):
        if kind == "same":
            out.append(x)
            continue
        g = collectives.all_gather(x.contiguous().unsqueeze(0), None,
                                   mesh.size).reshape(grid + tuple(x.shape))
        g = g.reshape((grid[0], grid[1], grid[2], fs, -1) + tuple(x.shape))
        g = g.select(4, 0)                      # model = 1
        rest = tuple(range(7, g.dim()))
        if kind == "learner":
            g = g.select(3, 0).permute((0, 3, 1, 4, 2, 5) + tuple(
                r - 1 for r in rest))
            out.append(g.reshape(topo.shape + tuple(x.shape[3:])))
        else:                                   # rows: (s, f) row-major
            g = g.permute((0, 4, 1, 5, 2, 6, 3) + rest)
            out.append(g.reshape(topo.shape[:2] + (-1,)
                                 + tuple(x.shape[3:])))
    return unflatten(flatten(tree)[1], out)


def take_blocks(tree: Any, mesh, topo, rows: Any = None,
                like: Any = None) -> Any:
    """Inverse of :func:`gather_blocks`: this rank's block of the whole
    grid's ``tree`` (kinds read from ``like``, the block-shaped tree, when
    given), each leaf on its ``like`` leaf's device."""
    flat, treedef = flatten(tree)
    _, kinds = _grid_leaves(tree if like is None else like, mesh, topo,
                            rows)
    devs = [getattr(x, "device", None)
            for x in (flat if like is None else flatten(like)[0])]
    fs = mesh.shape.get("fsdp", 1)
    f_spread = mesh.spread("fsdp")
    out = []
    for x, kind, dev in zip(flat, kinds, devs):
        if kind == "learner":
            x = mesh.take_block(x)
        elif kind == "rows":
            s = x.shape[2] // fs
            y = mesh.take_block(x.reshape(tuple(x.shape[:2]) + (s, fs)
                                          + tuple(x.shape[3:])))
            if f_spread > 1:
                y = y.narrow(3, mesh.coord("fsdp"), 1)
            x = y.reshape(tuple(y.shape[:2]) + (-1,) + tuple(y.shape[4:]))
        if isinstance(x, torch.Tensor):
            x = x.contiguous().to(dev)
        out.append(x)
    return unflatten(treedef, out)


def _grid_like(like: Any, mesh, topo, rows: Any) -> Any:
    """Host tensors with the whole grid's shapes for a block-shaped
    ``like`` (what :func:`restore_checkpoint` validates against)."""
    flat, kinds = _grid_leaves(like, mesh, topo, rows)
    fs = mesh.shape.get("fsdp", 1)
    out = []
    for x, kind in zip(flat, kinds):
        if kind == "same":
            out.append(x)
            continue
        lead = topo.shape if kind == "learner" \
            else topo.shape[:2] + (topo.local * fs,)
        out.append(torch.empty(lead + tuple(x.shape[3:]), dtype=x.dtype))
    return unflatten(flatten(like)[1], out)


def save_checkpoint(path: str, tree: Any, *, step: int = 0,
                    metadata: Optional[Dict] = None, mesh: Any = None,
                    topo: Any = None, rows: Any = None) -> None:
    """Write ``tree``.  With a bound ``mesh`` (and the whole grid's
    ``topo``), ``tree`` is this rank's block: every rank takes part in
    the gather and rank 0 writes; the others return once it has."""
    if mesh is not None and mesh.bound:
        from repro_torch.parallel import collectives
        tree = gather_blocks(tree, mesh, topo, rows)
        if mesh.rank == 0:
            save_checkpoint(path, tree, step=step, metadata=metadata)
        collectives.barrier()
        return
    os.makedirs(path, exist_ok=True)
    arrays = {}
    entries = []
    for key, leaf in _leaf_paths(tree):
        arr = _to_numpy(leaf)
        arrays[key] = arr
        entries.append({"path": key, "shape": list(arr.shape),
                        "dtype": _dtype_name(leaf)})
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    manifest = {"step": int(step), "entries": entries,
                "metadata": metadata or {}}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def load_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """The saved arrays by path, as numpy stores them (bf16 leaves as
    2-byte void records: :func:`to_tensor` with the manifest's dtype
    turns them into tensors)."""
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def checkpoint_step(path: str) -> int:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["step"]


def _manifest_entries(path: str) -> Dict[str, Dict]:
    with open(os.path.join(path, "manifest.json")) as f:
        return {e["path"]: e for e in json.load(f)["entries"]}


def _validate_manifest(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Cross-check arrays.npz against manifest.json: same leaf set, and
    each array's shape/dtype matches what the manifest recorded at save
    time.  Any drift means on-disk corruption (truncated npz, manifest
    from a different run) and raises naming the offending leaf."""
    entries = _manifest_entries(path)
    man_only = sorted(set(entries) - set(arrays))
    npz_only = sorted(set(arrays) - set(entries))
    if man_only or npz_only:
        raise ValueError(
            f"corrupt checkpoint at '{path}': manifest.json and "
            f"arrays.npz disagree (manifest-only leaves: {man_only}, "
            f"npz-only leaves: {npz_only})")
    for key, e in entries.items():
        arr = arrays[key]
        if (list(arr.shape) != list(e["shape"])
                or _array_dtype(arr, e["dtype"]) != e["dtype"]):
            raise ValueError(
                f"corrupt checkpoint at '{path}': leaf '{key}' is "
                f"{arr.dtype}{tuple(arr.shape)} in arrays.npz but the "
                f"manifest records "
                f"{e['dtype']}{tuple(e['shape'])}")


def restore_checkpoint(path: str, like: Any, *, mesh: Any = None,
                       topo: Any = None, rows: Any = None) -> Any:
    """Restore into the structure of ``like``.

    With a bound ``mesh`` (and the whole grid's ``topo``), ``like`` is
    this rank's block: the whole grid's checkpoint is validated and read,
    and the rank keeps its block (:func:`take_blocks`).

    Validation: the checkpoint's leaf set must equal ``like``'s exactly
    (extra or missing paths raise listing them), each array must match
    its manifest entry (:func:`_validate_manifest`), and each array's
    shape AND dtype must match the corresponding ``like`` leaf — a dtype
    drift raises instead of silently casting, since for EF/quantized
    reducer state a cast would corrupt the carried error feedback.

    Placement: each tensor goes to the device of its ``like`` leaf; a
    Python int leaf (a TrainState step) comes back as an int."""
    if mesh is not None and mesh.bound:
        whole = restore_checkpoint(path, _grid_like(like, mesh, topo, rows))
        return take_blocks(whole, mesh, topo, rows, like=like)
    arrays = load_checkpoint(path)
    _validate_manifest(path, arrays)
    entries = _manifest_entries(path)

    like_flat = _leaf_paths(like)
    like_keys = [k for k, _ in like_flat]
    extra = sorted(set(arrays) - set(like_keys))
    if extra:
        raise ValueError(
            f"checkpoint at '{path}' has leaves with no counterpart in "
            f"`like` (tree path mismatch?): {extra}")
    missing = sorted(set(like_keys) - set(arrays))
    if missing:
        raise KeyError(
            f"checkpoint at '{path}' missing leaves: {missing}")

    def restore(key, leaf):
        arr = arrays[key]
        want_shape = tuple(getattr(leaf, "shape", ()))
        if tuple(arr.shape) != want_shape:
            # learner-count drift: same per-learner payload, different
            # stacked [pods, groups, local] lead — the elastic-resume
            # case, which has its own entry point
            if (arr.ndim == len(want_shape) and arr.ndim > 3
                    and tuple(arr.shape[3:]) == want_shape[3:]
                    and tuple(arr.shape[:3]) != want_shape[:3]):
                old_n = int(np.prod(arr.shape[:3]))
                new_n = int(np.prod(want_shape[:3]))
                raise ValueError(
                    f"learner-count mismatch for '{key}': the checkpoint "
                    f"was saved on a {tuple(arr.shape[:3])} "
                    f"[pods, groups, local] learner grid ({old_n} "
                    f"learners) but `like` expects "
                    f"{want_shape[:3]} ({new_n} learners).  "
                    f"restore_checkpoint never resizes the learner axes "
                    f"— resume onto a different fleet with "
                    f"repro_torch.elastic.elastic_restore(path, like, "
                    f"new_topo=...), which bit-preserves survivors and "
                    f"remaps (or loudly drops) reducer state.")
            raise ValueError(
                f"shape mismatch for '{key}': ckpt {arr.shape} vs "
                f"expected {want_shape}")
        got, want = _array_dtype(arr, entries[key]["dtype"]), \
            _dtype_name(leaf)
        if got != want:
            raise ValueError(
                f"dtype mismatch for '{key}': ckpt {got} vs "
                f"expected {want} (restore never casts "
                f"— fix `like` or re-save the checkpoint)")
        if isinstance(leaf, torch.Tensor):
            return to_tensor(arr, got, device=leaf.device)
        if isinstance(leaf, int):
            return int(arr)
        return arr

    flat, treedef = flatten(like)
    if len(flat) != len(like_flat):
        raise ValueError("`like` has leaves the checkpoint format cannot "
                         "name")
    return unflatten(treedef, [restore(k, leaf) for k, leaf in like_flat])
