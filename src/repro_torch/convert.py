"""Carry the reference's parameters and training state across to the port.

``params_from_jax(np_params, cfg)`` takes the JAX package's parameter
pytree as a nested dict of numpy arrays (``jax.tree.map(np.asarray,
params)``) and returns a state dict for the port's model
(``repro_torch/models/transformer.py::DecoderLM``).  Stacked ``[L, ...]``
layer leaves are split per layer (``layers/attn/wq`` row ``i`` becomes
``layers.<i>.attn.wq``).

``train_params_from_jax(np_params, cfg)`` takes the same pytree as the
LM training parameters of the port (dense GQA decoders and the RWKV-6
LM), which keep the reference's stacked ``[L, ...]`` layer leaves.
``tree_from_numpy`` converts any nested dict/list tree of numpy arrays
(the ResNet and MLP classifier params) leaf by leaf, keeping its
structure; ``train_state_from_jax`` carries a whole Hier-AVG
``TrainState`` (params, optimizer state, step and the per-level reducer
state: top-k/random-k error feedback, PowerSGD's ref, err and warm-start
Q, per leaf or in bucket space) across, and ``train_state_to_numpy``
brings one back.  Values are copied exactly, bf16 included.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from repro_torch.comm.lowrank import LowRankState
from repro_torch.comm.sparse import EFState, rng_carry
from repro_torch.configs.base import ArchConfig
from repro_torch.core.hier_avg import TrainState
from repro_torch.models.transformer import (_split_layers,
                                            serve_unsupported_reason,
                                            train_unsupported_reason)


def _to_tensor(a: Any, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes' bf16: reinterpret bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def tree_from_numpy(tree: Any, *, device="cuda", path: str = "") -> Any:
    """A nested dict/list/tuple tree of numpy arrays (or numbers) -> the
    same tree of tensors on ``device``; dicts come back with sorted keys,
    the reference's leaf order.  ``None`` and ``()`` stay as they are."""
    if isinstance(tree, Mapping):
        return {k: tree_from_numpy(tree[k], device=device,
                                   path=f"{path}{k}.")
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_from_numpy(v, device=device, path=f"{path}{i}.")
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    if tree is None:
        return None
    try:
        return _to_tensor(tree, device)
    except TypeError as e:
        raise TypeError(f"leaf {path.rstrip('.') or '<root>'}: {e}") from e


def tree_to_numpy(tree: Any) -> Any:
    """Inverse of :func:`tree_from_numpy` (tuples and named tuples kept)."""
    if isinstance(tree, Mapping):
        return {k: tree_to_numpy(tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        out = [tree_to_numpy(v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


def rng_carry_from_jax(key: Any) -> torch.Tensor:
    """The reference's PRNG key (uint32 [2]) -> the port's random-k RNG
    carry (comm/sparse.py ``rng_carry``): seed = the key's 64 bits (top
    bit dropped), no fires yet.  The port cannot reproduce JAX's random
    bits, so the two streams differ from here on; only the carry's shape
    and its determinism carry over.  A port carry (int64 [3], from
    :func:`train_state_to_numpy`) is taken as it is."""
    k = np.asarray(key)
    if k.dtype == np.int64 and k.shape == (3,):
        return torch.from_numpy(k.copy())
    if k.dtype != np.uint32 or k.shape != (2,):
        raise ValueError(f"not a PRNG key or RNG carry: {k.dtype} {k.shape}")
    return rng_carry(((int(k[0]) << 32) | int(k[1])) & ((1 << 63) - 1))


def reducer_state_from_jax(st: Any, device="cuda") -> Any:
    """One level's reducer state with numpy leaves -> the port's
    ``LowRankState`` (it has a ``q``) or ``EFState``."""
    if "q" in getattr(st, "_fields", ()):
        return LowRankState(ref=tree_from_numpy(st.ref, device=device),
                            err=tree_from_numpy(st.err, device=device),
                            q=tree_from_numpy(st.q, device=device))
    return EFState(ref=tree_from_numpy(st.ref, device=device),
                   err=tree_from_numpy(st.err, device=device),
                   key=rng_carry_from_jax(st.key))


def train_state_from_jax(np_state: Any, *, device="cuda") -> TrainState:
    """The reference's ``TrainState`` with numpy leaves
    (``jax.tree.map(np.asarray, state)``) -> the port's.  Its
    ``comm_state`` is ``()`` or ``{level: EFState | LowRankState}``, per
    leaf or in bucket space (lists of bucket arrays); a dense PowerSGD
    leaf's ``q`` is ``()``.  The PRNG key of ``EFState`` becomes the
    port's RNG carry (:func:`rng_carry_from_jax`), kept on the CPU."""
    cs = np_state.comm_state
    comm = () if not cs else {
        name: reducer_state_from_jax(st, device)
        for name, st in sorted(cs.items())}
    return TrainState(
        params=tree_from_numpy(np_state.params, device=device),
        opt_state=tree_from_numpy(np_state.opt_state, device=device),
        step=int(np.asarray(np_state.step)), comm_state=comm)


def train_state_to_numpy(state: TrainState) -> TrainState:
    """The port's ``TrainState`` with numpy leaves and an int32 step, in
    the reference's layout (for comparison, or to carry a state back into
    :func:`train_state_from_jax`)."""
    return TrainState(params=tree_to_numpy(state.params),
                      opt_state=tree_to_numpy(state.opt_state),
                      step=np.int32(state.step),
                      comm_state=tree_to_numpy(state.comm_state))


def _leaves(tree: Mapping[str, Any], prefix: str = ""
            ) -> Iterator[Tuple[str, Any]]:
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _leaves(v, path + ".")
        else:
            yield path, v


def params_from_jax(np_params: Mapping[str, Any], cfg: ArchConfig, *,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> the port's state dict."""
    reason = serve_unsupported_reason(cfg)
    if reason:
        raise NotImplementedError(f"{cfg.name}: {reason}")
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(np_params):
        if path.startswith("layers."):
            rest = path[len("layers."):]
            stacked = np.asarray(leaf)
            if stacked.shape[0] != cfg.n_layers:
                raise ValueError(f"{path}: {stacked.shape[0]} layers "
                                 f"stacked, config has {cfg.n_layers}")
            for i in range(cfg.n_layers):
                out[f"layers.{i}.{rest}"] = _to_tensor(stacked[i], device)
        else:
            out[path] = _to_tensor(leaf, device)
    return out


def train_params_from_jax(np_params: Mapping[str, Any], cfg: ArchConfig, *,
                          device="cuda") -> Dict[str, Any]:
    """The reference's LM parameter pytree (numpy leaves) -> the port's
    training tree (``ModelBundle.init_train``'s layout): the same keys and
    stacked ``[L, ...]`` layer leaves, so the leaves come in
    ``jax.tree.leaves`` order.  Each stack's leaves must be as deep as
    the config's: ``layers`` holds the main stack and ``layers_dense`` the
    dense layers before a MoE stack (``first_k_dense``)."""
    if cfg.family == "ssm":
        depth = {"layers": cfg.n_layers}
    else:
        reason = train_unsupported_reason(cfg)
        if reason:
            raise NotImplementedError(f"{cfg.name}: {reason}")
        n_pre, n_main = _split_layers(cfg)
        depth = {"layers": n_main, "layers_dense": n_pre}
    for key, n in depth.items():
        if n == 0:
            if key in np_params:
                raise ValueError(f"{key}: present, config has no such "
                                 f"layers")
            continue
        for path, leaf in _leaves(np_params.get(key, {}), key + "."):
            if np.shape(leaf)[:1] != (n,):
                raise ValueError(f"{path}: stacked {np.shape(leaf)}, config "
                                 f"has {n} layers there")
    return tree_from_numpy(np_params, device=device)
