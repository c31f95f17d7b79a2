"""Carry the reference's parameters across to the port.

``params_from_jax(np_params, cfg)`` takes the JAX package's parameter
pytree as a nested dict of numpy arrays (``jax.tree.map(np.asarray,
params)``) and returns a state dict for the port's model
(``repro_torch/models/transformer.py::DecoderLM``).  Stacked ``[L, ...]``
layer leaves are split per layer (``layers/attn/wq`` row ``i`` becomes
``layers.<i>.attn.wq``); values are copied exactly, bf16 included.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import unsupported_reason


def _to_tensor(a: Any, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes' bf16: reinterpret bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


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
    reason = unsupported_reason(cfg)
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
