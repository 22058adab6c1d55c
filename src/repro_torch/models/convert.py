"""Carry configs and weights between the reference package and the port.

They take the reference's objects by duck type (a dataclass config, a
nested dict of arrays), so the port imports nothing of it.  With these the
two packages compute the same thing on the same weights, and a checkpoint
written by either (``tree_from_params`` gives the reference's layout)
loads in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import hybrid, mamba, transformer
from .params import HybridParams, ModelParams

_IMPLS = {"pallas": "kernel", "xla": "torch"}
_FAMILY_MODULES = {"dense": transformer, "ssm": mamba, "hybrid": hybrid}


def config_from_jax(cfg) -> ModelConfig:
    """The reference's ``ModelConfig`` as the port's: every field carried,
    ``"pallas"`` -> ``"kernel"`` and ``"xla"`` -> ``"torch"``."""

    fields = dataclasses.asdict(cfg)
    for key in ("attention_impl", "ssm_impl"):
        fields[key] = _IMPLS[fields[key]]
    return ModelConfig(**fields)


def _tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr.detach()
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: carry the bits
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr).copy())


def params_from_jax(cfg: ModelConfig, tree: dict, device=None) -> ModelParams | HybridParams:
    """The reference's parameter tree (arrays or tensors; per-layer leaves
    stacked on L under ``"layers"``, or for the hybrid on (G, E) under
    ``"mamba"`` beside the ``"shared"`` block) as the port's parameters,
    bit for bit, in the tree's dtypes, on ``device`` (``None``: the CUDA
    card; raises without one)."""

    device = resolve_device(device)
    tensors = {k: ({kk: _tensor(vv) for kk, vv in v.items()} if isinstance(v, dict)
                   else _tensor(v)) for k, v in tree.items()}
    stacked = tensors.get("layers", tensors.get("mamba", {}))
    dtypes = {leaf: t.dtype for group in (tensors, stacked, tensors.get("shared", {}))
              for leaf, t in group.items() if isinstance(t, torch.Tensor)}
    params = _FAMILY_MODULES[cfg.family].empty_params(cfg, device, dtypes.__getitem__)
    with torch.no_grad():
        for name, t in params.named_parameters():
            parts = name.split(".")
            if parts[0] == "layers":
                src = stacked[parts[2]]
                i = int(parts[1])
                src = src[divmod(i, src.shape[1])] if "mamba" in tensors else src[i]
            elif parts[0] == "shared":
                src = tensors["shared"][parts[1]]
            else:
                src = tensors[name]
            if src.shape != t.shape:
                raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(t.shape)}")
            t.copy_(src)
    return params


def tree_from_params(params: ModelParams | HybridParams) -> dict:
    """The inverse of :func:`params_from_jax`: the port's parameters as the
    reference's tree, ``{"tok_emb": ..., "layers": {"wq": (L, ...)}}`` (the
    hybrid: ``{"mamba": {"in_proj": (G, E, ...)}, "shared": {...}}``), of
    detached tensors on the parameters' device (the per-layer leaves
    stacked, so a copy; the other leaves share storage)."""

    tree: dict = {name: t.detach() for name, t in params.named_parameters(recurse=False)}
    names = [name for name, _ in params.layers[0].named_parameters()]
    layers = {name: torch.stack([getattr(w, name).detach() for w in params.layers])
              for name in names}
    if isinstance(params, HybridParams):
        tree["mamba"] = {name: t.unflatten(0, params.groups) for name, t in layers.items()}
        tree["shared"] = {name: t.detach() for name, t in params.shared.named_parameters()}
    else:
        tree["layers"] = layers
    return tree
