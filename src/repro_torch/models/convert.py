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
from .params import EncDecParams, HybridParams, ModelParams
from .registry import FAMILY_MODULES

_IMPLS = {"pallas": "kernel", "xla": "torch"}


def config_from_jax(cfg) -> ModelConfig:
    """The reference's ``ModelConfig`` as the port's: every field carried,
    ``"pallas"`` -> ``"kernel"`` and ``"xla"`` -> ``"torch"``."""

    fields = dataclasses.asdict(cfg)
    for key in ("attention_impl", "ssm_impl"):
        fields[key] = _IMPLS[fields[key]]
    return ModelConfig(**fields)


# ml_dtypes' dtypes, which torch.from_numpy refuses: carried as their bits
_BITS = {"bfloat16": (np.uint16, torch.bfloat16),
         "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr.detach()
    arr = np.ascontiguousarray(np.asarray(arr))
    if arr.dtype.name in _BITS:
        bits, dtype = _BITS[arr.dtype.name]
        return torch.from_numpy(arr.view(bits).copy()).view(dtype)
    return torch.from_numpy(arr.copy())


def params_from_jax(cfg: ModelConfig, tree: dict, device=None
                    ) -> ModelParams | HybridParams | EncDecParams:
    """The reference's parameter tree (arrays or tensors; per-layer leaves
    stacked on L under ``"layers"`` (a MoE layer's ``w1`` is (L, E, D, F)),
    under ``"encoder"`` and ``"decoder"`` for the encoder-decoder, or for
    the hybrid on (G, E) under ``"mamba"`` beside the ``"shared"`` block) as
    the port's parameters, bit for bit, in the tree's dtypes, on ``device``
    (``None``: the CUDA card; raises without one)."""

    device = resolve_device(device)
    tensors = {k: ({kk: _tensor(vv) for kk, vv in v.items()} if isinstance(v, dict)
                   else _tensor(v)) for k, v in tree.items()}
    dtypes = {leaf: t.dtype for v in tensors.values()
              for leaf, t in (v.items() if isinstance(v, dict) else ())}
    dtypes.update({leaf: t.dtype for leaf, t in tensors.items() if isinstance(t, torch.Tensor)})
    params = FAMILY_MODULES[cfg.family].empty_params(cfg, device, dtypes.__getitem__)
    with torch.no_grad():
        for name, t in params.named_parameters():
            parts = name.split(".")
            if len(parts) == 1:
                src = tensors[name]
            elif parts[0] == "shared":
                src = tensors["shared"][parts[1]]
            elif isinstance(params, HybridParams):
                src = tensors["mamba"][parts[2]]
                src = src[divmod(int(parts[1]), src.shape[1])]
            else:  # a stack on L: "layers", "encoder" or "decoder"
                src = tensors[parts[0]][parts[2]][int(parts[1])]
            if src.shape != t.shape:
                raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(t.shape)}")
            t.copy_(src)
    return params


def tree_from_params(params: ModelParams | HybridParams | EncDecParams) -> dict:
    """The inverse of :func:`params_from_jax`: the port's parameters as the
    reference's tree, ``{"tok_emb": ..., "layers": {"wq": (L, ...)}}`` (the
    encoder-decoder: ``"encoder"`` and ``"decoder"`` stacks; the hybrid:
    ``{"mamba": {"in_proj": (G, E, ...)}, "shared": {...}}``), of detached
    tensors on the parameters' device (the per-layer leaves stacked, so a
    copy; the other leaves share storage)."""

    def stacked(layers) -> dict:
        names = [name for name, _ in layers[0].named_parameters()]
        return {name: torch.stack([getattr(w, name).detach() for w in layers])
                for name in names}

    tree: dict = {name: t.detach() for name, t in params.named_parameters(recurse=False)}
    if isinstance(params, HybridParams):
        tree["mamba"] = {name: t.unflatten(0, params.groups)
                         for name, t in stacked(params.layers).items()}
        tree["shared"] = {name: t.detach() for name, t in params.shared.named_parameters()}
    else:
        for stack in params.STACKS:
            tree[stack] = stacked(getattr(params, stack))
    return tree
