"""Carry configs and weights from the reference package to the port.

Both take the reference's objects by duck type (a dataclass config, a
nested dict of arrays), so the port imports nothing of it.  With these the
two packages compute the same thing on the same weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig
from . import mamba, transformer
from .params import ModelParams, leaf_name

_IMPLS = {"pallas": "kernel", "xla": "torch"}
_FAMILY_MODULES = {"dense": transformer, "ssm": mamba}


def config_from_jax(cfg) -> ModelConfig:
    """The reference's ``ModelConfig`` as the port's: every field carried,
    ``"pallas"`` -> ``"kernel"`` and ``"xla"`` -> ``"torch"``."""

    fields = dataclasses.asdict(cfg)
    for key in ("attention_impl", "ssm_impl"):
        fields[key] = _IMPLS[fields[key]]
    return ModelConfig(**fields)


def _tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: carry the bits
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr).copy())


def params_from_jax(cfg: ModelConfig, tree: dict, device="cpu") -> ModelParams:
    """The reference's parameter tree (arrays, per-layer leaves stacked on
    L) as the port's parameters, bit for bit, in the tree's dtypes."""

    tensors = {k: _tensor(v) for k, v in tree.items() if k != "layers"}
    tensors.update({k: _tensor(v) for k, v in tree["layers"].items()})
    mod = _FAMILY_MODULES[cfg.family]
    params = mod.empty_params(cfg, device, lambda name: tensors[name].dtype)
    with torch.no_grad():
        for name, t in params.named_parameters():
            src = tensors[leaf_name(name)]
            if name.startswith("layers."):
                src = src[int(name.split(".")[1])]
            if src.shape != t.shape:
                raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(t.shape)}")
            t.copy_(src)
    return params
