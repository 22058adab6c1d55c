"""Parameters as ``nn.Module``s named by the reference's leaves.

The reference keeps parameters as nested dicts with the per-layer leaves
stacked on a leading L axis.  Here the top-level leaves (``tok_emb``,
``final_norm``, ...) are parameters of :class:`ModelParams` and each layer
is a :class:`Leaves` module in ``ModelParams.layers``, with the same leaf
names (``layers[i].wq`` is the reference's ``params["layers"]["wq"][i]``).
The hybrid family's tree stacks its Mamba leaves on two axes, groups by
layers in a group, and keeps one un-stacked ``"shared"`` block:
:class:`HybridParams` keeps them as a flat ``layers`` list and a ``shared``
module (``layers[i]`` is the reference's ``params["mamba"][...][i // E,
i % E]``), so the flat ``named_parameters()`` names stay unambiguous
(``layers.7.in_proj``, ``shared.wq``).

Parameters are made with ``requires_grad=False``, so serving records no
graph; training turns them on with ``params.requires_grad_()``
(``make_train_step`` does).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

Shapes = dict[str, tuple[int, ...]]


class Leaves(nn.Module):
    def __init__(self, shapes: Shapes, dtype_of_leaf: Callable[[str], torch.dtype],
                 device: torch.device):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype_of_leaf(name), device=device),
                requires_grad=False))


class ModelParams(Leaves):
    """``specs``: the family's ``param_specs`` (leaf -> shape, with the
    per-layer shapes under ``"layers"`` stacked on L)."""

    def __init__(self, specs: dict, dtype_of_leaf: Callable[[str], torch.dtype],
                 device: torch.device):
        super().__init__({k: v for k, v in specs.items() if k != "layers"},
                         dtype_of_leaf, device)
        per_layer = {k: shape[1:] for k, shape in specs["layers"].items()}
        n_layers = next(iter(specs["layers"].values()))[0]
        self.layers = nn.ModuleList(
            Leaves(per_layer, dtype_of_leaf, device) for _ in range(n_layers))


class HybridParams(Leaves):
    """``specs``: the hybrid family's ``param_specs`` (leaf -> shape, with
    the Mamba leaves under ``"mamba"`` stacked on (G, E) and the shared
    attention + MLP leaves under ``"shared"``)."""

    def __init__(self, specs: dict, dtype_of_leaf: Callable[[str], torch.dtype],
                 device: torch.device):
        super().__init__({k: v for k, v in specs.items() if k not in ("mamba", "shared")},
                         dtype_of_leaf, device)
        per_layer = {k: shape[2:] for k, shape in specs["mamba"].items()}
        self.groups = next(iter(specs["mamba"].values()))[:2]  # (G, E)
        self.layers = nn.ModuleList(Leaves(per_layer, dtype_of_leaf, device)
                                    for _ in range(self.groups[0] * self.groups[1]))
        self.shared = Leaves(specs["shared"], dtype_of_leaf, device)


def leaf_name(qualified: str) -> str:
    """``layers.3.wq`` -> ``wq``."""

    return qualified.rsplit(".", 1)[-1]
