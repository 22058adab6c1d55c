"""Where the port's entry points run.

Every entry point takes an explicit ``device``.  Left as ``None`` it means
the CUDA card; a machine without one raises instead of quietly running on
the CPU, so a number measured there can never pass for a card's.  Tests
and CPU users pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: "torch.device | str | None") -> torch.device:
    """``None`` -> ``cuda`` (raises :class:`RuntimeError` without a card);
    anything else is taken as given."""

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
