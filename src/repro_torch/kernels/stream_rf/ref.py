"""Plain torch versions of the ``stream_rf`` kernels.

Semantics are paper Eq. 1 / Eq. 6 over a batch of request streams: sort
each stream's (offset, size) records by offset (ties in arrival order),
then count the sorted-adjacent pairs whose gap is not exactly the lower
record's size, and sum the absolute residuals.  These are what
:mod:`repro_torch.kernels.stream_rf.ops` runs for CPU tensors and what the
CUDA kernel is held against on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.random_factor import stream_stats_batch


def stream_stats_ref(
    offsets: torch.Tensor, sizes: torch.Tensor,
    lengths: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(M, N)`` int64 -> ``(rf (M,) int64, dist (M,) int64)``; row ``i``
    scores its first ``lengths[i]`` requests (all N without ``lengths``)."""

    rf, _, dist = stream_stats_batch(offsets, sizes, lengths)
    return rf, dist


def stream_rf_ref(offsets: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """``(M, N)`` int64 -> rf sums ``(M,)`` int64."""

    return stream_stats_ref(offsets, sizes)[0]


def threshold_quantile_ref(
    percentages: torch.Tensor, avgper: torch.Tensor
) -> torch.Tensor:
    """Adaptive-threshold quantile pick (paper Eq. 2) over a window: sort
    the window, index ``floor((1 - avgper) * W)``, clamp.  ``(M, W)`` ->
    ``(M,)``."""

    w = percentages.shape[-1]
    srt = torch.sort(percentages, dim=-1).values
    idx = torch.clamp(((1.0 - avgper) * w).to(torch.int64), 0, w - 1)
    return torch.gather(srt, -1, idx[..., None])[..., 0]
