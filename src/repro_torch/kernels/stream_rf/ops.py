"""Public wrappers of the ``stream_rf`` kernels.

* :func:`stream_stats_op` — Eq. 1 seek count and Eq. 6 seek distance of
  every row, ``(M, N) -> (rf, pct, dist)``;
* :func:`stream_rf_op` — the count alone, ``(M, N) -> rf``;
* :func:`random_percentage_op` — ``rf / (N - 1)`` in float64.

Rows may be any length N in [2, :data:`MAX_STREAM_LEN`]; an optional
``lengths`` vector of :func:`stream_stats_op` gives each row's true length
(a trace's ragged last stream), and positions beyond it count for nothing.
Above the limit the wrappers raise; score such streams with
``score_backend="numpy"``.

On a CUDA tensor they launch the hand-written kernel
(``csrc/stream_rf.cu``) on the current stream, and raise if it cannot be
built or launched; on a CPU tensor they run the plain torch version
(:mod:`repro_torch.kernels.stream_rf.ref`).  There is no fallback from
the card to the plain version.

The tracer's counters ``launch.stream_stats`` and ``launch.stream_rf``
count the kernel launches of each wrapper (:mod:`repro_torch.tracing`), so
a run can show that its path went through the kernel.
"""

from __future__ import annotations

import torch

from ... import tracing
from . import ref

#: The longest row the kernel scores (its long-row branch keeps a whole row
#: in one block's shared memory).
MAX_STREAM_LEN = 8192


def _checked(offsets: torch.Tensor, sizes, lengths=None):
    """Validate the kernel's contract; returns contiguous int64 ``(M, N)``
    offsets and sizes (sizes broadcast to the offsets' shape) and the
    lengths (``None``, or a contiguous int64 ``(M,)`` tensor)."""

    if not isinstance(offsets, torch.Tensor) or offsets.dim() != 2:
        raise ValueError("offsets must be an (M, N) tensor")
    if offsets.dtype != torch.int64:
        raise TypeError(f"offsets must be int64, got {offsets.dtype}")
    if not offsets.is_contiguous():
        raise ValueError("offsets must be contiguous")
    sizes = torch.as_tensor(sizes, device=offsets.device)
    if sizes.dtype != torch.int64:
        raise TypeError(f"sizes must be int64, got {sizes.dtype}")
    if sizes.device != offsets.device:
        raise ValueError("offsets and sizes must be on one device")
    n = offsets.shape[1]
    if n < 2 or n > MAX_STREAM_LEN:
        raise ValueError(
            f"stream length {n} is outside the kernel's [2, {MAX_STREAM_LEN}]; "
            'score longer streams with score_backend="numpy"'
        )
    if lengths is not None:
        if not isinstance(lengths, torch.Tensor) or lengths.dtype != torch.int64:
            raise TypeError("lengths must be an int64 tensor")
        if lengths.shape != offsets.shape[:1] or lengths.device != offsets.device:
            raise ValueError("lengths must be (M,) on the offsets' device")
        lengths = lengths.contiguous()
    return offsets, sizes.expand(offsets.shape).contiguous(), lengths


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it if its data is not 16-byte aligned (the
    kernel copies rows in 16-byte chunks; fresh allocations are aligned)."""

    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(offs: torch.Tensor, szs: torch.Tensor, lens, with_dist: bool):
    from .kernel import load  # builds with nvcc on first use

    offs, szs = _aligned(offs), _aligned(szs)
    m, n = offs.shape
    rf = torch.empty(m, dtype=torch.int64, device=offs.device)
    dist = torch.empty(m, dtype=torch.int64, device=offs.device) if with_dist else None
    if m == 0:
        return rf, dist
    lib = load()
    with torch.cuda.device(offs.device):
        stream = torch.cuda.current_stream(offs.device).cuda_stream
        err = lib.stream_stats_launch(
            offs.data_ptr(), szs.data_ptr(),
            lens.data_ptr() if lens is not None else None, rf.data_ptr(),
            dist.data_ptr() if with_dist else None, m, n, stream,
        )
    if err != 0:
        raise RuntimeError(f"stream_rf kernel launch failed: cudaError {err}")
    tracing.count("launch.stream_stats" if with_dist else "launch.stream_rf")
    return rf, dist


def _run(offsets, sizes, lengths, with_dist: bool):
    offs, szs, lens = _checked(offsets, sizes, lengths)
    if offs.device.type == "cpu":
        rf, dist = ref.stream_stats_ref(offs, szs, lens)
        return rf, (dist if with_dist else None)
    if offs.device.type == "cuda":
        return _launch(offs, szs, lens, with_dist)
    raise ValueError(f"no stream_rf kernel for device {offs.device}")


def _percentage(rf: torch.Tensor, n: int, lengths) -> torch.Tensor:
    """``rf / (L - 1)`` in float64, ``L`` the true length (0 where L <= 1)."""

    if lengths is None:
        return rf.to(torch.float64) / (n - 1)
    return rf.to(torch.float64) / torch.clamp(lengths.clamp(max=n) - 1, min=1)


def stream_stats_op(
    offsets: torch.Tensor, sizes, lengths: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(M, N)`` int64 -> ``(rf int64, pct float64, dist int64)``, each
    ``(M,)``, bit-equal to the NumPy oracle ``stream_stats_batch_np`` on
    each row's first ``lengths[i]`` requests (all N without ``lengths``)."""

    rf, dist = _run(offsets, sizes, lengths, with_dist=True)
    return rf, _percentage(rf, offsets.shape[1], lengths), dist


def stream_rf_op(offsets: torch.Tensor, sizes) -> torch.Tensor:
    """``(M, N)`` int64 -> Eq. 1 seek counts ``(M,)`` int64."""

    return _run(offsets, sizes, None, with_dist=False)[0]


def random_percentage_op(offsets: torch.Tensor, sizes) -> torch.Tensor:
    """``(M, N)`` int64 -> ``rf / (N - 1)`` ``(M,)`` float64."""

    rf = stream_rf_op(offsets, sizes)
    return rf.to(torch.float64) / (offsets.shape[1] - 1)
