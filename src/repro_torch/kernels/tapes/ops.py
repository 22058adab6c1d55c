"""Public wrapper of the ``tapes`` kernel, and the layout it reads and writes.

:func:`columns_op` takes one shard's request columns as one ``(3, n)``
int64 tensor (rows :data:`INPUTS`, arrival order) and returns the event
tape's per-stream columns that depend on every request (the SSD wall and
the anchors) as one ``(len(COLUMNS), ceil(n / stream_len))`` float64
tensor on the same device (rows :data:`COLUMNS`; ``csrc/tapes.cu`` mirrors
both tuples and :data:`CONSTS` in its enums and struct, and the CPU tests
parse and compare them).  The tape's other anchor columns are not the
kernel's: ``hddt_0`` comes from the stream scores, ``hddt_16`` and
``pf_0`` are 0.

On CUDA tensors it launches the hand-written kernel once on the current
stream (a block a stream, then the merge rounds of the shard's global
order, then the merge counts, one cooperative launch) with a ``(2, n)``
int32 scratch, and raises if it cannot be built or launched or does not
take the shape (:func:`takes`); on CPU tensors it runs the plain NumPy
version (:mod:`repro_torch.kernels.tapes.ref`), which takes any stream
length.  The two are equal bit for bit.  There is no fallback from the
card to the plain version.  The tracer's counter ``launch.tapes`` counts
launches (:mod:`repro_torch.tracing`).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ... import tracing
from . import ref
from .ref import COLUMNS, CONSTS, INPUTS

#: The longest stream the kernel takes: a block keeps a whole stream, five
#: arrays of it, in shared memory.
MAX_STREAM_LEN = 8192
#: The most requests a shard may have: the kernel indexes them in int32.
MAX_REQUESTS = (1 << 31) - 1


def takes(n: int, stream_len: int) -> bool:
    """Whether the kernel takes a shard of ``n`` requests cut into streams
    of ``stream_len``: not an empty one, nor streams above its limit."""

    return 1 <= n <= MAX_REQUESTS and 1 <= stream_len <= MAX_STREAM_LEN


def _check(cols: torch.Tensor, stream_len: int, consts: Sequence[float]) -> None:
    if not isinstance(cols, torch.Tensor) or cols.dim() != 2 or cols.shape[0] != len(INPUTS):
        raise ValueError(f"cols must be a ({len(INPUTS)}, n) tensor: rows {INPUTS}")
    if cols.dtype != torch.int64:
        raise TypeError(f"cols must be int64, got {cols.dtype}")
    if not cols.is_contiguous():
        raise ValueError("cols must be contiguous")
    n = cols.shape[1]
    if n < 1 or stream_len < 1:
        raise ValueError(f"need a request and streams of at least 1, got {n} and {stream_len}")
    if cols.device.type == "cuda" and not takes(n, stream_len):
        raise ValueError(f"the kernel takes 1..{MAX_REQUESTS} requests in streams of "
                         f"1..{MAX_STREAM_LEN}, got {n} and {stream_len}")
    if len(consts) != len(CONSTS):
        raise ValueError(f"need the {len(CONSTS)} constants {CONSTS}, got {len(consts)}")


def _launch(cols: torch.Tensor, stream_len: int, consts: Sequence[float]) -> torch.Tensor:
    from .kernel import load  # builds with nvcc on first use

    n = cols.shape[1]
    dev = cols.device
    runs = torch.empty(2, n, dtype=torch.int32, device=dev)
    out = torch.empty(len(COLUMNS), -(-n // stream_len), dtype=torch.float64, device=dev)
    lib = load()
    with torch.cuda.device(dev):
        err = lib.tapes_launch(cols.data_ptr(), n, stream_len, runs.data_ptr(),
                               out.data_ptr(), *(float(v) for v in consts),
                               torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tapes kernel launch failed: cudaError {err}")
    tracing.count("launch.tapes")
    return out


def columns_op(cols: torch.Tensor, stream_len: int, consts: Sequence[float]) -> torch.Tensor:
    """The :data:`COLUMNS` of every stream of the shard ``cols`` (rows
    :data:`INPUTS`), ``consts`` the :data:`CONSTS` in order; returns the
    ``(len(COLUMNS), streams)`` float64 tensor on ``cols``' device."""

    _check(cols, stream_len, consts)
    if cols.device.type == "cpu":
        return torch.from_numpy(ref.columns(cols.numpy(), stream_len, *consts))
    if cols.device.type == "cuda":
        return _launch(cols, stream_len, consts)
    raise ValueError(f"no tapes kernel for device {cols.device}")
