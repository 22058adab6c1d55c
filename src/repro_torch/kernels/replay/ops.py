"""Public wrapper of the ``replay`` kernel, and the packed layout it reads.

The replay's inputs are packed on the host into one byte buffer and moved
to the device in one copy (:func:`to_device`).  The buffer holds, each
array row-major:

* ``tape_f64`` ``(len(TAPE_F64), L, S)`` float64, ``tape_i64``
  ``(1, L, S)`` int64 (``nbytes``) and ``tape_u8`` ``(2, L, S)`` uint8
  (``valid``, ``is_gap``): the stacked event tape, each field of one
  lane's events contiguous, so that the kernel copies a lane's events to
  shared memory a stage at a time.  ``S`` is the stacked tape's length
  padded with invalid events to a multiple of :data:`TAPE_ALIGN`, so that
  every copy starts and ends on 16 bytes;
* ``lane_f64`` ``(len(LANE_F64), L)`` and ``lane_i64`` ``(len(LANE_I64),
  L)``: the lane constants (booleans and int32 fields as int64);
* ``state_f64`` ``(len(STATE_F64), L)``, ``state_i64`` ``(len(STATE_I64),
  L)`` and ``win`` ``(L, W)`` float64: the initial lane state.

Each tuple below names its array's rows in order; ``csrc/replay.cu``
mirrors them as enums (the CPU tests parse and compare the two).

:func:`replay_op` replays the first ``steps`` events of every lane and
drains it.  On CUDA tensors it launches the hand-written kernel once on
the current stream and raises if it cannot be built or launched, or if a
lane's region-fill loop ran past :data:`MAX_FILLS` iterations in one
event (where the plain version would never end); on CPU tensors it runs
the plain torch version (:mod:`repro_torch.kernels.replay.ref`).  There is
no fallback from the card to the plain version.  The tracer's counter
``launch.replay`` counts kernel launches (:mod:`repro_torch.tracing`).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from ... import tracing
from . import ref
from .ref import N_WINDOWS, SUFFIX_ANCHORS, XMERGE_D

#: Largest adaptive window the kernel takes: SSDUP+'s threshold pass
#: keeps the window and a chunk of candidates in shared memory.
MAX_WINDOW = 1024
#: Region fills one lane may take in one event before the kernel stops it.
MAX_FILLS = 1 << 20
#: The packed tape's rows hold a multiple of this many events.
TAPE_ALIGN = 16

TAPE_F64 = (
    "gap_sec", "pct", "net_t", "ssd_w", "mean_sz",
    *(f"hddt_{j}" for j in range(SUFFIX_ANCHORS + 1)),
    *(f"pf_{j}" for j in range(SUFFIX_ANCHORS + 1)),
    *(f"wf_{i}" for i in range(N_WINDOWS)),
    *(f"wn_{i}" for i in range(N_WINDOWS)),
    *(f"xm_{d}" for d in range(1, XMERGE_D + 1)),
)
TAPE_I64 = ("nbytes",)
TAPE_U8 = ("valid", "is_gap")
LANE_F64 = ("gate", "ftl_page", "ftl_tpp", "ftl_terase", "ftl_ppb", "ftl_phys",
            "ftl_low", "ftl_high")
LANE_I64 = ("scheme", "cap", "ftl_on")
STATE_F64 = ("clock", "gap", "pause", "blocked", "a_fs",
             *(f"xf_{d}" for d in range(1, XMERGE_D + 1)),
             "j_left", "j_rate", "ftl_free", "ftl_live", "ftl_reloc")
STATE_I64 = ("b_ssd", "b_hdd", "a_used", "s_used", "peak", "flushes", "win_n",
             "win_p", "j_alive", "static_rand", "cur_ssd")
GLOBALS = ("seek_time", "seq_bw", "slowdown", "flush_frac", "default_thr",
           "static_high", "static_low")
OUT_F64 = ("io_seconds", "total_seconds", "flush_paused_seconds", "blocked_seconds",
           "ftl_reloc_pages", "ftl_live_pages")
#: ``status`` is the kernel's own: nonzero where a lane hit MAX_FILLS.
OUT_I64 = ("bytes_to_ssd", "bytes_to_hdd_direct", "flushes", "peak_ssd_occupancy",
           "status")

# the plain version's dtype of each field packed as int64 or uint8
_NARROW = {"scheme": torch.int32, "ftl_on": torch.bool, "flushes": torch.int32,
           "win_n": torch.int32, "win_p": torch.int32, "j_alive": torch.bool,
           "static_rand": torch.bool, "cur_ssd": torch.bool, "valid": torch.bool,
           "is_gap": torch.bool}

@dataclasses.dataclass(frozen=True)
class Packed:
    """Views of one packed buffer (NumPy arrays or tensors of one device)."""

    tape_f64: object
    tape_i64: object
    tape_u8: object
    lane_f64: object
    lane_i64: object
    state_f64: object
    state_i64: object
    win: object


def padded_len(s: int) -> int:
    """The packed tape's length for a stacked tape of ``s`` events."""

    return -(-s // TAPE_ALIGN) * TAPE_ALIGN


def _sections(s: int, l: int, w: int) -> list[tuple[str, np.dtype, tuple, tuple]]:
    """(part, dtype, shape, field names) in buffer order for a packed tape
    of ``s`` events (a multiple of :data:`TAPE_ALIGN`): the tape first, so
    each of its rows starts on 16 bytes, then the other 8-byte parts."""

    f8, i8, u1 = np.dtype(np.float64), np.dtype(np.int64), np.dtype(np.uint8)
    return [("tape_f64", f8, (len(TAPE_F64), l, s), TAPE_F64),
            ("tape_i64", i8, (len(TAPE_I64), l, s), TAPE_I64),
            ("tape_u8", u1, (len(TAPE_U8), l, s), TAPE_U8),
            ("lane_f64", f8, (len(LANE_F64), l), LANE_F64),
            ("state_f64", f8, (len(STATE_F64), l), STATE_F64),
            ("win", f8, (l, w), ()),
            ("lane_i64", i8, (len(LANE_I64), l), LANE_I64),
            ("state_i64", i8, (len(STATE_I64), l), STATE_I64)]


def views(buf, s: int, l: int, w: int) -> Packed:
    """:class:`Packed` views of a packed uint8 buffer (NumPy or torch) whose
    tape holds ``s`` events a lane (a multiple of :data:`TAPE_ALIGN`)."""

    parts, off = {}, 0
    for name, dt, shape, _ in _sections(s, l, w):
        n = dt.itemsize * int(np.prod(shape))
        chunk = buf[off:off + n]
        if isinstance(buf, torch.Tensor):
            parts[name] = chunk.view(getattr(torch, dt.name)).view(shape)
        else:
            parts[name] = chunk.view(dt).reshape(shape)
        off += n
    return Packed(**parts)


def pack(events: Mapping[str, np.ndarray], lanes: Mapping[str, np.ndarray],
         state0: Mapping[str, np.ndarray]) -> tuple[np.ndarray, tuple[int, int, int]]:
    """The stacked ``(S, L)`` tape, ``(L,)`` lane constants and ``(L, ...)``
    initial state (NumPy, as :mod:`repro_torch.core.engine_device` builds
    them) in one uint8 buffer; returns it and ``(padded_len(S), L, W)``.
    The events past ``S`` are invalid and zero."""

    s, l = np.shape(events["valid"])
    w = np.shape(state0["win"])[1]
    sp = padded_len(s)
    size = sum(dt.itemsize * int(np.prod(shape)) for _, dt, shape, _ in _sections(sp, l, w))
    buf = np.empty(size, dtype=np.uint8)
    p = views(buf, sp, l, w)
    for name, _, _, fields in _sections(sp, l, w):
        src = events if name.startswith("tape") else lanes if name.startswith("lane") else state0
        dst = getattr(p, name)
        if name == "win":
            dst[...] = state0["win"]
        for i, k in enumerate(fields):
            if name.startswith("tape"):
                dst[i, :, :s] = np.asarray(src[k]).T
            else:
                dst[i] = src[k]
        if name.startswith("tape") and sp > s:
            dst[:, :, s:] = 0
    return buf, (sp, l, w)


def to_device(events, lanes, state0, device) -> Packed:
    """:func:`pack` and one copy of the buffer to ``device``."""

    buf, shape = pack(events, lanes, state0)
    return views(tracing.to_device(torch.from_numpy(buf), device), *shape)


def unpack(p: Packed) -> tuple[dict, dict, dict]:
    """``(events, lanes, state)`` dicts of tensors with the plain version's
    dtypes and shapes (the events ``(S, L)``, ``S`` the packed length;
    views where the dtype is the packed one)."""

    def fields(arr, names, tape=False):
        out = {}
        for i, k in enumerate(names):
            v = arr[i].T if tape else arr[i]
            out[k] = v.to(_NARROW[k]) if k in _NARROW else v
        return out

    events = {**fields(p.tape_f64, TAPE_F64, True), **fields(p.tape_i64, TAPE_I64, True),
              **fields(p.tape_u8, TAPE_U8, True)}
    lanes = {**fields(p.lane_f64, LANE_F64), **fields(p.lane_i64, LANE_I64)}
    state = {**fields(p.state_f64, STATE_F64), **fields(p.state_i64, STATE_I64),
             "win": p.win}
    return events, lanes, state


def _check(p: Packed, g: Sequence[float], steps: int) -> tuple[int, int, int]:
    if not (isinstance(p.tape_f64, torch.Tensor) and p.tape_f64.dim() == 3
            and isinstance(p.win, torch.Tensor) and p.win.dim() == 2):
        raise ValueError("tape_f64 must be an (F, L, S) tensor and win an (L, W) one")
    _, l, s = p.tape_f64.shape
    w = p.win.shape[1]
    if s % TAPE_ALIGN:
        raise ValueError(f"the packed tape's {s} events a lane must be a multiple of "
                         f"{TAPE_ALIGN}")
    for name, dt, shape, _ in _sections(s, l, w):
        t = getattr(p, name)
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name} must be a tensor")
        if t.dtype != getattr(torch, dt.name):
            raise TypeError(f"{name} must be {dt.name}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} must be {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != p.tape_f64.device:
            raise ValueError("all inputs must be on one device")
    if l < 1 or not 1 <= w <= MAX_WINDOW:
        raise ValueError(f"need at least one lane and a window of 1..{MAX_WINDOW}, "
                         f"got L = {l}, W = {w}")
    if not 0 <= steps <= s:
        raise ValueError(f"steps {steps} outside 0..{s}")
    if len(g) != len(GLOBALS):
        raise ValueError(f"need the {len(GLOBALS)} globals {GLOBALS}, got {len(g)}")
    return s, l, w


def launcher(p: Packed, g: Sequence[float], steps: int):
    """A host call that enqueues one launch of the kernel over ``p`` (CUDA
    tensors, as :func:`replay_op` checks them, on the current device) on
    that device's current stream and raises if the launch is refused.  It
    reads nothing back; its outputs are ``.out_f64`` and ``.out_i64`` (rows
    :data:`OUT_F64`, :data:`OUT_I64`).  Not counted in ``launch.replay``."""

    from .kernel import load  # builds with nvcc on first use

    s, l, w = _check(p, g, steps)
    dev = p.tape_f64.device
    out_f64 = torch.empty(len(OUT_F64), l, dtype=torch.float64, device=dev)
    out_i64 = torch.empty(len(OUT_I64), l, dtype=torch.int64, device=dev)
    lib = load()
    args = (p.tape_f64.data_ptr(), p.tape_i64.data_ptr(), p.tape_u8.data_ptr(),
            p.lane_f64.data_ptr(), p.lane_i64.data_ptr(), p.state_f64.data_ptr(),
            p.state_i64.data_ptr(), p.win.data_ptr(), out_f64.data_ptr(), out_i64.data_ptr(),
            *(float(v) for v in g), s, l, w, steps)

    def launch() -> None:
        err = lib.replay_launch(*args, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"replay kernel launch failed: cudaError {err}")

    launch.out_f64, launch.out_i64 = out_f64, out_i64
    launch.inputs = p  # alive while the pointers are used
    return launch


def _launch(p: Packed, g: Sequence[float], steps: int) -> dict:
    run = launcher(p, g, steps)
    with torch.cuda.device(p.tape_f64.device):
        run()
    tracing.count("launch.replay")
    return {**dict(zip(OUT_F64, run.out_f64)), **dict(zip(OUT_I64, run.out_i64))}


def plain(p: Packed, g: Sequence[float], steps: int) -> dict[str, torch.Tensor]:
    """The plain torch version on the same packed inputs, on their device
    (what :func:`replay_op` runs on the CPU; on the card a yardstick)."""

    events, lanes, state = unpack(p)
    return ref.replay_ref(dict(zip(GLOBALS, g)), lanes, state, events, steps)


def replay_op(p: Packed, g: Sequence[float], steps: int) -> dict[str, torch.Tensor]:
    """Every lane of the packed inputs ``p`` through its first ``steps``
    events, then drained; ``g`` the :data:`GLOBALS` in order.  Returns the
    :data:`ref.OUTPUTS` as tensors on ``p``'s device."""

    _, l, _ = _check(p, g, steps)
    if p.tape_f64.device.type == "cpu":
        # the plain version runs every fill loop to its end: it stops no lane
        out = {**plain(p, g, steps), "status": torch.zeros(l, dtype=torch.int64)}
    elif p.tape_f64.device.type == "cuda":
        out = _launch(p, g, steps)
    else:
        raise ValueError(f"no replay kernel for device {p.tape_f64.device}")
    if bool(tracing.to_host(out.pop("status").any())):
        raise RuntimeError(f"replay kernel: a lane's region fills passed {MAX_FILLS} "
                           "in one event")
    out["flushes"] = out["flushes"].to(torch.int32)
    return {k: out[k] for k in ref.OUTPUTS}
