"""Production burst-buffer facade: SSDUP+ applied to real bytes.

This is the piece the *framework* uses (checkpoint writes, data-pipeline
spill): a per-host writer that routes write requests between a fast tier
(local burst directory — NVMe/tmpfs) and a slow tier (the shared filesystem
directory), using the paper's full machinery:

* request-stream grouping + random-factor scoring  (``random_factor``)
* adaptive threshold                               (``adaptive``)
* redirection state machine                        (``redirector``)
* two-region log-structured fast tier + AVL index  (``pipeline``/``log_store``)
* background flusher with traffic-aware pausing    (this module)

Unlike :mod:`repro_torch.core.simulator` (timing model for the paper-validation
benchmarks) this module moves actual payload bytes and guarantees
read-your-writes: ``read()`` consults the active region, then the flushing
region, then the slow tier.  ``drain()`` forces all buffered data down to the
slow tier (used before checkpoint manifests are committed).

The port's copy of the reference's writer: host code (files, NumPy and one
flusher thread) over the port's ``pipeline``, ``redirector`` and
``adaptive``; it launches nothing on a device.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable

from .adaptive import AdaptiveThreshold
from .pipeline import TwoRegionPipeline
from .random_factor import DEFAULT_STREAM_LEN, Request
from .redirector import DataRedirector, Device


class BurstBufferWriter:
    """Write-path facade over a fast-tier directory and a slow-tier directory."""

    def __init__(
        self,
        fast_dir: str,
        slow_dir: str,
        region_bytes: int = 64 << 20,
        stream_len: int = DEFAULT_STREAM_LEN,
        traffic_aware: bool = True,
        flush_gate: float = 0.5,
        adaptive_window: int | None = 64,
        flush_poll_seconds: float = 0.002,
        flush_chunk_bytes: int = 4 << 20,
        index_backend: str = "avl",
    ):
        os.makedirs(fast_dir, exist_ok=True)
        os.makedirs(slow_dir, exist_ok=True)
        self.fast_dir = fast_dir
        self.slow_dir = slow_dir
        self._lock = threading.RLock()
        self._last_pct = 0.0
        # AVL by default: this path interleaves inserts with point lookups
        # (read-your-writes) under the writer lock, where the AVL's
        # incremental O(log n) beats ExtentIndex's recompaction-per-read;
        # the columnar index is for the replay engine's insert-many-then-
        # flush pattern.
        self.pipeline = TwoRegionPipeline(
            region_bytes,
            traffic_aware=traffic_aware,
            flush_gate=flush_gate,
            percentage_source=lambda: self._last_pct,
            index_backend=index_backend,
        )
        self.redirector = DataRedirector(
            AdaptiveThreshold(window=adaptive_window), stream_len
        )
        self._region_files = [
            open(os.path.join(fast_dir, f"region{i}.log"), "w+b") for i in range(2)
        ]
        self._slow_files: dict[int, object] = {}
        self._pending: list[tuple[Request, bytes]] = []
        self._flush_chunk = flush_chunk_bytes
        self._poll = flush_poll_seconds
        self._stop = threading.Event()
        self._flusher = threading.Thread(
            target=self._flush_loop, name="ssdup-flusher", daemon=True
        )
        self._flusher.start()
        # stats
        self.bytes_fast = 0
        self.bytes_slow_direct = 0
        self.flush_stalls = 0

    # -- public API --------------------------------------------------------
    def write(self, file_id: int, offset: int, data: bytes) -> None:
        """Submit one write request.  Routing happens at stream granularity;
        requests buffer host-side until their stream's decision is known
        (the paper's one-stream decision lag)."""

        req = Request(offset=offset, size=len(data), file_id=file_id,
                      time=time.monotonic())
        with self._lock:
            self._pending.append((req, data))
            full = self.redirector.grouper.push(req)
            if full is not None:
                self._dispatch_stream(full)

    def read(self, file_id: int, offset: int, size: int) -> bytes:
        """Read-your-writes across tiers (fast regions first, newest wins)."""

        with self._lock:
            for region, fobj in self._regions_newest_first():
                tree = region.trees.get(file_id)
                if tree is None:
                    continue
                ext = tree.lookup(offset)
                if ext is not None and ext.size >= size:
                    fobj.seek(ext.log_offset)
                    return fobj.read(size)
        f = self._slow_file(file_id)
        with self._lock:
            f.seek(offset)
            return f.read(size)

    def drain(self, timeout: float = 120.0) -> None:
        """Flush the residual stream and force everything to the slow tier."""

        with self._lock:
            tail = self.redirector.grouper.flush()
            if tail is not None:
                self._dispatch_stream(tail)
            self.pipeline.drain()
            self.pipeline.force_flush()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self.pipeline.flush_job is None and self.pipeline.buffered_bytes == 0:
                    for f in self._slow_files.values():
                        f.flush()
                    return
                self.pipeline.force_flush()
            time.sleep(self._poll)
        raise TimeoutError("burst buffer drain timed out")

    def close(self) -> None:
        self.drain()
        self._stop.set()
        self._flusher.join(timeout=10)
        for f in self._region_files:
            f.close()
        for f in self._slow_files.values():
            f.close()

    # -- stream dispatch -----------------------------------------------------
    def _dispatch_stream(self, stream: list[Request]) -> None:
        """Route one completed stream; move its payloads to the chosen tier."""

        routed = self.redirector.route_stream(stream)
        self._last_pct = routed.percentage
        stream_set = {id(r) for r in stream}
        batch = [(r, d) for r, d in self._pending if id(r) in stream_set]
        self._pending = [(r, d) for r, d in self._pending if id(r) not in stream_set]

        if routed.device is Device.SSD:
            for req, data in batch:
                self._append_fast(req, data)
        else:
            for req, data in batch:
                self._write_slow(req.file_id, req.offset, data)
                self.bytes_slow_direct += len(data)

    def _append_fast(self, req: Request, data: bytes) -> None:
        out = self.pipeline.append(req.file_id, req.offset, req.size)
        if out.blocked:
            # both regions full: force + spin until the flusher frees one
            self.flush_stalls += 1
            self.pipeline.force_flush()
            self._lock.release()
            try:
                while True:
                    time.sleep(self._poll)
                    with self._lock:
                        o = self.pipeline.append(req.file_id, req.offset, req.size)
                        if o.ok:
                            out = o
                            break
                        self.pipeline.force_flush()
            finally:
                self._lock.acquire()
        region = self.pipeline.active_region
        rec = region.last_record
        fobj = self._region_files[self.pipeline.active]
        fobj.seek(rec.log_offset)
        fobj.write(data)
        self.bytes_fast += len(data)

    # -- flusher thread ------------------------------------------------------
    def _flush_loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                job = self.pipeline.flush_job
                allowed = self.pipeline.flush_allowed() if job else False
                if job is not None and allowed:
                    region = job.region
                    ridx = self.pipeline.regions.index(region)
                    extents = list(region.flush_order())
                    done = job.bytes_done
                else:
                    extents = []
            if not extents:
                time.sleep(self._poll)
                continue
            # copy extents in AVL (sequential slow-tier) order
            skipped = 0
            for file_id, ext in extents:
                if skipped + ext.size <= done:
                    skipped += ext.size
                    continue
                with self._lock:
                    if self.pipeline.flush_job is None or self.pipeline.flush_job.region is not region:
                        break
                    src = self._region_files[ridx]
                    src.seek(ext.log_offset)
                    payload = src.read(ext.size)
                    self._write_slow(file_id, ext.offset, payload)
                    self.pipeline.flush_progress(ext.size)
                    if not self.pipeline.flush_allowed() and self.pipeline.flush_job is not None:
                        break  # traffic turned sequential: pause politely
                time.sleep(0)  # yield

    # -- helpers -------------------------------------------------------------
    def _regions_newest_first(self):
        order = [self.pipeline.active, 1 - self.pipeline.active]
        for i in order:
            if i < len(self.pipeline.regions):
                yield self.pipeline.regions[i], self._region_files[i]

    def _slow_file(self, file_id: int):
        f = self._slow_files.get(file_id)
        if f is None:
            path = os.path.join(self.slow_dir, f"file_{file_id}.bin")
            mode = "r+b" if os.path.exists(path) else "w+b"
            f = open(path, mode)
            self._slow_files[file_id] = f
        return f

    def _write_slow(self, file_id: int, offset: int, data: bytes) -> None:
        f = self._slow_file(file_id)
        f.seek(offset)
        f.write(data)

    # -- stats ---------------------------------------------------------------
    @property
    def fast_byte_ratio(self) -> float:
        total = self.bytes_fast + self.bytes_slow_direct
        return self.bytes_fast / total if total else 0.0

    def stats(self) -> dict:
        return {
            "bytes_fast": self.bytes_fast,
            "bytes_slow_direct": self.bytes_slow_direct,
            "fast_byte_ratio": self.fast_byte_ratio,
            "flushes_completed": self.pipeline.flushes_completed,
            "flush_stalls": self.flush_stalls,
            "metadata_bytes": self.pipeline.metadata_bytes,
            "threshold": self.redirector.policy.threshold,
        }
