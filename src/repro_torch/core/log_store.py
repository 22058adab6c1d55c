"""Log-structured fast-tier store with a pluggable extent index (§2.5).

Random writes redirected to the fast tier are *appended* to a per-region log
(sequential SSD writes avoid write amplification; paper cites RIPQ), and a
per-backing-file index records ``original offset -> log extent``.  When a
region flushes, an in-order traversal yields the extents in backing-file
order: reads from the log are random, but SSD random reads are ~free, and the
slow-tier writes become sequential — the paper's key asymmetry.

Two index backends implement the same contract (``index_backend``):

* ``"avl"``   — the paper's AVL tree (:class:`repro_torch.core.avl.AVLTree`),
  O(log n) pointer-chasing inserts in Python; the bit-exact oracle.
* ``"numpy"`` — :class:`repro_torch.core.extent_index.ExtentIndex`, append-only
  columnar arrays with one lazy lexsort-style compaction; the fast path
  the batched replay engine rides (the tests check the equivalence).

The write path likewise has two granularities: :meth:`LogRegion.append`
(one request, the control-plane/byte-moving path) and
:meth:`LogRegion.append_batch` (a whole request run as numpy arrays, no
per-request Python — the simulator's hot path).  Record bookkeeping is
columnar either way, so a million-append region never materializes a
million ``LogRecord`` objects unless a caller asks for them.

This module is device-agnostic: it tracks extents and byte accounting.  The
timing of the underlying devices is modeled by ``device_model.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np

from .avl import Extent
from .extent_index import ColumnarAppender, make_index


@dataclasses.dataclass(frozen=True, slots=True)
class LogRecord:
    """One appended record in a region's log."""

    file_id: int
    offset: int  # original offset in the backing file
    size: int
    log_offset: int  # byte position in this region's log


class LogRegion:
    """One append-only region of the fast tier (half of the SSD, §2.4)."""

    def __init__(
        self,
        capacity_bytes: int,
        name: str = "region",
        index_backend: str = "numpy",
    ):
        if capacity_bytes <= 0:
            raise ValueError("capacity must be positive")
        make_index(index_backend)  # eager validation; per-file indexes are lazy
        self.capacity = capacity_bytes
        self.name = name
        self.index_backend = index_backend
        self.tail = 0  # next append position
        # LBA of this region's first byte on the backing SSD; stateful
        # storage models (FTL) address appends as base_lba + log_offset
        self.base_lba = 0
        # arrival-order record log: (file_id, offset, size, log_offset)
        self._rec = ColumnarAppender(4)
        self.trees: dict[int, object] = {}  # one index per backing file
        self.write_payload: Callable[[LogRecord, bytes | None], None] | None = None

    # -- write path -------------------------------------------------------
    def free_bytes(self) -> int:
        return self.capacity - self.tail

    def fits(self, size: int) -> bool:
        return self.tail + size <= self.capacity

    def _index_for(self, file_id: int):
        idx = self.trees.get(file_id)
        if idx is None:
            idx = self.trees[file_id] = make_index(self.index_backend)
        return idx

    def append(self, file_id: int, offset: int, size: int, payload: bytes | None = None) -> LogRecord:
        """Append one request's data to the log and index it."""

        if not self.fits(size):
            raise RegionFullError(
                f"{self.name}: {size} B does not fit ({self.free_bytes()} free)"
            )
        rec = LogRecord(file_id, offset, size, self.tail)
        self.tail += size
        self._rec.append_row((file_id, offset, size, rec.log_offset))
        self._index_for(file_id).insert(offset, size, rec.log_offset)
        if self.write_payload is not None:
            self.write_payload(rec, payload)
        return rec

    def append_batch(
        self,
        file_ids: np.ndarray,
        offsets: np.ndarray,
        sizes: np.ndarray,
    ) -> None:
        """Append a whole request run at once (arrival order = array order).

        Semantically identical to calling :meth:`append` per element, but
        with O(1) Python calls: one columnar record chunk plus one
        ``insert_batch`` per distinct backing file.  Payload-carrying
        regions (``write_payload`` set) must use the scalar path — batches
        carry metadata only.
        """

        n = len(sizes)
        if n == 0:
            return
        if self.write_payload is not None:
            raise RuntimeError(
                f"{self.name}: append_batch carries no payloads; use append()"
            )
        file_ids = np.asarray(file_ids, dtype=np.int64)
        offsets = np.asarray(offsets, dtype=np.int64)
        sizes = np.asarray(sizes, dtype=np.int64)
        csum = np.cumsum(sizes)
        total = int(csum[-1])
        if not self.fits(total):
            raise RegionFullError(
                f"{self.name}: {total} B does not fit ({self.free_bytes()} free)"
            )
        log_offsets = self.tail + csum - sizes
        self.tail += total
        self._rec.append_chunk(file_ids, offsets, sizes, log_offsets)
        # one insert_batch per backing file, arrival order preserved
        # inside each file's run by the stable sort
        if file_ids[0] == file_ids[-1] and not np.any(file_ids != file_ids[0]):
            self._index_for(int(file_ids[0])).insert_batch(
                offsets, sizes, log_offsets
            )
        else:
            order = np.argsort(file_ids, kind="stable")
            sorted_fids = file_ids[order]
            starts = np.concatenate(
                [[0], np.nonzero(sorted_fids[1:] != sorted_fids[:-1])[0] + 1,
                 [n]]
            )
            for a, b in zip(starts[:-1], starts[1:]):
                idx = order[a:b]
                self._index_for(int(sorted_fids[a])).insert_batch(
                    offsets[idx], sizes[idx], log_offsets[idx]
                )

    @property
    def records(self) -> list[LogRecord]:
        """Arrival-order record list, materialized on demand (diagnostics —
        the columnar arrays are the storage format)."""

        fids, offs, szs, logs = self._rec.columns()
        return [
            LogRecord(int(f), int(o), int(s), int(l))
            for f, o, s, l in zip(fids, offs, szs, logs)
        ]

    @property
    def last_record(self) -> LogRecord | None:
        """The most recently appended record (read-your-writes helper)."""

        row = self._rec.last_row()
        return LogRecord(*row) if row is not None else None

    @property
    def num_records(self) -> int:
        return len(self._rec)

    # -- flush path ---------------------------------------------------------
    def flush_order(self) -> Iterator[tuple[int, Extent]]:
        """(file_id, extent) pairs in sequential backing-file order.

        In-order index traversal per file; files are visited in ascending id
        so the slow tier sees one sequential pass per file.
        """

        for file_id in sorted(self.trees):
            for ext in self.trees[file_id].in_order():
                yield file_id, ext

    def flush_arrays(self) -> Iterator[tuple[int, np.ndarray, np.ndarray, np.ndarray]]:
        """Per-file ``(file_id, offsets, sizes, log_offsets)`` in flush
        order — the zero-Python view the batched flush accounting uses."""

        for file_id in sorted(self.trees):
            offs, szs, logs = self.trees[file_id].in_order_arrays()
            yield file_id, offs, szs, logs

    def flush_bytes(self) -> int:
        """Live bytes that a flush would write (latest version per offset)."""

        return sum(int(szs.sum()) for _, _, szs, _ in self.flush_arrays())

    def metadata_bytes(self) -> int:
        return sum(t.approx_bytes() for t in self.trees.values())

    def seek_count_if_unsorted(self) -> int:
        """Seeks the flush would cost WITHOUT the index order (arrival
        order).

        Used by benchmarks to quantify the sorted-flush benefit: arrival
        order vs in-order traversal.
        """

        fids, offs, szs, _ = self._rec.columns()
        if not len(fids):
            return 0
        # group by file (stable keeps arrival order inside each file), then
        # count arrival-adjacent discontinuities per file + 1 initial seek
        order = np.argsort(fids, kind="stable")
        sf, so, ss = fids[order], offs[order], szs[order]
        same_file = sf[1:] == sf[:-1]
        contiguous = so[1:] == so[:-1] + ss[:-1]
        n_files = len(np.unique(sf))
        return n_files + int(np.count_nonzero(same_file & ~contiguous))

    def seek_count_sorted(self) -> int:
        """Seeks of the index-ordered flush (gaps between live extents)."""

        seeks = 0
        for _, offs, szs, _ in self.flush_arrays():
            if len(offs):
                seeks += 1 + int(
                    np.count_nonzero(offs[1:] != offs[:-1] + szs[:-1])
                )
        return seeks

    def reset(self) -> None:
        """Empty the region after a completed flush."""

        self.tail = 0
        self._rec.clear()
        self.trees.clear()

    @property
    def used_bytes(self) -> int:
        return self.tail

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"LogRegion({self.name}, used={self.tail}/{self.capacity}, "
            f"files={len(self.trees)}, records={len(self._rec)})"
        )


class RegionFullError(RuntimeError):
    """Raised when an append exceeds the region capacity."""
