"""Vectorized extent index — the NumPy counterpart of :class:`AVLTree`.

The paper's flush path (Section 2.5) needs three things from the per-file
metadata index: the *latest* log copy of every written offset, those live
extents in ascending-offset order (the sequential flush order), and point
lookups for read-your-writes.  The AVL tree gives all three at
O(log n)/insert — but the simulator's replay loop pays that cost in
*Python*, one pointer-chasing ``insert`` per request, which caps traces at
~10⁵ requests.

:class:`ExtentIndex` stores the same mapping as flat append-only arrays
and defers all ordering work to one vectorized pass:

* ``insert``/``insert_batch`` append to O(1)-amortized columnar buffers —
  no comparisons, no rebalancing, no per-request Python in the batch path;
* a *compaction* (stable ``argsort`` by offset + last-of-run selection,
  i.e. lexsort-style latest-version dedup) runs lazily on first query and
  is cached until the next insert;
* ``in_order`` / ``in_order_arrays`` / ``lookup`` / ``__len__`` /
  ``approx_bytes`` are bit-for-bit equivalent to the AVL tree's answers
  (property-checked against the tree in the tests), so
  :class:`repro_torch.core.log_store.LogRegion` can swap backends via its
  ``index_backend`` switch without perturbing a single simulator output.

Cost model: n inserts + one compaction is O(n log n) in C versus the
AVL's O(n log n) in Python.  The metadata accounting mirrors the
paper's 24 B/node budget on *live* (deduplicated) extents, matching
``AVLTree.approx_bytes``.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from .avl import NODE_BYTES, Extent


class ColumnarAppender:
    """Append-only columnar row buffer shared by the vectorized stores.

    Scalar rows buffer into a plain Python list; batch rows land as
    ready-made int64 array chunks.  The pending rows are sealed into a
    chunk before every batch append and before every read, so chunk
    order IS arrival order regardless of how scalar and batch appends
    interleave.  Used by :class:`ExtentIndex` (3 columns) and
    :class:`repro_torch.core.log_store.LogRegion`'s record log (4 columns).
    """

    __slots__ = ("_ncols", "_pend", "_chunks", "_count")

    def __init__(self, ncols: int) -> None:
        self._ncols = ncols
        self._pend: list[tuple[int, ...]] = []
        self._chunks: list[tuple[np.ndarray, ...]] = []
        self._count = 0

    def __len__(self) -> int:
        return self._count

    def append_row(self, row: tuple[int, ...]) -> None:
        self._pend.append(row)
        self._count += 1

    def append_chunk(self, *cols: np.ndarray) -> None:
        """Append many rows given as parallel columns (arrival order =
        array order)."""

        n = len(cols[0])
        if n == 0:
            return
        self._seal()
        self._chunks.append(
            tuple(np.asarray(c, dtype=np.int64) for c in cols)
        )
        self._count += n

    def _seal(self) -> None:
        if self._pend:
            cols = np.asarray(self._pend, dtype=np.int64).T
            self._chunks.append(tuple(cols[i] for i in range(self._ncols)))
            self._pend.clear()

    def columns(self) -> tuple[np.ndarray, ...]:
        """All rows as parallel int64 columns, in arrival order; chunks
        are consolidated once and the result reused until the next
        append."""

        self._seal()
        if not self._chunks:
            return tuple(
                np.zeros(0, dtype=np.int64) for _ in range(self._ncols)
            )
        if len(self._chunks) > 1:
            self._chunks = [tuple(
                np.concatenate([c[i] for c in self._chunks])
                for i in range(self._ncols)
            )]
        return self._chunks[0]

    def last_row(self) -> tuple[int, ...] | None:
        if self._pend:
            return tuple(int(v) for v in self._pend[-1])
        if self._chunks:
            return tuple(int(col[-1]) for col in self._chunks[-1])
        return None

    def clear(self) -> None:
        self._pend.clear()
        self._chunks.clear()
        self._count = 0


class ExtentIndex:
    """Append-only columnar index from original offset to log extent.

    Drop-in alternative to :class:`repro_torch.core.avl.AVLTree`: same insert
    semantics (re-writes of an offset supersede — latest log copy wins),
    same query surface, vectorized internals.
    """

    __slots__ = ("_rows", "_compact")

    def __init__(self) -> None:
        self._rows = ColumnarAppender(3)  # (offset, size, log_offset)
        # cached compaction: (offsets, sizes, log_offsets) — live extents
        # in ascending-offset order
        self._compact: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None

    # -- mutation --------------------------------------------------------
    def insert(self, offset: int, size: int, log_offset: int) -> None:
        """Record one extent; latest version of an offset supersedes."""

        self._rows.append_row((offset, size, log_offset))
        self._compact = None

    def insert_batch(
        self,
        offsets: np.ndarray,
        sizes: np.ndarray,
        log_offsets: np.ndarray,
    ) -> None:
        """Record many extents at once (arrival order = array order)."""

        self._rows.append_chunk(offsets, sizes, log_offsets)
        self._compact = None

    def clear(self) -> None:
        self._rows.clear()
        self._compact = None

    # -- compaction ------------------------------------------------------
    def _compacted(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self._compact is not None:
            return self._compact
        offs, szs, logs = self._rows.columns()
        if not len(offs):
            self._compact = (offs, szs, logs)
            return self._compact
        # stable sort by offset keeps arrival order inside equal-offset
        # runs; the LAST entry of each run is the live (latest) version.
        order = np.argsort(offs, kind="stable")
        so = offs[order]
        last = np.empty(len(so), dtype=bool)
        last[:-1] = so[1:] != so[:-1]
        last[-1] = True
        keep = order[last]
        self._compact = (so[last], szs[keep], logs[keep])
        return self._compact

    # -- queries ---------------------------------------------------------
    def __len__(self) -> int:
        return int(self._compacted()[0].shape[0])

    def lookup(self, offset: int) -> Extent | None:
        offs, szs, logs = self._compacted()
        i = int(np.searchsorted(offs, offset))
        if i < len(offs) and int(offs[i]) == offset:
            return Extent(offset, int(szs[i]), int(logs[i]))
        return None

    def in_order(self) -> Iterator[Extent]:
        """Live extents in ascending original-offset order (flush order)."""

        offs, szs, logs = self._compacted()
        for i in range(len(offs)):
            yield Extent(int(offs[i]), int(szs[i]), int(logs[i]))

    def in_order_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(offsets, sizes, log_offsets)`` of the live extents, sorted —
        the zero-Python view the batched flush accounting consumes."""

        return self._compacted()

    def min_key(self) -> int | None:
        offs = self._compacted()[0]
        return int(offs[0]) if len(offs) else None

    def max_key(self) -> int | None:
        offs = self._compacted()[0]
        return int(offs[-1]) if len(offs) else None

    def approx_bytes(self) -> int:
        """Paper's 24 B/node metadata accounting (live extents only)."""

        return len(self) * NODE_BYTES

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ExtentIndex(live={len(self)})"


INDEX_BACKENDS = ("avl", "numpy")


def make_index(backend: str):
    """Index factory behind ``LogRegion``'s ``index_backend`` switch."""

    if backend == "numpy":
        return ExtentIndex()
    if backend == "avl":
        from .avl import AVLTree

        return AVLTree()
    raise ValueError(
        f"index_backend must be one of {INDEX_BACKENDS}, got {backend!r}"
    )
