"""AVL-tree metadata index for the log-structured buffer (paper Section 2.5).

Each fast-tier file keeps one AVL tree.  A node stores the *original* extent
(offset, size in the backing file) and the *new* extent (offset in the
append-only log).  Nodes are keyed by original offset, so an in-order
traversal enumerates the buffered data in backing-file order — exactly the
order in which the flusher wants to write it to the slow tier (sequential
flush without a separate sort phase).

The paper budgets 24 bytes/node (3 × 8 B values) ≈ 3 MB for 40 GB of 256 KB
requests; :meth:`AVLTree.approx_bytes` mirrors that accounting and the
overhead benchmark (paper Table 1) reads it.

Self-balancing is the textbook height-balanced AVL with single/double
rotations.  The port's copy of the reference's tree; ``tests/test_torch_structures.py``
holds it against the reference under random operation sequences.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


NODE_BYTES = 24  # paper Section 2.5: 3 values x 8 bytes


@dataclasses.dataclass(slots=True)
class _Node:
    key: int  # original offset
    size: int
    log_offset: int  # position in the fast-tier log
    left: "_Node | None" = None
    right: "_Node | None" = None
    height: int = 1


def _h(n: _Node | None) -> int:
    return n.height if n is not None else 0


def _update(n: _Node) -> None:
    n.height = 1 + max(_h(n.left), _h(n.right))


def _balance(n: _Node) -> int:
    return _h(n.left) - _h(n.right)


def _rot_right(y: _Node) -> _Node:
    x = y.left
    if x is None:
        raise RuntimeError("right rotation on a node with no left child")
    y.left, x.right = x.right, y
    _update(y)
    _update(x)
    return x


def _rot_left(x: _Node) -> _Node:
    y = x.right
    if y is None:
        raise RuntimeError("left rotation on a node with no right child")
    x.right, y.left = y.left, x
    _update(x)
    _update(y)
    return y


def _rebalance(n: _Node) -> _Node:
    _update(n)
    b = _balance(n)
    if b > 1:
        if n.left is None:
            raise RuntimeError("left-heavy node with no left child")
        if _balance(n.left) < 0:  # LR
            n.left = _rot_left(n.left)
        return _rot_right(n)
    if b < -1:
        if n.right is None:
            raise RuntimeError("right-heavy node with no right child")
        if _balance(n.right) > 0:  # RL
            n.right = _rot_right(n.right)
        return _rot_left(n)
    return n


@dataclasses.dataclass(frozen=True, slots=True)
class Extent:
    """One buffered extent: original offset -> log offset."""

    offset: int
    size: int
    log_offset: int

    @property
    def end(self) -> int:
        return self.offset + self.size


class AVLTree:
    """Height-balanced index from original offset to log extent."""

    def __init__(self) -> None:
        self._root: _Node | None = None
        self._count = 0

    def __len__(self) -> int:
        return self._count

    # -- mutation --------------------------------------------------------
    def insert_batch(self, offsets, sizes, log_offsets) -> None:
        """Insert many extents in array order (pointer-chasing loop).

        Interface shared with :class:`repro_torch.core.extent_index.ExtentIndex`
        so :class:`repro_torch.core.log_store.LogRegion` can drive either backend
        from its batched append path; here it is just the scalar insert in
        a loop — the AVL stays the bit-exact *oracle*, not the fast path.
        """

        for off, size, log_off in zip(offsets, sizes, log_offsets):
            self.insert(int(off), int(size), int(log_off))

    def insert(self, offset: int, size: int, log_offset: int) -> None:
        """Insert an extent.  Re-writes of the same original offset replace
        the mapping (latest log copy wins — log-structured semantics)."""

        def rec(n: _Node | None) -> _Node:
            if n is None:
                self._count += 1
                return _Node(offset, size, log_offset)
            if offset < n.key:
                n.left = rec(n.left)
            elif offset > n.key:
                n.right = rec(n.right)
            else:  # same original offset: newest version supersedes
                n.size = size
                n.log_offset = log_offset
                return n
            return _rebalance(n)

        self._root = rec(self._root)

    def clear(self) -> None:
        self._root = None
        self._count = 0

    # -- queries ---------------------------------------------------------
    def lookup(self, offset: int) -> Extent | None:
        n = self._root
        while n is not None:
            if offset < n.key:
                n = n.left
            elif offset > n.key:
                n = n.right
            else:
                return Extent(n.key, n.size, n.log_offset)
        return None

    def in_order(self) -> Iterator[Extent]:
        """Extents in original-offset order — the sequential flush order."""

        stack: list[_Node] = []
        n = self._root
        while stack or n is not None:
            while n is not None:
                stack.append(n)
                n = n.left
            n = stack.pop()
            yield Extent(n.key, n.size, n.log_offset)
            n = n.right

    def in_order_arrays(self):
        """``(offsets, sizes, log_offsets)`` int64 arrays of the live
        extents in ascending-offset order — same contract as
        :meth:`repro_torch.core.extent_index.ExtentIndex.in_order_arrays` (here
        materialized from the in-order traversal)."""

        offs = np.empty(self._count, dtype=np.int64)
        szs = np.empty(self._count, dtype=np.int64)
        logs = np.empty(self._count, dtype=np.int64)
        for i, ext in enumerate(self.in_order()):
            offs[i] = ext.offset
            szs[i] = ext.size
            logs[i] = ext.log_offset
        return offs, szs, logs

    def min_key(self) -> int | None:
        n = self._root
        if n is None:
            return None
        while n.left is not None:
            n = n.left
        return n.key

    def max_key(self) -> int | None:
        n = self._root
        if n is None:
            return None
        while n.right is not None:
            n = n.right
        return n.key

    @property
    def height(self) -> int:
        return _h(self._root)

    def approx_bytes(self) -> int:
        """Metadata footprint under the paper's 24 B/node accounting."""

        return self._count * NODE_BYTES

    # -- invariants (exercised by property tests) -------------------------
    def check_invariants(self) -> None:
        """Raises AssertionError if AVL balance/order/height break anywhere."""

        def rec(n: _Node | None, lo: int | None, hi: int | None) -> int:
            if n is None:
                return 0
            if not (lo is None or n.key > lo):
                raise AssertionError("BST order violated (left)")
            if not (hi is None or n.key < hi):
                raise AssertionError("BST order violated (right)")
            hl = rec(n.left, lo, n.key)
            hr = rec(n.right, n.key, hi)
            if abs(hl - hr) > 1:
                raise AssertionError(f"AVL balance violated at key {n.key}")
            if n.height != 1 + max(hl, hr):
                raise AssertionError("stale height")
            return n.height

        total = rec(self._root, None, None)
        if total != self.height:
            raise AssertionError("root height disagrees with recursion")
        if sum(1 for _ in self.in_order()) != self._count:
            raise AssertionError("node count disagrees with in-order walk")
