"""Checkpoint manager: asynchronous saves through the burst buffer, and
restore.

The port's copy of the reference's ``Checkpointer``.  The async save is
the paper's two-region pipeline one level up: snapshot N is handed to a
background writer (region A flushing) while training continues and
snapshot N+1 accumulates (region B buffering); the writer pushes the
bytes through the SSDUP+ burst buffer (:mod:`.tiered_store`).  A save is
committed only when its manifest lands, so a torn checkpoint is invisible
to restart.

The snapshot is a copy taken before ``save_async`` returns: a
device-to-host copy of a tensor on the card, a ``clone`` of one on the
CPU (whose ``.cpu()`` would share storage with a parameter that the next
in-place AdamW step overwrites), a copy of a NumPy array.  Trees are
nested dicts; a model's parameters are saved in the reference's layout
(``{"params": tree_from_params(params)}``), so a checkpoint written by
either package loads in the other.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
import time
from typing import Any

import numpy as np
import torch

from .tiered_store import TieredCheckpointStore

Tree = Any


def _map(fn, tree: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _host_copy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.array(leaf))  # a writable copy of the read buffer


class Checkpointer:
    def __init__(self, store: TieredCheckpointStore, keep: int = 3):
        self.store = store
        self.keep = keep
        self._pool = cf.ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="ckpt-writer")
        self._inflight: cf.Future | None = None
        self._lock = threading.Lock()
        self.saves_started = 0
        self.saves_completed = 0
        self.save_seconds: list[float] = []

    # -- save path ----------------------------------------------------------
    def save_async(self, step: int, tree: Tree) -> None:
        """Snapshot to host memory and write in the background.

        Blocks only if the previous save is still in flight (both pipeline
        regions occupied: the paper's 'wait until a region frees up')."""

        self.wait()  # at most one background save (two-region semantics)
        snapshot = _map(_host_copy, tree)
        self.saves_started += 1

        def work():
            t0 = time.time()
            self.store.save(step, snapshot)
            with self._lock:
                self.saves_completed += 1
                self.save_seconds.append(time.time() - t0)

        self._inflight = self._pool.submit(work)

    def save_blocking(self, step: int, tree: Tree) -> None:
        self.save_async(step, tree)
        self.wait()

    def wait(self) -> None:
        if self._inflight is not None:
            self._inflight.result()
            self._inflight = None

    # -- restore path -------------------------------------------------------
    def restore_latest(self, like: Tree | None = None) -> tuple[int, Tree] | None:
        """Load the newest committed checkpoint as CPU tensors; with
        ``like`` (a tree of tensors, meta ones included), each leaf of
        ``like``'s structure cast to its dtype and reshaped to its shape."""

        step = self.store.latest_step()
        if step is None:
            return None
        tree = _map(_as_tensor, self.store.load(step))
        if like is not None:
            def cast(l, v):
                if isinstance(l, dict):
                    return {k: cast(l[k], v[k]) for k in l}
                return v.to(l.dtype).reshape(l.shape)

            tree = cast(like, tree)
        return step, tree

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)
