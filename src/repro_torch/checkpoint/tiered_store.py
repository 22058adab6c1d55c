"""Tiered checkpoint storage through the SSDUP+ burst buffer.

The port's copy of the reference's store, host code only.  Each host routes
its shard writes through a :class:`~repro_torch.core.burst_buffer.BurstBufferWriter`:
sequential shard bodies stream straight to the slow tier, while interleaved
small-extent traffic is absorbed by the fast tier's log and flushed
sequentially in AVL order.

Format: one ``<step>/file_<id>.bin`` data file per host per checkpoint step
and a JSON manifest with per-leaf (path, offset, size, dtype, shape)
records.  Leaves are written at deterministic offsets so a restore can read
any subset.  Leaves are NumPy arrays (or anything ``np.asarray`` takes) or
torch tensors.  A bfloat16 leaf (a torch tensor, or an ``ml_dtypes`` array
from the reference) is written as its bits, the manifest's ``dtype``
``"bfloat16"`` as the reference writes it, and loaded as a
``torch.bfloat16`` tensor: neither direction needs ``ml_dtypes``, which
ships with JAX.  Other leaves load as NumPy arrays.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from ..core.burst_buffer import BurstBufferWriter

Tree = Any
BF16 = "bfloat16"


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """The array whose bytes are written, and the manifest's dtype name."""

    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _flatten(tree: Tree, prefix: str = "") -> list[tuple[str, np.ndarray, str]]:
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.extend(_flatten(tree[k], f"{prefix}/{k}" if prefix else k))
    else:
        out.append((prefix, *_host_array(tree)))
    return out


def _unflatten(records: dict[str, np.ndarray]) -> Tree:
    root: Tree = {}
    for path, val in records.items():
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


@dataclasses.dataclass(frozen=True)
class LeafRecord:
    path: str
    offset: int
    nbytes: int
    dtype: str
    shape: tuple[int, ...]


class TieredCheckpointStore:
    """Write/read checkpoints through the burst buffer on one host."""

    def __init__(self, root: str, host_id: int = 0,
                 fast_dir: str | None = None,
                 region_bytes: int = 64 << 20,
                 traffic_aware: bool = True,
                 stream_len: int = 32):
        self.root = root
        self.host_id = host_id
        self.fast_dir = fast_dir or os.path.join(root, f"_burst_host{host_id}")
        self.region_bytes = region_bytes
        self.traffic_aware = traffic_aware
        # checkpoint streams are short relative to IOR traces; a 32-request
        # window keeps the detector responsive for MiB-scale dumps
        self.stream_len = stream_len
        os.makedirs(root, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Tree, file_id: int | None = None,
             writers: int = 1, chunk: int = 1 << 20) -> dict:
        """Write one host's shard tree; returns burst-buffer stats.

        ``writers > 1`` emulates concurrent leaf writers: chunks are issued
        round-robin across ``writers`` leaf groups (server-side run-count
        randomness ~ writers/window).  ``writers == -1`` emulates the
        heavy-contention limit the paper measures at the I/O node (Fig. 3d:
        offsets effectively unordered) by shuffling the chunk arrival order
        outright — the detector must absorb nearly everything through the
        fast-tier log and the AVL-ordered flush must still reassemble every
        extent bit-exactly.
        """

        step_dir = os.path.join(self.root, f"step_{step:08d}")
        os.makedirs(step_dir, exist_ok=True)
        bb = BurstBufferWriter(
            fast_dir=self.fast_dir,
            slow_dir=step_dir,
            region_bytes=self.region_bytes,
            traffic_aware=self.traffic_aware,
            stream_len=self.stream_len,
        )
        fid = self.host_id if file_id is None else file_id
        leaves = _flatten(tree)
        manifest: list[dict] = []
        off = 0
        queues: list[list[tuple[int, bytes]]] = [[] for _ in range(max(writers, 1))]
        for i, (path, arr, dtype) in enumerate(leaves):
            data = np.ascontiguousarray(arr).tobytes()
            for lo in range(0, len(data), chunk):
                queues[i % max(writers, 1)].append(
                    (off + lo, data[lo: lo + chunk]))
            manifest.append(dataclasses.asdict(LeafRecord(
                path=path, offset=off, nbytes=len(data),
                dtype=dtype, shape=tuple(arr.shape))))
            off += len(data)
        try:
            if writers == -1:
                flat = [item for q in queues for item in q]
                rng = np.random.default_rng(step)
                for idx in rng.permutation(len(flat)):
                    o, d = flat[idx]
                    bb.write(fid, o, d)
            else:
                live = [q for q in queues if q]
                cursors = [0] * len(live)
                while any(c < len(q) for c, q in zip(cursors, live)):
                    for wi, q in enumerate(live):
                        if cursors[wi] < len(q):
                            o, d = q[cursors[wi]]
                            bb.write(fid, o, d)
                            cursors[wi] += 1
            bb.drain()
            stats = bb.stats()
        finally:
            bb.close()
        man_path = os.path.join(step_dir, f"host{self.host_id}.manifest.json")
        with open(man_path + ".tmp", "w") as f:
            json.dump({
                "step": step,
                "host": self.host_id,
                "file_id": fid,
                "data_file": f"file_{fid}.bin",
                "leaves": manifest,
                "bb_stats": stats,
            }, f)
        os.replace(man_path + ".tmp", man_path)  # commit point
        return stats

    # -- load ---------------------------------------------------------------
    def manifest_path(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}",
                            f"host{self.host_id}.manifest.json")

    def load(self, step: int, only_paths: set[str] | None = None) -> Tree:
        with open(self.manifest_path(step)) as f:
            man = json.load(f)
        data_path = os.path.join(self.root, f"step_{step:08d}", man["data_file"])
        records: dict[str, np.ndarray | torch.Tensor] = {}
        with open(data_path, "rb") as f:
            for leaf in man["leaves"]:
                if only_paths is not None and leaf["path"] not in only_paths:
                    continue
                f.seek(leaf["offset"])
                buf = f.read(leaf["nbytes"])
                if leaf["dtype"] == BF16:
                    bits = np.frombuffer(buf, dtype=np.int16).reshape(leaf["shape"])
                    arr = torch.from_numpy(bits.copy()).view(torch.bfloat16)
                else:
                    arr = np.frombuffer(buf, dtype=leaf["dtype"]).reshape(leaf["shape"])
                records[leaf["path"]] = arr
        return _unflatten(records)

    def latest_step(self) -> int | None:
        """Newest step with a committed manifest (restart entry point)."""

        if not os.path.isdir(self.root):
            return None
        best = None
        for name in os.listdir(self.root):
            if not name.startswith("step_"):
                continue
            step = int(name.split("_")[1])
            if os.path.exists(self.manifest_path(step)):
                best = step if best is None else max(best, step)
        return best
