"""The shards on which the ``tapes`` columns are checked, NumPy only, and
how two sets of columns or two tapes are compared.

Shared by the CPU tests (``test_torch_tapes_kernel.py``, against the
kernel's algorithm; ``test_torch_tapes_reference.py``, against the
reference package's tape builder) and the card tests
(``test_torch_on_card.py``, against the kernel).  It imports neither JAX
nor the reference package, so the card machine can load it.
"""

import numpy as np
import torch

from repro_torch.core.device_model import HDDModel, IngestLink, SSDModel
from repro_torch.core.trace import TraceBatch
from repro_torch.core.workloads import ior
from repro_torch.distributed.sharding import assign_nodes
from repro_torch.kernels.tapes import ops

HDD, LINK, SSD = HDDModel(), IngestLink(), SSDModel()
CONSTS = [HDD.seek_time, HDD.seek_dist_coeff, HDD.seq_bw, LINK.bw, SSD.write_bw]
#: A seed past 32 signed bits.
IOR_SEED = 3_000_000_017
#: The SSDUP+ paper's IOR runs on its testbed of 2 I/O nodes: 16 processes
#: write 16 GiB in 256 KiB transfers, sharded by byte range.
IOR_RUN = {"nproc": 16, "total_bytes": 16 << 30, "request_size": 256 << 10}
IOR_NODES = 2

CASES = ("ior-segrandom-2n", "ior-segcontig-2n", "files", "dups", "wide", "partial",
         "len2", "len96", "len2048", "len8192", "gaps", "empty")


def ior_trace(pattern: str) -> TraceBatch:
    """One IOR run of the paper's testbed in ``pattern``, on :data:`IOR_SEED`."""

    return TraceBatch.from_requests(ior(pattern, seed=IOR_SEED, **IOR_RUN).trace)


def _ior_shards(pattern: str) -> list[TraceBatch]:
    batch = ior_trace(pattern)
    node = assign_nodes("range-offset", batch.offsets, batch.file_ids, batch.app_ids,
                        IOR_NODES)
    return batch.shard(node, IOR_NODES)


def _mixed(n: int, seed: int, files: int, dup: bool, gaps: int = 0) -> TraceBatch:
    """Six writers, each on a file, interleaved at random: each request
    continues its writer's run or jumps.  With ``dup`` every offset lies in
    24 blocks, with sizes that overlap them or are 0 (so that a repeated
    offset can follow itself contiguously), and offsets repeat within and
    across streams."""

    rng = np.random.default_rng(seed)
    writers = 6
    nxt = rng.integers(0, 64, writers) * 4096
    offs = np.empty(n, dtype=np.int64)
    sizes = rng.choice([0, 4096, 8192, 12288] if dup else [4096, 65536], n)
    who = rng.integers(0, writers, n)
    for i, w in enumerate(who):
        if dup:  # runs that wrap around 24 blocks, or a jump into them
            offs[i] = nxt[w] % (24 * 4096) if rng.random() < 0.6 else rng.integers(0, 24) * 4096
        elif rng.random() < 0.25:
            offs[i] = rng.integers(0, 4096) * 4096
        else:
            offs[i] = nxt[w]
        nxt[w] = offs[i] + sizes[i]
    gap_pos = np.sort(rng.integers(0, n + 1, gaps))
    return TraceBatch.from_numpy(offsets=offs, sizes=sizes, file_ids=who % files,
                                 app_ids=who % 3, gap_positions=gap_pos,
                                 gap_seconds=rng.uniform(0.0, 2.0, gaps))


def _wide(n: int, seed: int) -> TraceBatch:
    """Offsets over the whole int64 range, negative ones too, and sizes up
    to 2^40: gaps that wrap, |gaps| no float32 holds and distance sums
    past 2^53, where float64 rounds and the order of the sum shows."""

    rng = np.random.default_rng(seed)
    offs = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
    offs[1::3] = offs[0::3][:len(offs[1::3])] + rng.integers(0, 1 << 40, len(offs[1::3]))
    sizes = rng.integers(1, 1 << 40, n, dtype=np.int64)
    sizes[2::5] = offs[3::5][:len(sizes[2::5])] - offs[2::5][:len(sizes[2::5])]
    return TraceBatch.from_numpy(offsets=offs, sizes=sizes, file_ids=rng.integers(0, 2, n),
                                 app_ids=np.zeros(n))


def tape_case(name: str) -> tuple[list[TraceBatch], int]:
    """A case's shards and stream length."""

    if name.startswith("ior-"):
        pattern = {"ior-segrandom-2n": "segmented-random",
                   "ior-segcontig-2n": "segmented-contiguous"}[name]
        return _ior_shards(pattern), 128
    return {
        "files": ([_mixed(3000, 1, 5, False)], 128),
        "dups": ([_mixed(3000, 2, 1, True), _mixed(700, 3, 2, True)], 128),
        "wide": ([_wide(3000, 13)], 128),
        "partial": ([_mixed(128 * 7 + 37, 4, 3, False), _mixed(37, 5, 2, True)], 128),
        "len2": ([_mixed(301, 6, 2, True)], 2),
        "len96": ([_mixed(1000, 7, 3, False)], 96),
        "len2048": ([_mixed(5000, 8, 4, True)], 2048),
        "len8192": ([_mixed(17000, 9, 3, False)], 8192),
        "gaps": ([_mixed(1500, 10, 2, False, gaps=9)], 128),
        "empty": ([_mixed(0, 11, 1, False, gaps=2)], 128),
    }[name]


def shard_cols(batch: TraceBatch) -> torch.Tensor:
    """The shard's request columns in the kernel's rows (``ops.INPUTS``)."""

    return torch.from_numpy(np.stack([batch.offsets, batch.sizes, batch.file_ids]))


def numpy_columns(batch: TraceBatch, stream_len: int) -> np.ndarray:
    """The plain version's columns (the host tape builder's), in the kernel's rows."""

    return ops.columns_op(shard_cols(batch), stream_len, CONSTS).numpy()


def same_bits(got: np.ndarray, want: np.ndarray) -> list[str]:
    """The column rows whose float64 bits differ."""

    assert got.shape == want.shape
    return [k for k, g, w in zip(ops.COLUMNS, got, want)
            if not np.array_equal(g.view(np.int64), w.view(np.int64))]


def same_tape(got: dict, want: dict) -> list[str]:
    """The tape fields whose dtype or bytes differ."""

    assert got.keys() == want.keys()
    return [k for k in want if got[k].dtype != want[k].dtype
            or not np.array_equal(got[k].view(np.uint8), want[k].view(np.uint8))]
