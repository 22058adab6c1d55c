"""The port's event tapes against the reference package's, on the cases on
which the ``tapes`` kernel is checked (``tapes_cases.py``), on the CPU.

The card tests hold the kernel to the port's plain version
(``kernels/tapes/ref.py``) on these cases; here that plain version, and
``build_events``' assembly of the tape around it, are held field by field,
bit for bit, to ``repro.core.engine_device.build_events`` on the same
shards and scores: the paper's IOR runs sharded by byte range, interleaved
files, duplicate offsets, offsets over the whole int64 range, partial
streams, stream lengths 2 to 8,192, compute gaps and an empty shard.
This file imports the reference package, so the card tests do not import
it.
"""

import numpy as np
import pytest

from repro.core import TraceBatch as RefTraceBatch
from repro.core import engine_device as ref_ed
from repro.core.workloads import ior as ref_ior
from repro_torch.core import compute_stream_scores
from repro_torch.core import engine_device as ed
from tapes_cases import CASES, IOR_RUN, IOR_SEED, ior_trace, same_tape, tape_case

COLUMNS = ("offsets", "sizes", "file_ids", "app_ids", "times", "gap_positions",
           "gap_seconds")


def _ref(batch) -> RefTraceBatch:
    return RefTraceBatch(**{c: getattr(batch, c).copy() for c in COLUMNS})


@pytest.mark.parametrize("case", CASES)
def test_tapes_equal_the_reference(case):
    shards, stream_len = tape_case(case)
    for batch in shards:
        scores = compute_stream_scores(batch, stream_len, backend="numpy")
        want = ref_ed.build_events(_ref(batch), scores, stream_len=stream_len)
        for device in (None, "cpu"):
            got = ed.build_events(batch, scores, stream_len=stream_len, device=device)
            assert same_tape(got, want) == []
        assert ed.per_app_bytes(batch) == ref_ed.per_app_bytes(_ref(batch))


@pytest.mark.parametrize("pattern", ["segmented-random", "segmented-contiguous"])
def test_the_ior_cases_are_the_references_runs(pattern):
    """The IOR cases' traces are the reference's IOR runs on the same seed."""

    want = ref_ior(pattern, seed=IOR_SEED, **IOR_RUN).trace
    got = ior_trace(pattern)
    assert got.num_requests == len(want)
    assert np.array_equal(got.offsets, [r.offset for r in want])
    assert np.array_equal(got.sizes, [r.size for r in want])
