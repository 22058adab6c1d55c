"""The benchmark's vectorised trace generator agrees request for request
with the port's own IOR builder, and its full-size traces have the sizes
and totals their configuration files state."""

import json

import numpy as np
import pytest

from portbench_util import REPO

from bench.harness.cell import trace_seed
from bench.harness.registry import ROOT, load_module
from bench.reference.sweep import capacity
from repro_torch.core.trace import TraceBatch
from repro_torch.core.workloads import ior

COLS = ("offsets", "sizes", "file_ids", "app_ids", "times", "gap_positions", "gap_seconds")
CONFIGS = ("ior-segrandom-2n", "ior-segcontig-2n")


def _gen(name):
    return load_module(ROOT / "bench" / "generators" / f"{name}.py")


def _config(name):
    return json.loads((REPO / "bench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("seed", [0, 2**31 + 3, trace_seed(2**31 + 3, 4)])
@pytest.mark.parametrize("nproc,mib", [(16, 64), (4, 16), (5, 10)])
@pytest.mark.parametrize("name", CONFIGS)
def test_ior_is_the_ports(name, nproc, mib, seed):
    args = dict(_config(name)["generator_args"], processes=nproc, total_bytes=mib << 20)
    port = ior(args["pattern"], nproc, total_bytes=mib << 20,
               request_size=args["request_size"], seed=seed, app_id=args["app_id"],
               file_id=args["file_id"])
    batch = TraceBatch.from_items(port.trace)
    cols = _gen("ior").generate(seed, args)
    for k in COLS:
        np.testing.assert_array_equal(np.asarray(cols[k]), getattr(batch, k), err_msg=k)


def test_an_unknown_layout_is_refused():
    args = dict(_config(CONFIGS[0])["generator_args"], pattern="strided")
    with pytest.raises(ValueError, match="strided"):
        _gen("ior").generate(0, args)


@pytest.mark.parametrize("name", CONFIGS)
def test_full_size_matches_the_config(name):
    cfg = _config(name)
    args = cfg["generator_args"]
    cols = _gen(cfg["generator"]).generate(trace_seed(2**31 + 17, 1), args)
    batch = TraceBatch.from_numpy(**cols)
    tot = cfg["totals"]
    assert batch.num_requests == tot["requests"]
    assert batch.total_bytes == tot["logical_bytes"]
    assert batch.num_gaps == tot["gaps"]
    assert capacity(batch.total_bytes, cfg) == tot["ssd_bytes_per_node"]
    assert np.all(batch.sizes == args["request_size"])
    # IOR's layout: every aligned transfer of the file written exactly once
    assert np.array_equal(np.sort(batch.offsets),
                          np.arange(tot["requests"], dtype=np.int64) * args["request_size"])
    batch.validate()
