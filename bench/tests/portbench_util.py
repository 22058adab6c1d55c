"""Helpers of the benchmark's CPU tests: a copy of the benchmark in a
temporary directory with its configurations cut to a size a test holds."""

from __future__ import annotations

import io
import json
import pathlib
import shutil
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# small shapes: 4 nodes, 8,192 requests (2 GiB) a trace
SMALL = {
    "ior-segrandom-2n": {"total_bytes": 2 << 30},
    "ior-segcontig-2n": {"total_bytes": 2 << 30},
}
SMALL_NODES = 4


def small_config(name: str) -> dict:
    cfg = json.loads((REPO / "bench" / "configs" / f"{name}.json").read_text())
    cfg["nodes"] = SMALL_NODES
    cfg["generator_args"].update(SMALL[name])
    return cfg


def small_bench(tmp: pathlib.Path) -> pathlib.Path:
    """A checkout-like root in ``tmp``: ``BENCHMARK.json`` and ``bench/``
    copied, every configuration cut to :data:`SMALL`."""

    shutil.copytree(REPO / "bench", tmp / "bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for name in SMALL:
        (tmp / "bench" / "configs" / f"{name}.json").write_text(json.dumps(small_config(name)))
    return tmp


def run(root: pathlib.Path, workload: str, seed: int = 2**31 + 11, seconds: float = 0.3,
        trace: bool = False) -> tuple[int, dict | None, str]:
    """One CPU run of a cell: exit code, the result's line, standard error."""

    from bench.harness import cell

    # a test process may hold JAX from other test files; the run's own
    # look counts only what the run itself loads
    loaded = set(cell.forbidden_modules())
    look = cell.forbidden_modules
    out, err = io.StringIO(), io.StringIO()
    try:
        cell.forbidden_modules = lambda: [m for m in look() if m not in loaded]
        rc = cell.run_cell(workload, seed, seconds, trace, root=root, device="cpu",
                           out=out, err=err)
    finally:
        cell.forbidden_modules = look
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None), err.getvalue()
