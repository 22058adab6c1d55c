"""Find a cell's parts by name, each in a file of its own.

From the checkout's root: ``BENCHMARK.json`` names the cell, its
configuration (whose ``file`` holds the deployment) and its traffic mix;
the mix is ``bench/traffic/<traffic>.json``; the configuration names its
trace generator, ``bench/generators/<generator>.py``; each per-layer
metric is ``bench/metrics/<name>.py``.  Adding a cell, a configuration, a
mix, a generator or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    generator: types.ModuleType
    metrics: dict  # this cell's per-layer metric name -> its module
    end_to_end: list


def load_module(path: pathlib.Path) -> types.ModuleType:
    """A file of the benchmark as a module of its own."""

    name = "bench_file_" + "_".join(path.with_suffix("").parts[-2:]).replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def probe_keys(metric) -> tuple:
    """The probes a per-layer metric's module needs installed: the spans it
    reads and the child spans it subtracts from a self time."""

    return (*getattr(metric, "WRAPS", ()), *getattr(metric, "EXCLUDES", ()))


def cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    bench = benchmark(root)
    try:
        wl = next(w for w in bench["workloads"] if w["name"] == name)
    except StopIteration:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json") from None
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    mix = json.loads((root / "bench" / "traffic" / f"{wl['traffic']}.json").read_text())
    generator = load_module(root / "bench" / "generators" / f"{config['generator']}.py")
    metrics = {m["name"]: load_module(root / "bench" / "metrics" / f"{m['name']}.py")
               for m in bench["per_layer"] if name in m["workloads"]}
    return Cell(name, wl, config, mix, generator, metrics, bench["end_to_end"])
