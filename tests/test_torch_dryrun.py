"""The port's roofline, dry run and hill-climb driver against the reference's.

(b) ``model_flops_per_step`` and ``applicable_cells`` equal the reference's
    for every arch x shape cell, exactly.
(c) ``collectives_from_records`` and ``derive_terms`` equal the reference's
    ``parse_collectives`` and ``derive_terms``: the reference reads
    synthetic HLO lines (``tests/test_roofline_parser.py``'s form) made
    from the same records; counts and bytes equal exactly, and the terms
    equal after dividing out each package's hardware constants.
(f) ``run_cell`` on the CPU (``FakeTensorMode``, the fake world) at smoke
    size writes a record with the reference's keys, ``argument_bytes``
    equal to the sum of the reference specs' shard shapes (in the port's
    dtypes: its tokens are int64), the FLOPs and collectives counted on
    rank 0's local shards: for every family (the ``ssm`` and ``hybrid``
    families' ``long_500k`` cells among them) and for grok-1-314b's
    hill-climb variants ``onehot_embed`` and ``onehot_replicate``.
(g) The hill-climb driver's targets are the reference's, and its
    ``falcon_train`` target runs its first variants (at smoke size, the
    config lookup patched in the child that runs them).

The fake world starts in a spawned child, never in the test process.
"""

import dataclasses
import math
import pathlib
import tempfile

import numpy as np
import pytest
import torch

from repro.configs import SHAPE_CELLS as J_CELLS
from repro.configs import applicable_cells as jax_applicable_cells
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.distributed.sharding import DEFAULT_RULES
from repro.distributed.sharding import spec_for as jax_spec_for
from repro.launch import roofline as JR
from repro.models import get_model as jax_get_model
from repro.models import input_axes as jax_input_axes
from repro.models import input_specs as jax_input_specs
from repro_torch.configs import ARCHITECTURES, SHAPE_CELLS, applicable_cells, get_config
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch import roofline as TR
from repro_torch.models import get_model, input_specs
from repro_torch.testing.sharded import spawn_world

REPO = pathlib.Path(__file__).resolve().parents[1]
RECORD_KEYS = ("status", "memory", "collectives", "roofline", "roofline_raw", "calibration",
               "model_flops", "useful_flops_ratio")


@pytest.mark.parametrize("cell", list(J_CELLS))
@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_model_flops_and_cells_equal_the_reference(arch, cell):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert SHAPE_CELLS[cell] == SHAPE_CELLS[cell].__class__(**dataclasses.asdict(J_CELLS[cell]))
    assert TR.model_flops_per_step(cfg, SHAPE_CELLS[cell]) == \
        JR.model_flops_per_step(jcfg, J_CELLS[cell])
    assert applicable_cells(cfg) == jax_applicable_cells(jcfg)


KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def _records(seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [(KINDS[rng.integers(len(KINDS))], int(rng.integers(1, 1 << 24)),
             int(rng.choice([2, 4, 16, 32, 256]))) for _ in range(40)]


def _hlo(records) -> str:
    """The records as post-SPMD HLO lines: a u8 output of the record's
    bytes, one replica group of its size."""

    lines = []
    for i, (kind, nbytes, n) in enumerate(records):
        groups = "source_target_pairs={{0,1}}" if kind == "collective-permute" else \
            "replica_groups={{" + ",".join(map(str, range(n))) + "}}"
        lines.append(f"  %c{i} = u8[{nbytes}]{{0}} {kind}(%x), {groups}")
    return "\n".join(lines)


@pytest.mark.parametrize("seed", range(4))
def test_collectives_and_terms_equal_the_reference(seed):
    records = _records(seed)
    got, want = TR.collectives_from_records(records), JR.parse_collectives(_hlo(records))
    assert got.counts == want.counts
    assert got.bytes_by_kind == want.bytes_by_kind
    assert got.link_bytes == want.link_bytes
    cost = {"flops": 1e15 * (seed + 1), "bytes accessed": 3e11 * (seed + 1)}
    t, r = TR.derive_terms(cost, got), JR.derive_terms(cost, want)
    assert (t.flops, t.bytes_accessed, t.link_bytes) == (r.flops, r.bytes_accessed, r.link_bytes)
    assert t.compute_s * TR.PEAK_FLOPS == pytest.approx(r.compute_s * JR.PEAK_FLOPS, rel=1e-15)
    assert t.memory_s * TR.HBM_BW == pytest.approx(r.memory_s * JR.HBM_BW, rel=1e-15)
    assert t.collective_s * TR.LINK_BW == pytest.approx(r.collective_s * JR.ICI_BW, rel=1e-15)
    assert t.as_dict().keys() == r.as_dict().keys()


def test_roofline_constants_are_the_h100_datasheet():
    assert (TR.PEAK_FLOPS, TR.HBM_BW, TR.LINK_BW) == (989e12, 3.35e12, 450e9)


# ---------------------------------------------------------------------------
# (f): the dry run on the CPU at smoke size
# ---------------------------------------------------------------------------

# (arch, cell, mesh, config overrides): the smoke configs keep the cells'
# sequence lengths, so a Mamba train or prefill cell walks thousands of scan
# chunks of 8 (minutes under FakeTensorMode); the ssm and hybrid families
# run their decode and long_500k cells here, their train cell in (g)
GROK_ONEHOT = {"onehot_embed": {"embed_onehot": True},
               "onehot_replicate": {"embed_onehot": True,
                                    "shard_rules_override": (("batch", ()),)}}
DRY_CELLS = [("qwen3-1.7b", "train_4k", "single", {}), ("qwen3-1.7b", "decode_32k", "multi", {}),
             ("moonshot-v1-16b-a3b", "prefill_32k", "single", {}),
             ("internvl2-26b", "train_4k", "multi", {}),
             ("falcon-mamba-7b", "long_500k", "single", {}),
             ("falcon-mamba-7b", "decode_32k", "multi", {}),
             ("zamba2-2.7b", "long_500k", "multi", {}),
             ("zamba2-2.7b", "decode_32k", "single", {}),
             ("whisper-tiny", "train_4k", "single", {}),
             ("whisper-tiny", "decode_32k", "multi", {}),
             ("grok-1-314b", "prefill_32k", "single", GROK_ONEHOT["onehot_embed"]),
             ("grok-1-314b", "decode_32k", "single", GROK_ONEHOT["onehot_replicate"])]


def _smoke(arch: str, overrides: dict):
    return dataclasses.replace(get_smoke_config(arch), **overrides)


def _dry_cells(cells, out_dir: str) -> list:
    """Runs in a spawned child: each cell's record at smoke size, and the
    collectives a redistribute records in the fake world."""

    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.mesh import fake_world, make_production_mesh

    out = [dryrun.run_cell(arch, cell, mesh, out_dir, override_cfg=_smoke(arch, ov),
                           tag=f"__{i}", device="cpu")
           for i, (arch, cell, mesh, ov) in enumerate(cells)]
    with fake_world(512):
        mesh = make_production_mesh(device_type="cpu")
        x = distribute_tensor(torch.zeros(64, 256), mesh, [Shard(0), Shard(1)],
                              src_data_rank=None)
        with TR.CollectiveRecorder() as rec, CommDebugMode() as comm:
            x.redistribute(mesh, [Shard(1), Replicate()])
            (x * 2).redistribute(mesh, [Replicate(), Replicate()])
        counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    return out, rec.records, counts


@pytest.fixture(scope="module")
def dry_records():
    with tempfile.TemporaryDirectory() as tmp:
        return spawn_world(1, tmp, _dry_cells, DRY_CELLS, tmp, group=False)[0]


def _shard_numel(shape, logical, mesh, rules=None) -> int:
    spec = jax_spec_for(shape, logical, mesh, rules)
    n = 1
    for dim, entry in zip(shape, spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        n *= dim // math.prod(mesh.shape[a] for a in axes)
    return n


class FakeMesh:
    """Duck-typed mesh: spec_for only reads .shape (a dict)."""

    def __init__(self, **axes):
        self.shape = axes


MESHES = {"single": FakeMesh(data=16, model=16), "multi": FakeMesh(pod=2, data=16, model=16)}


def _argument_bytes(arch: str, cell_name: str, mesh_kind: str, overrides: dict) -> int:
    """The sum over the reference's leaves of its spec's shard shape, each in
    the port's dtype of that leaf."""

    jcfg = dataclasses.replace(jax_smoke_config(arch), **overrides)
    cfg = _smoke(arch, overrides)
    rules = {**DEFAULT_RULES, **dict(cfg.shard_rules_override)}
    mesh, cell = MESHES[mesh_kind], J_CELLS[cell_name]
    jm = jax_get_model(jcfg)
    # the port's dtype of each leaf name (the Mamba families store A_log, and
    # the hybrid dt_bias, in f32, as the reference's init does)
    dtypes = {name.rpartition(".")[2]: p.element_size()
              for name, p in get_model(cfg, "cpu").abstract_params().named_parameters()}
    total = 0

    def walk(abstract, axes, itemsize=None):
        nonlocal total
        for k, v in abstract.items():
            if isinstance(v, dict):
                walk(v, axes[k], itemsize)
            else:
                total += _shard_numel(v.shape, axes[k], mesh, rules) * (itemsize or dtypes[k])

    walk(jm.abstract_params(), jm.param_axes())
    if cell.kind == "train":
        walk(jm.abstract_params(), jm.param_axes(), 4)  # m
        walk(jm.abstract_params(), jm.param_axes(), 4)  # v
        total += 4  # step, int32
    specs = input_specs(cfg, cell.kind, cell.global_batch, cell.seq_len)
    jspecs = jax_input_specs(jcfg, cell.kind, cell.global_batch, cell.seq_len)
    axes = jax_input_axes(jcfg, cell.kind)
    for k, t in jspecs.items():
        total += _shard_numel(t.shape, axes[k], mesh, rules) * specs[k].element_size()
    if cell.kind == "decode":
        cache = get_model(cfg, "cpu").abstract_cache(cell.global_batch, cell.seq_len)
        jcache, caxes = jm.abstract_cache(cell.global_batch, cell.seq_len), jm.cache_axes()
        for k, t in jcache.items():
            total += _shard_numel(t.shape, caxes[k], mesh, rules) * cache[k].element_size()
    return total


@pytest.mark.parametrize("i", range(len(DRY_CELLS)),
                         ids=["-".join(c[:3]) + "".join(f"-{k}" for k in c[3]) for c in DRY_CELLS])
def test_cpu_dry_run_record(dry_records, i):
    arch, cell, mesh, overrides = DRY_CELLS[i]
    rec = dry_records[0][i]
    for key in RECORD_KEYS:
        assert key in rec, key
    assert rec["status"] == "ok" and rec["device"] == "cpu"
    assert rec["calibration"] is None and rec["roofline_raw"] == rec["roofline"]
    assert rec["memory"]["peak_allocated_bytes"] is None
    assert rec["memory"]["argument_bytes"] == _argument_bytes(arch, cell, mesh, overrides)
    r = rec["roofline"]
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    assert rec["model_flops"] == TR.model_flops_per_step(_smoke(arch, overrides),
                                                         SHAPE_CELLS[cell])
    assert rec["collectives"]["counts"] and r["link_bytes_per_device"] > 0
    assert r["compute_s"] == r["flops_per_device"] / TR.PEAK_FLOPS
    n = math.prod(rec["mesh_shape"].values())
    assert rec["useful_flops_ratio"] == rec["model_flops"] / (r["flops_per_device"] * n)


def test_recorder_counts_what_dtensor_issues(dry_records):
    """A Shard(0),Shard(1) -> Shard(1),Replicate redistribute of a (64, 256)
    f32 on the 16 x 16 mesh: an all-to-all on ``data`` (a (4, 16) shard
    out) and an all-gather on ``model``; then an all-gather of the rest.
    The recorder counts each collective DTensor issues, the CPU mesh's
    all-gather-and-slice stand-in for the all-to-all as the all-to-all."""

    records, comm = dry_records[1], dry_records[2]
    kinds = sorted(r[0] for r in records)
    assert kinds.count("all-to-all") == 1
    assert all(n == 16 for _, _, n in records)
    n_gathers = sum(v for k, v in comm.items() if "all_gather" in k)
    # CommDebugMode sees the CPU stand-in's extra all-gather too
    assert kinds.count("all-gather") == n_gathers - 1


FIRST_FALCON_VARIANTS = 3  # rebaseline, fused_proj, fused_chunk512


def _falcon_first_variants(out_dir: str) -> list:
    """Runs in a spawned child: ``run_target("falcon_train")`` over its first
    variants, the config lookup patched to the smoke falcon-mamba-7b with
    one scan chunk of the cell's 4,096 tokens (a variant sets its own)."""

    arch, cell, variants = hillclimb.TARGETS["falcon_train"]
    hillclimb.TARGETS["falcon_train"] = (arch, cell, variants[:FIRST_FALCON_VARIANTS])
    smoke = dataclasses.replace(get_smoke_config(arch), scan_chunk=4096)
    hillclimb.get_config = dryrun.get_config = lambda name: smoke
    rows = hillclimb.run_target("falcon_train", out_dir=out_dir, dryrun_dir=out_dir,
                                device="cpu")
    return [(name, rec["status"], rec["roofline"], rec["collectives"]["counts"])
            for name, rec in rows]


def test_hillclimb_targets_copy_the_reference(tmp_path):
    # the reference module sets XLA_FLAGS when imported: read its table
    # without importing it
    src = (REPO / "src" / "repro" / "launch" / "hillclimb.py").read_text()
    ns: dict = {}
    exec(src[src.index("TARGETS = {"):src.index("def run_target")], ns)
    assert hillclimb.TARGETS == ns["TARGETS"]
    rows = spawn_world(1, str(tmp_path), _falcon_first_variants, str(tmp_path), group=False)[0]
    names = [v for v, _ in hillclimb.TARGETS["falcon_train"][2][:FIRST_FALCON_VARIANTS]]
    assert [r[0] for r in rows] == ["baseline", *names]
    assert all(r[1] == "ok" and r[2]["flops_per_device"] > 0 for r in rows)
    for key in ("flops_per_device", "link_bytes_per_device"):  # rebaseline: the baseline's
        assert rows[1][2][key] == rows[0][2][key]
    assert rows[1][3] == rows[0][3]
    # the fused projections sum x_proj's product over the split channels a
    # chunk at a time: more all-reduces, the chunk's
    assert rows[2][3]["all-reduce"] > rows[1][3]["all-reduce"]
    assert rows[3][3]["all-reduce"] > rows[2][3]["all-reduce"]
