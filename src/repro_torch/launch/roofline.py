"""Roofline terms of one device's step, from what the step ran.

Three terms per (arch x shape x mesh) cell, all per device:

    compute_term    = flops / PEAK_FLOPS
    memory_term     = bytes_accessed / HBM_BW
    collective_term = sum(link_bytes per collective) / LINK_BW

The collectives are records ``(kind, output_bytes, group_size)``, one for
each collective the device's program issued (:class:`CollectiveRecorder`
takes them from the ``_c10d_functional`` ops DTensor issues), in the
reference's kind names; each output's bytes are weighted with the ring
algorithm's factor over the group size n:

    all-reduce      2 (n-1)/n        all-gather / reduce-scatter  (n-1)/n
    all-to-all      (n-1)/n          collective-permute           1

This is the counterpart of the reference's ``parse_collectives``, which
reads the same records off post-SPMD HLO text; torch has no such text.

Hardware model: one NVIDIA H100 SXM5, its datasheet peaks (not
measurements): 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, and 450 GB/s per
direction of NVLink.  The link figure holds inside one 8-GPU NVLink
domain; for a mesh wider than that, collectives cross InfiniBand at a
fraction of it, so the collective term is a lower bound there.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12  # bf16 dense / device
HBM_BW = 3.35e12  # bytes/s / device
LINK_BW = 450e9  # bytes/s / direction, NVLink 4

_FACTORS = {
    "all-reduce": lambda n: 2.0 * (n - 1) / n,
    "all-gather": lambda n: (n - 1) / n,
    "reduce-scatter": lambda n: (n - 1) / n,
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    bytes_by_kind: dict
    link_bytes: float  # factor-weighted bytes over the wire (per device)

    def as_dict(self):
        return {
            "counts": self.counts,
            "bytes_by_kind": self.bytes_by_kind,
            "link_bytes": self.link_bytes,
        }


def collectives_from_records(records: Iterable[tuple[str, int, int]]) -> CollectiveStats:
    """Counts, output bytes by kind and link bytes of ``(kind,
    output_bytes, group_size)`` records."""

    counts: dict[str, int] = {}
    raw: dict[str, float] = {}
    link = 0.0
    for kind, nbytes, n in records:
        if kind == "collective-permute":
            n = 2
        counts[kind] = counts.get(kind, 0) + 1
        raw[kind] = raw.get(kind, 0.0) + nbytes
        link += _FACTORS[kind](max(n, 2)) * nbytes
    return CollectiveStats(counts=counts, bytes_by_kind=raw, link_bytes=link)


@dataclasses.dataclass
class RooflineTerms:
    flops: float
    bytes_accessed: float
    link_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step-time estimate (no overlap: max of the terms)."""

        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self):
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "link_bytes_per_device": self.link_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
        }


def derive_terms(cost_analysis: dict, collectives: CollectiveStats) -> RooflineTerms:
    flops = float(cost_analysis.get("flops", 0.0))
    bytes_acc = float(cost_analysis.get("bytes accessed", 0.0))
    link = collectives.link_bytes
    return RooflineTerms(
        flops=flops,
        bytes_accessed=bytes_acc,
        link_bytes=link,
        compute_s=flops / PEAK_FLOPS,
        memory_s=bytes_acc / HBM_BW,
        collective_s=link / LINK_BW,
    )


def model_flops_per_step(cfg, cell) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) per optimizer step; for serve
    cells D = global_batch tokens (one token per sequence), forward-only
    (2*N*D)."""

    n_active = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * cell.global_batch


# ---------------------------------------------------------------------------
# what one device's step runs: FLOPs, bytes, collectives
# ---------------------------------------------------------------------------

# _c10d_functional op -> (kind, index of its group-size argument or None)
_COLLECTIVE_OPS = {
    "all_reduce": ("all-reduce", None),
    "all_reduce_coalesced": ("all-reduce", None),
    "all_gather_into_tensor": ("all-gather", 1),
    "all_gather_into_tensor_coalesced": ("all-gather", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 2),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 2),
    "all_to_all_single": ("all-to-all", None),
}


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _group_size(group_name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(group_name).size()


class CollectiveRecorder(TorchDispatchMode):
    """Counts what the ops under it run on one device's local tensors:
    ``flops`` (FlopCounterMode's formulas), ``bytes`` (every input and
    output tensor of each op that is not a view, once a call: unfused
    traffic, an upper bound of what a fused program moves, where XLA's
    "bytes accessed" counts after fusion) and ``records`` of collectives
    ``(kind, output_bytes, group_size)``.  An op on DTensors is passed on
    to DTensor, whose ops on local shards and collectives come back here,
    so a sharded step counts one rank's work.

    DTensor moves a shard from one tensor dim to another by an all-to-all
    (``shard_dim_alltoall``), which on a CPU mesh it runs as an all-gather
    and a slice; the recorder counts that call as the all-to-all it stands
    for, and nothing inside it, so a CPU run records what a CUDA run does.
    """

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode

        self._flop_formulas = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.bytes = 0
        self.records: list[tuple[str, int, int]] = []
        self._muted = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._muted:
            return out
        ns, name = func.namespace, func._opname
        if ns == "_c10d_functional":
            if name in _COLLECTIVE_OPS:
                kind, size_arg = _COLLECTIVE_OPS[name]
                n = args[size_arg] if size_arg is not None else _group_size(args[-1])
                self.records.append((kind, _nbytes(out), int(n)))
            elif any(w in name for w in ("all_", "reduce", "broadcast", "scatter", "gather",
                                         "permute", "send", "recv")):
                raise ValueError(f"the roofline has no kind for collective {func}")
            return out
        if func.is_view or any(t.device.type == "meta" for t in _tensors(args)):
            return out  # a view moves nothing; DTensor's shape propagation runs on meta
        self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        formula = self._flop_formulas.get(func.overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        return out

    @contextlib.contextmanager
    def _all_to_all_as_one(self):
        from torch.distributed.tensor import _collective_utils, placement_types

        holders = [m for m in (placement_types, _collective_utils)
                   if hasattr(m, "shard_dim_alltoall")]
        if not holders:
            raise RuntimeError("torch.distributed.tensor has no shard_dim_alltoall to count")
        original = holders[-1].shard_dim_alltoall
        recorder = self

        def counted(input, gather_dim, shard_dim, mesh, mesh_dim):
            recorder._muted += 1
            try:
                out = original(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                recorder._muted -= 1
            recorder.records.append(("all-to-all", _nbytes(out), mesh.size(mesh_dim)))
            recorder.bytes += _nbytes(input) + _nbytes(out)
            return out

        for m in holders:
            m.shard_dim_alltoall = counted
        try:
            yield
        finally:
            for m in holders:
                m.shard_dim_alltoall = original

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(self._all_to_all_as_one())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def collectives(self) -> CollectiveStats:
        return collectives_from_records(self.records)
