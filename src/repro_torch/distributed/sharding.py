"""Sharding: logical-axis rules for tensors, and trace partitioning for the
fleet.

Two layers live here, as in the reference module:

1. **Tensor sharding** -- logical-axis rules mapping weights and activations
   onto a ``DeviceMesh`` (DP / FSDP / TP / EP / SP on one rule table).  A
   tensor is annotated with *logical* axis names; :func:`spec_for` picks
   the mesh axes of each (the first rule prefix whose size divides the
   dimension, each mesh axis used at most once), which is the reference's
   ``PartitionSpec`` as a plain tuple, and :func:`placements_for` turns it
   into one DTensor ``Placement`` per mesh dim.  :func:`use_mesh` sets the
   mesh and rules of the calling thread; inside it :func:`constrain`
   redistributes a DTensor to its logical layout (the reference's
   ``with_sharding_constraint``).  Without a mesh, or on a plain tensor,
   :func:`constrain` returns its input, so the same model code runs on one
   device.
2. **Trace sharding** -- request -> I/O node assignment for the fleet:
   each policy is a pure function of the trace's columns, so the shards
   partition the trace exactly; :func:`reshard_to_survivors` re-policies
   a dead node's requests over the survivors.

Rule table (logical -> mesh axes, the longest prefix that divides wins):

    batch      -> ("pod", "data")   activations' batch dim (DP; pod = outer DP)
    embed      -> "data"            weights' d_model dim (FSDP / ZeRO-3)
    vocab      -> "model"           embedding/vocab dim (TP)
    heads      -> "model"           attention heads (TP)
    kv_heads   -> "model"           KV heads (TP; GQA often replicates)
    mlp        -> "model"           FFN hidden (TP)
    experts    -> "model"           MoE experts (EP)
    inner      -> "model"           Mamba d_inner (TP)
    cache_seq  -> "model"           decode KV-cache sequence dim (SP)
    frames/seq/layers/state/conv/head_dim/dt_rank -> replicated
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterable, Sequence

import numpy as np
import torch

DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    # decode caches keep batch sharded even when activations replicate
    # ("batch" overridden to ())
    "cache_batch": ("pod", "data"),
    "embed": ("data",),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "inner": ("model",),
    "cache_seq": ("model",),
    "seq": (),
    "frames": (),
    "layers": (),
    "state": (),
    "conv": (),
    "head_dim": (),
    "dt_rank": (),
}

Spec = tuple  # one entry a tensor dim: None, a mesh axis name, or a tuple of them


class _Ctx(threading.local):
    mesh: Any = None
    rules: dict[str, tuple[str, ...]] | None = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh, rules: dict[str, tuple[str, ...]] | None = None):
    """Make ``mesh`` (a ``DeviceMesh``) and the rule table with ``rules``
    over it the calling thread's, for :func:`constrain` and the builders
    below.  A ``DeviceMesh`` has no ``with`` form of its own here: only the
    thread-local is set."""

    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    _CTX.rules = {**DEFAULT_RULES, **(rules or {})}
    try:
        yield mesh
    finally:
        _CTX.mesh, _CTX.rules = prev


def active_mesh():
    return _CTX.mesh


def mesh_axes(mesh) -> dict[str, int]:
    """Axis name -> size, in mesh order: a ``DeviceMesh``'s dim names, or
    the ``shape`` dict of a duck-typed mesh (the reference's tests use
    one)."""

    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _mesh_axis_size(sizes: dict[str, int], names: Iterable[str]) -> int:
    size = 1
    for n in names:
        size *= sizes[n]
    return size


def spec_for(shape: Sequence[int], logical: Sequence[str | None], mesh=None,
             rules: dict[str, tuple[str, ...]] | None = None) -> Spec:
    """The reference's ``PartitionSpec`` of ``shape`` under the rule table, as
    a tuple: for each dim ``None`` (replicated), a mesh axis name, or a
    tuple of names (sharded over their product, the first outermost).
    Divisibility-safe: a dim takes the longest prefix of its rule whose
    size divides it, of the mesh axes no earlier dim took."""

    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules or DEFAULT_RULES
    if mesh is None:
        return (None,) * len(shape)
    if len(shape) != len(logical):
        raise ValueError(f"shape rank {len(shape)} != logical rank {len(logical)}: "
                         f"{tuple(shape)} vs {tuple(logical)}")
    sizes = mesh_axes(mesh)
    out: list[Any] = []
    used: set[str] = set()  # a mesh axis may appear at most once per spec
    for dim, name in zip(shape, logical):
        if name is None:
            out.append(None)
            continue
        axes = tuple(a for a in rules.get(name, ()) if a in sizes and a not in used)
        chosen: tuple[str, ...] | None = None
        for k in range(len(axes), 0, -1):
            if dim % _mesh_axis_size(sizes, axes[:k]) == 0:
                chosen = axes[:k]
                break
        if chosen:
            used.update(chosen)
            out.append(chosen if len(chosen) > 1 else chosen[0])
        else:
            out.append(None)
    return tuple(out)


def placements_for(shape: Sequence[int], logical: Sequence[str | None], mesh=None,
                   rules: dict[str, tuple[str, ...]] | None = None) -> tuple:
    """One DTensor placement a mesh dim for :func:`spec_for`'s spec:
    ``Shard(d)`` on the mesh dims tensor dim ``d`` names, ``Replicate()``
    elsewhere.  A dim over several mesh axes is ``Shard(d)`` on each, which
    DTensor splits in mesh order; so a rule that lists them out of mesh
    order raises ``ValueError`` rather than build another layout."""

    from torch.distributed.tensor import Replicate, Shard

    mesh = mesh or _CTX.mesh
    if mesh is None:
        raise RuntimeError("placements_for requires an active or given mesh")
    order = list(mesh_axes(mesh))
    out: list = [Replicate()] * len(order)
    for d, entry in enumerate(spec_for(shape, logical, mesh, rules)):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        idx = [order.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} of {tuple(shape)} ({logical[d]!r}) is sharded over "
                             f"{axes}, out of the mesh's order {tuple(order)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def constrain(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """Redistribute a DTensor to the layout its logical axes give under the
    active mesh; the input itself without a mesh or for a plain tensor."""

    mesh = _CTX.mesh
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    want = placements_for(x.shape, logical, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def distribute(t: torch.Tensor, logical: Sequence[str | None], mesh=None):
    """``t`` (the whole tensor, on every rank alike) as a DTensor laid out
    by its logical axes: each rank keeps its own slice, nothing is sent."""

    from torch.distributed.tensor import distribute_tensor

    mesh = mesh or _CTX.mesh
    return distribute_tensor(t, mesh, placements_for(t.shape, logical, mesh),
                             src_data_rank=None)


def distribute_module(module: torch.nn.Module, named_axes: dict, mesh=None) -> torch.nn.Module:
    """Every parameter of ``module`` (``named_parameters()`` name -> logical
    axes in ``named_axes``) replaced, in place, by its :func:`distribute`
    DTensor; returns ``module``."""

    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner)
        sub.register_parameter(leaf, torch.nn.Parameter(
            distribute(p.detach(), named_axes[name], mesh), requires_grad=p.requires_grad))
    return module


def replicated_like(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t``, a plain tensor the same on every rank (a mask, a rotary
    table), as a replicated DTensor on ``x``'s mesh when ``x`` is a DTensor
    (DTensor ops refuse to mix the two); ``t`` itself otherwise."""

    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def grad_placements(in_placements, out_placements=()) -> tuple:
    """The placements of the gradients a ``local_map`` function gives its
    inputs laid out by ``in_placements`` (one sequence a tensor input,
    ``None`` for another argument) when it lays its outputs out by
    ``out_placements`` (one sequence an output): an input sharded on a
    mesh dim gets its own shard's gradient; one replicated on a mesh dim
    that another input or an output splits gets a partial sum there, each
    rank's share of the work."""

    from torch.distributed.tensor import Partial, Replicate, Shard

    given = [pl for pl in (*in_placements, *out_placements) if pl is not None]
    split = [any(isinstance(pl[i], Shard) for pl in given) for i in range(len(given[0]))]
    return tuple(None if pl is None else tuple(
        Partial() if isinstance(p, Replicate) and split[i] else p for i, p in enumerate(pl))
        for pl in in_placements)


def named_sharding(shape: Sequence[int], logical: Sequence[str | None], mesh=None) -> tuple:
    """The placements of one tensor (the reference's ``NamedSharding``)."""

    mesh = mesh or _CTX.mesh
    if mesh is None:
        raise RuntimeError("named_sharding requires an active or given mesh")
    return placements_for(shape, logical, mesh)


def tree_shardings(abstract_tree, logical_tree, mesh=None):
    """A nested dict of tensors (meta ones included) and the matching dict of
    logical-axes tuples -> the dict of their placements."""

    mesh = mesh or _CTX.mesh

    def rec(a, l):
        if isinstance(a, dict):
            return {k: rec(a[k], l[k]) for k in a}
        return named_sharding(a.shape, l, mesh)

    return rec(abstract_tree, logical_tree)


# ---------------------------------------------------------------------------
# trace sharding: request -> I/O node assignment (fleet simulator)
# ---------------------------------------------------------------------------



def shard_round_robin_app(offsets, file_ids, app_ids, num_nodes: int) -> np.ndarray:
    """Pin whole applications to nodes round-robin, by first appearance."""

    app_ids = np.asarray(app_ids, dtype=np.int64)
    _, first_pos, inverse = np.unique(app_ids, return_index=True,
                                      return_inverse=True)
    # np.unique sorts by id; re-rank the apps by arrival
    rank_of_sorted = np.argsort(np.argsort(first_pos, kind="stable"),
                                kind="stable")
    return (rank_of_sorted[inverse] % num_nodes).astype(np.int64)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mix (SplitMix64 finalizer), vectorized."""

    z = x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def shard_hash_file(offsets, file_ids, app_ids, num_nodes: int) -> np.ndarray:
    """Hash each file handle to a node."""

    file_ids = np.asarray(file_ids, dtype=np.int64)
    return (_splitmix64(file_ids) % np.uint64(num_nodes)).astype(np.int64)


def shard_range_offset(offsets, file_ids, app_ids, num_nodes: int) -> np.ndarray:
    """Stripe the trace's logical byte range into ``num_nodes`` equal
    extents (Lustre-style range partitioning)."""

    offsets = np.asarray(offsets, dtype=np.int64)
    if offsets.size == 0:
        return np.zeros(0, dtype=np.int64)
    lo = int(offsets.min())
    hi = int(offsets.max())
    extent = max((hi - lo) // num_nodes + 1, 1)
    return np.minimum((offsets - lo) // extent, num_nodes - 1).astype(np.int64)


TRACE_POLICIES = {
    "round-robin-app": shard_round_robin_app,
    "hash-file": shard_hash_file,
    "range-offset": shard_range_offset,
}


def assign_nodes(policy: str, offsets, file_ids, app_ids,
                 num_nodes: int) -> np.ndarray:
    """Per-request node assignment under a named trace-sharding policy."""

    if num_nodes < 1:
        raise ValueError(f"num_nodes must be >= 1, got {num_nodes}")
    try:
        fn = TRACE_POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown trace sharding policy {policy!r}; "
            f"choose from {sorted(TRACE_POLICIES)}"
        ) from None
    out = fn(offsets, file_ids, app_ids, num_nodes)
    if out.shape[0] != np.asarray(offsets).shape[0]:
        raise ValueError(
            f"policy {policy!r} returned {out.shape[0]} assignments for "
            f"{np.asarray(offsets).shape[0]} requests"
        )
    return out


def reshard_to_survivors(policy: str, offsets, file_ids, app_ids,
                         assignment, survivors) -> np.ndarray:
    """Reassign requests stranded on dead nodes onto the survivors.

    Requests whose ``assignment`` already names a survivor stay put; every
    other request is re-policied over the survivor set (the policy runs
    with ``num_nodes = len(survivors)`` and its output indexes the sorted
    survivor list).  Pure and deterministic.
    """

    assignment = np.asarray(assignment, dtype=np.int64)
    surv = np.asarray(sorted(set(int(s) for s in survivors)), dtype=np.int64)
    if surv.size == 0:
        raise ValueError("no surviving nodes to reshard onto")
    out = assignment.copy()
    dead_mask = ~np.isin(assignment, surv)
    if not dead_mask.any():
        return out
    idx = np.nonzero(dead_mask)[0]
    sub = assign_nodes(
        policy,
        np.asarray(offsets)[idx],
        np.asarray(file_ids)[idx],
        np.asarray(app_ids)[idx],
        int(surv.size),
    )
    out[idx] = surv[sub]
    return out
