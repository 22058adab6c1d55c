"""Production meshes (16 x 16 single-pod, 2 x 16 x 16 multi-pod) as
``DeviceMesh``es, and the fake world a dry run builds them over.

FUNCTIONS, not module-level constants, so importing this module touches no
process group.  A mesh is made over the process group that is up: a real
one (``torch.distributed.init_process_group`` with its address, world size
and rank given), or the fake one of :func:`fake_world`, whose collectives
move nothing, so that one process runs rank 0's program of a mesh of
hundreds of devices.  The single-pod mesh takes the first 256 ranks of a
larger world.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

PRODUCTION_SHAPES = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
}


@contextlib.contextmanager
def fake_world(n: int):
    """A process group of ``n`` ranks of which this process is rank 0, whose
    collectives return without moving data (torch's fake backend), for the
    time of the ``with``.  The one import of ``torch.testing._internal`` in
    the port."""

    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _check_device(device_type: str) -> None:
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device_type='cpu' to build "
                           "the mesh on the CPU")


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 0


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The ``(16, 16)`` ``("data", "model")`` mesh, or with ``multi_pod`` the
    ``(2, 16, 16)`` ``("pod", "data", "model")`` one, over the first ranks of
    the world that is up (on ``device_type``; ``"cpu"`` for a dry run with
    no card).  Raises ``RuntimeError`` when the world is too small."""

    from torch.distributed.device_mesh import DeviceMesh

    _check_device(device_type)
    shape, axes = PRODUCTION_SHAPES["multi" if multi_pod else "single"]
    ndev = 1
    for d in shape:
        ndev *= d
    if _world() < ndev:
        raise RuntimeError(
            f"need {ndev} devices for mesh {shape}, have {_world()} — "
            f"run under repro_torch.launch.mesh.fake_world({2 * 16 * 16})")
    return DeviceMesh(device_type, torch.arange(ndev).reshape(shape), mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1, device_type: str = "cuda"):
    """A ``(world // model_axis, model_axis)`` ``("data", "model")`` mesh
    over the ranks that are up (tests, examples)."""

    from torch.distributed.device_mesh import init_device_mesh

    _check_device(device_type)
    n = _world()
    if n < model_axis or n % model_axis:
        raise RuntimeError(
            f"need a multiple of {model_axis} devices for a model axis of {model_axis}, "
            f"have {n} — start a process group first")
    return init_device_mesh(device_type, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))
