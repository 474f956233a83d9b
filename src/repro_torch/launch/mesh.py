"""Production mesh construction; counterpart of ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
process group.  Each builds a ``DeviceMesh`` over whatever world
``torch.distributed`` has initialised (the dry run's fake world of 512
ranks, NCCL on the card, gloo in the CPU tests), on the device type of
that backend.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape, axes):
    """Arbitrary mesh (smoke tests, tuner factorization sweeps) over the
    first ``prod(shape)`` ranks of the world."""
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(shape), tuple(axes)
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh {shape} needs {n} ranks, the world has {world}")
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def mesh_axes_names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


__all__ = ["make_mesh", "make_production_mesh", "mesh_axes_names"]
