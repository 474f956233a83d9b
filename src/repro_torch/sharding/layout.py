"""Laying tensors and models out on a mesh as DTensors.

``distribute`` scatters a whole tensor (every rank holds it) to a spec;
``fake_like`` makes a DTensor from a fake local shard (under
``FakeTensorMode``: nothing is allocated and nothing is sent), which is
how the dry run builds cells at 512 ranks; ``shard_module`` replaces a
module's parameters by DTensor parameters; ``zeros_state`` makes a
sharded zero decode state shard by shard; ``full`` gathers a DTensor
back to a whole tensor on every rank.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.sharding.context import clean_spec, is_dtensor
from repro_torch.sharding.rules import placements


def local_shape(shape, spec, mesh) -> tuple:
    """The per-rank shard shape of a tensor of ``shape`` laid out by
    ``spec`` (every sharded dimension divides evenly)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = list(shape)
    for dim, entry in enumerate(clean_spec(spec, mesh.mesh_dim_names)):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                if out[dim] % sizes[axis]:
                    raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                                     f"over {axis}={sizes[axis]}")
                out[dim] //= sizes[axis]
    return tuple(out)


def distribute(t: torch.Tensor, mesh, spec):
    """The whole tensor ``t`` (the same on every rank) as a DTensor laid
    out by ``spec``; each rank keeps its slice, nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements(clean_spec(spec, mesh.mesh_dim_names), mesh),
                             src_data_rank=None)


def fake_like(shape, dtype, mesh, spec, device=None):
    """A DTensor of global ``shape`` on ``spec`` whose local shard is an
    empty tensor: call under ``FakeTensorMode`` to allocate nothing."""
    from torch.distributed.tensor import DTensor

    spec = clean_spec(spec, mesh.mesh_dim_names)
    local = torch.empty(local_shape(shape, spec, mesh), dtype=dtype,
                        device=device or mesh.device_type)
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False)


def _set_param(model: nn.Module, name: str, value) -> None:
    *parents, leaf = name.split(".")
    mod = model
    for p in parents:
        mod = getattr(mod, p)
    setattr(mod, leaf, nn.Parameter(value, requires_grad=getattr(mod, leaf).requires_grad))


def shard_module(model: nn.Module, mesh, specs: dict, *, fake: bool = False) -> nn.Module:
    """Replace every parameter of ``model`` by a DTensor parameter laid out
    by ``specs[name]``: scattered from the whole weights, or with
    ``fake=True`` an empty fake shard of the parameter's shape and dtype."""
    for name, p in list(model.named_parameters()):
        if fake:
            value = fake_like(tuple(p.shape), p.dtype, mesh, specs[name])
        else:
            value = distribute(p.detach(), mesh, specs[name])
        _set_param(model, name, value)
    return model


def zeros_state(layers: list, mesh, specs: list, device=None) -> list:
    """Zero decode-state tensors shaped as ``layers`` (meta tensors will
    do), laid out by ``specs`` (``decode_state_specs``): each rank makes
    only its own shard."""
    def one(t, spec):
        from torch.distributed.tensor import DTensor

        spec = clean_spec(spec, mesh.mesh_dim_names)
        local = torch.zeros(local_shape(tuple(t.shape), spec, mesh), dtype=t.dtype,
                            device=device or mesh.device_type)
        return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False)

    out = []
    for layer, spec in zip(layers, specs):
        if isinstance(layer, (tuple, list)):
            out.append(tuple(one(t, sp) for t, sp in zip(layer, spec)))
        else:
            out.append({k: one(t, spec[k]) for k, t in layer.items()})
    return out


def full(t):
    """A DTensor gathered to a whole tensor on every rank; anything else as it is."""
    return t.full_tensor() if is_dtensor(t) else t


__all__ = ["distribute", "fake_like", "zeros_state", "full", "local_shape",
           "shard_module"]
