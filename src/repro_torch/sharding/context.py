"""Ambient mesh context so model modules can pin shardings without
threading mesh objects through every call signature; counterpart of
``repro.sharding.context``.

``cells.py`` (and any launcher) activates the mesh around a sharded run.
Inside it, plain tensors that meet DTensors (positions, masks, zero
accumulators) count as replicated (``implicit_replication``).
``constraint(x, *spec)`` is a no-op when no mesh is active or when ``x``
is a plain tensor, so model code can pin freely.  On a DTensor it is an
explicit redistribution: where the reference's
``with_sharding_constraint`` lets XLA place the collectives, here they
are issued at the pin (a ``Partial`` result is reduced there), which is
where the dry run counts them.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_MESH = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a DeviceMesh, or None for no mesh) the ambient mesh."""
    from torch.distributed.tensor.experimental import implicit_replication

    token = _MESH.set(mesh)
    try:
        if mesh is None:
            yield mesh
        else:
            with implicit_replication():
                yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    return _MESH.get()


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor for plain runs)."""
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def clean_spec(spec, axis_names) -> tuple:
    """``spec`` without the axes ``axis_names`` lacks (e.g. "pod" on a
    single-pod mesh)."""
    names = set(axis_names)

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in names)
            return kept if kept else None
        return entry if entry in names else None

    return tuple(keep(e) for e in spec)


def constraint(x, *spec):
    """Redistribute the DTensor ``x`` to ``spec`` on the ambient mesh.

    Spec entries naming axes absent from the ambient mesh are dropped;
    no-op without an ambient mesh or for a plain tensor.
    """
    mesh = _MESH.get()
    if mesh is None or not is_dtensor(x):
        return x
    from repro_torch.sharding.rules import placements

    want = placements(clean_spec(spec, mesh.mesh_dim_names), mesh)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(mesh, want)


def shard_start(mesh, axis: str, n: int) -> int:
    """Where this rank's shard begins along a dimension of size ``n`` split
    evenly over ``axis`` (0 when the mesh lacks it)."""
    size = dict(zip(mesh.mesh_dim_names, mesh.shape)).get(axis, 1)
    return mesh.get_local_rank(axis) * (n // size) if size > 1 else 0


def local_placements(t, mesh, spec) -> list:
    """The placements ``spec`` gives a tensor shaped as ``t`` on ``mesh``,
    each assignment kept only where its dimension divides."""
    from repro_torch.sharding.rules import _sanitize, mesh_shape_of, placements

    return placements(_sanitize(list(clean_spec(spec, mesh.mesh_dim_names)), tuple(t.shape),
                                mesh_shape_of(mesh)), mesh)


def local_region(fn, args, specs, outs):
    """``fn(*args)`` on each rank's local shards: the reference's
    ``shard_map`` counterpart, for the regions DTensor has no strategy for
    (a recurrence, a kernel that takes plain tensors).

    Without DTensor arguments ``fn`` runs as it is.  Otherwise each
    argument is laid out by its spec (``None`` for a non-tensor), every
    assignment kept only where its dimension divides; ``outs`` names, per
    output, the argument whose placements it takes.
    """
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.rules import _sanitize, mesh_shape_of, placements

    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    in_pl, dargs = [], []
    for a, spec in zip(args, specs):
        if spec is None or not isinstance(a, torch.Tensor):
            in_pl.append(None)
            dargs.append(a)
            continue
        if not is_dtensor(a):  # a plain tensor is the same on every rank
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        spec = _sanitize(list(clean_spec(spec, mesh.mesh_dim_names)), tuple(a.shape),
                         mesh_shape_of(mesh))
        in_pl.append(placements(spec, mesh))
        dargs.append(a)
    out_pl = tuple(in_pl[i] if isinstance(i, int) else list(i) for i in outs)
    # A gradient is a partial sum over every mesh dimension along which the
    # region's ranks see different data (an input sharded, an output
    # partial) but this input is replicated.
    split = [any(pl is not None and not pl[d].is_replicate() for pl in in_pl + list(out_pl))
             for d in range(mesh.ndim)]
    grad_pl = tuple(None if pl is None else
                    [Partial() if split[d] and pl[d].is_replicate() else pl[d]
                     for d in range(mesh.ndim)]
                    for pl in in_pl)
    region = local_map(fn, out_placements=out_pl if len(outs) > 1 else out_pl[0],
                       in_placements=tuple(in_pl), in_grad_placements=grad_pl,
                       device_mesh=mesh, redistribute_inputs=True)
    out = region(*dargs)
    if len(outs) == 1:
        return _reduced_grad(out)
    return tuple(_reduced_grad(o) for o in out)


class _ReducedGrad(torch.autograd.Function):
    """Identity whose gradient is reduced to replicated wherever it is a
    partial sum: a region's partial output hands each rank the whole
    upstream gradient (``local_map`` would pass a partial one through as
    it is)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate

        if any(pl.is_partial() for pl in g.placements):
            g = g.redistribute(g.device_mesh, [Replicate() if pl.is_partial() else pl
                                               for pl in g.placements])
        return g


def _reduced_grad(x):
    if is_dtensor(x) and x.requires_grad and any(pl.is_partial() for pl in x.placements):
        return _ReducedGrad.apply(x)
    return x


__all__ = ["clean_spec", "constraint", "current_mesh", "is_dtensor", "local_placements",
           "local_region", "shard_start",
           "use_mesh"]
