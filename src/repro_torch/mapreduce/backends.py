"""Pluggable shuffle/reduce backends (counterpart of ``repro.mapreduce.backends``).

A ``JobConfig`` names its reduce and shuffle backend by string; the
execution backend is a categorical tuning axis with three arms:

* ``torch``          — scatter segment sum/max with ``index_add_`` /
  ``index_reduce_`` (counterpart of the reference's ``jnp``);
* ``scatter_reduce`` — ``Tensor.scatter_reduce`` along each row
  (counterpart of ``xla``);
* ``cuda``           — the hand-written Hopper ``segment_reduce`` and
  ``local_reduce`` kernels (counterpart of ``pallas``), ``sum`` only.
  They accumulate in int32, so unlike the Pallas kernel (exact below
  2**24 only) they equal ``torch`` / the reference's ``jnp`` at every size.

Shuffle backends: ``lexsort`` (global sort by (reducer, key) +
capacity-bounded scatter).  ``all_to_all`` is ported by a later slice.
"""

from __future__ import annotations

import torch

from repro_torch.mapreduce import phases
from repro_torch.mapreduce.phases import (
    INT32_MIN,
    PAD_KEY,
    bucket_scatter,
    hash_to_reducer,
)


class ReduceBackend:
    """Per-partition sorted segment aggregation.

    ``reduce(keys, values, reduce_op)`` takes (N, C) int32 blocks, each row
    sorted by key with PAD_KEY padding, and returns (out_keys, out_vals)
    of the same shape: each equal-key run's aggregate at its first
    occurrence, (PAD_KEY, 0) elsewhere.

    ``combine`` is the map-side variant: the same aggregates, front-packed
    in ascending key order with a (PAD_KEY, 0) tail.  The default sorts the
    sparse ``reduce`` output (first occurrences of a sorted row are
    ascending and distinct, so the sort is the compaction).
    """

    name: str = "abstract"
    supported_ops: tuple[str, ...] = ()

    def reduce(self, keys, values, reduce_op: str):
        raise NotImplementedError

    def combine(self, keys, values, reduce_op: str):
        ok, ov = self.reduce(keys, values, reduce_op)
        ok, order = torch.sort(ok, dim=1, stable=True)  # PAD_KEY sorts last
        return ok, ov.gather(1, order)


class TorchReduceBackend(ReduceBackend):
    """Scatter segment reduce over a flat buffer (the portable reference)."""

    name = "torch"
    supported_ops = ("sum", "max", "first")

    def reduce(self, keys, values, reduce_op: str):
        ok, ov, _ = phases.segment_sum_sorted(
            keys, values, keys != PAD_KEY, reduce_op
        )
        return ok, ov


class ScatterReduceBackend(ReduceBackend):
    """Row-wise ``Tensor.scatter_reduce`` segment reduce."""

    name = "scatter_reduce"
    supported_ops = ("sum", "max", "first")

    def reduce(self, keys, values, reduce_op: str):
        valid = keys != PAD_KEY
        first = phases.run_heads(keys, valid)
        seg = phases.segment_ids(first, valid)
        if reduce_op == "sum":
            src, how, fill = torch.where(valid, values, 0), "sum", 0
        elif reduce_op == "max":
            src, how, fill = torch.where(valid, values, INT32_MIN), "amax", INT32_MIN
        elif reduce_op == "first":
            # Delivery order is the stable sort order, so each run's first
            # value already sits at its first-occurrence slot.
            src, how, fill = torch.where(first, values, 0), "sum", 0
        else:
            raise ValueError(reduce_op)
        agg = torch.full_like(values, fill).scatter_reduce(1, seg, src, how)
        out_k = torch.where(first, keys, PAD_KEY)
        out_v = torch.where(first, agg.gather(1, seg), 0)
        return out_k, out_v


class CudaReduceBackend(ReduceBackend):
    """The hand-written Hopper kernels: ``segment_reduce`` for the reduce
    waves and ``local_reduce`` for the combine barrier.

    On a CPU tensor each kernel's wrapper runs its plain PyTorch version;
    on a CUDA tensor it launches the kernel or raises.
    """

    name = "cuda"
    supported_ops = ("sum",)

    def _check(self, reduce_op: str):
        if reduce_op not in self.supported_ops:
            raise ValueError(
                f"cuda reduce backend supports {self.supported_ops}, "
                f"got {reduce_op!r}"
            )

    def reduce(self, keys, values, reduce_op: str):
        self._check(reduce_op)
        from repro_torch.kernels.segment_reduce import segment_reduce

        return segment_reduce(keys, values)

    def combine(self, keys, values, reduce_op: str):
        self._check(reduce_op)
        from repro_torch.kernels.local_reduce import local_reduce

        return local_reduce(keys, values)


class ShuffleBackend:
    """Routes map-output pairs into per-reduce-task partitions.

    ``partition`` sees the job's full flat pair stream and returns global
    (R_pad, cap) partitions plus a ``dropped`` overflow count.
    """

    name: str = "abstract"

    def partition(self, cfg, keys, values, pvalid):
        raise NotImplementedError


class LexsortShuffle(ShuffleBackend):
    """Single-controller shuffle: global sort by (reducer, key) + scatter."""

    name = "lexsort"

    def partition(self, cfg, keys, values, pvalid):
        """keys/values/pvalid: flat (n,).  Returns (part_keys, part_vals,
        dropped) with partitions of shape (reduce_waves * W, cap)."""
        R, W = cfg.num_reducers, cfg.num_workers
        n = keys.shape[0]
        rid = hash_to_reducer(keys, R)
        rid = torch.where(pvalid, rid, R)  # invalid pairs -> OOB dump row
        # jnp.lexsort((keys, rid)): reducer first, then key, stable.  One
        # stable sort of the packed int64 (rid, key + 2**31) is the same order.
        packed = (rid.to(torch.int64) << 32) | (keys.to(torch.int64) + 2**31)
        _, order = torch.sort(packed, stable=True)
        skeys, svals, srid = keys[order], values[order], rid[order]
        cap = phases.partition_capacity(n, R, cfg.capacity_factor)
        R_pad = cfg.reduce_waves * W
        (part_keys, part_vals), dropped = bucket_scatter(
            srid, R, R_pad, cap, (skeys, svals), (PAD_KEY, 0)
        )
        return part_keys, part_vals, dropped


REDUCE_BACKENDS: dict[str, ReduceBackend] = {}
SHUFFLE_BACKENDS: dict[str, ShuffleBackend] = {}

#: shuffle backends of the reference that a later slice of the port brings
#: over (ROADMAP.md, queue 1): a config may name them, ``build_job`` refuses.
UNPORTED_SHUFFLE_BACKENDS = {"all_to_all": "queue 1, item 6 (all-to-all shuffle)"}


def register_reduce_backend(backend: ReduceBackend) -> ReduceBackend:
    if not backend.supported_ops:
        raise ValueError(f"backend {backend.name!r} supports no reduce ops")
    REDUCE_BACKENDS[backend.name] = backend
    return backend


def register_shuffle_backend(backend: ShuffleBackend) -> ShuffleBackend:
    SHUFFLE_BACKENDS[backend.name] = backend
    return backend


register_reduce_backend(TorchReduceBackend())
register_reduce_backend(CudaReduceBackend())
register_reduce_backend(ScatterReduceBackend())
register_shuffle_backend(LexsortShuffle())


def get_reduce_backend(name: str) -> ReduceBackend:
    try:
        return REDUCE_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown reduce backend {name!r}; "
            f"registered: {sorted(REDUCE_BACKENDS)}"
        ) from None


def get_shuffle_backend(name: str) -> ShuffleBackend:
    try:
        return SHUFFLE_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown shuffle backend {name!r}; "
            f"registered: {sorted(SHUFFLE_BACKENDS)}"
        ) from None
