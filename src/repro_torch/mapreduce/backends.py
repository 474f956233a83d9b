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

Shuffle backends:

* ``lexsort``    — single controller: each task row split by reducer and
  the rows' sorted runs merged into capacity-bounded partitions (the
  ``shuffle_merge`` kernels; on the CPU a global sort by (reducer, key) +
  capacity-bounded scatter);
* ``all_to_all`` — per-worker partition by destination + an all-to-all
  exchange: ``torch.distributed.all_to_all_single`` in the plan's sharded
  mode, the block transpose it implements in the emulated modes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.shuffle_merge import shuffle_merge
from repro_torch.mapreduce import phases
from repro_torch.mapreduce.phases import (
    INT32_MIN,
    PAD_KEY,
    bucket_scatter,
    hash_to_reducer,
)
from repro_torch.mapreduce.spans import span


class ReduceBackend:
    """Per-partition sorted segment aggregation.

    ``reduce(keys, values, reduce_op, addend=None, out=None)`` takes (N, C)
    int32 blocks, each row sorted by key with PAD_KEY padding, and returns
    (out_keys, out_vals) of the same shape: each equal-key run's aggregate
    at its first occurrence, plus its row's entry of the optional (N,)
    int32 ``addend``, and (PAD_KEY, 0) elsewhere.  ``out``, an optional
    pair of (N, C) int32 tensors, receives the results and is returned: a
    reduce wave passes its rows of the reduce outputs.  ``key_sums`` gives
    each row's exact int64 key sum, PAD tail included, which seeds a reduce
    task's startup.

    ``combine`` is the map-side variant: the same aggregates, front-packed
    in ascending key order with a (PAD_KEY, 0) tail.  The default sorts the
    sparse ``reduce`` output (first occurrences of a sorted row are
    ascending and distinct, so the sort is the compaction).
    """

    name: str = "abstract"
    supported_ops: tuple[str, ...] = ()

    def reduce(self, keys, values, reduce_op: str, addend=None, out=None):
        raise NotImplementedError

    def key_sums(self, keys):
        return keys.sum(dim=1)

    def combine(self, keys, values, reduce_op: str):
        ok, ov = self.reduce(keys, values, reduce_op)
        ok, order = torch.sort(ok, dim=1, stable=True)  # PAD_KEY sorts last
        return ok, ov.gather(1, order)


def _finish(out_keys, out_vals, addend, out):
    """A reduce's aggregates with the addend on their live slots, written
    into ``out`` when it is given."""
    if addend is not None:
        out_vals = out_vals + torch.where(out_keys != PAD_KEY, addend[:, None], 0)
    if out is None:
        return out_keys, out_vals
    out[0].copy_(out_keys)
    out[1].copy_(out_vals)
    return tuple(out)


class TorchReduceBackend(ReduceBackend):
    """Scatter segment reduce over a flat buffer (the portable reference)."""

    name = "torch"
    supported_ops = ("sum", "max", "first")

    def reduce(self, keys, values, reduce_op: str, addend=None, out=None):
        ok, ov, _ = phases.segment_sum_sorted(
            keys, values, keys != PAD_KEY, reduce_op
        )
        return _finish(ok, ov, addend, out)


class ScatterReduceBackend(ReduceBackend):
    """Row-wise ``Tensor.scatter_reduce`` segment reduce."""

    name = "scatter_reduce"
    supported_ops = ("sum", "max", "first")

    def reduce(self, keys, values, reduce_op: str, addend=None, out=None):
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
        return _finish(out_k, out_v, addend, out)


class CudaReduceBackend(ReduceBackend):
    """The hand-written Hopper kernels: ``segment_reduce`` (and its
    ``row_key_sums``) for the reduce waves and ``local_reduce`` for the
    combine barrier.

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

    def reduce(self, keys, values, reduce_op: str, addend=None, out=None):
        self._check(reduce_op)
        from repro_torch.kernels.segment_reduce import segment_reduce

        return segment_reduce(keys, values, out=out, addend=addend)

    def key_sums(self, keys):
        from repro_torch.kernels.segment_reduce import row_key_sums

        return row_key_sums(keys)

    def combine(self, keys, values, reduce_op: str):
        self._check(reduce_op)
        from repro_torch.kernels.local_reduce import local_reduce

        return local_reduce(keys, values)


class ShuffleBackend:
    """Routes map-output pairs into per-reduce-task partitions.

    Two families share this interface:

    * non-collective (``collective = False``): :meth:`partition` sees the
      job's full flat pair stream and returns global (R_pad, cap)
      partitions;
    * collective (``collective = True``): :meth:`exchange` runs on one
      worker's local pairs inside a process group and returns the
      (slots, cap) reduce buckets the worker owns after the exchange.

    Both return a ``dropped`` count for capacity-overflow accounting.
    """

    name: str = "abstract"
    collective: bool = False

    def partition(self, cfg, keys, values, pvalid):
        raise NotImplementedError(f"{self.name} is not a global shuffle")

    def exchange(self, cfg, group, keys, values, pvalid):
        raise NotImplementedError(f"{self.name} is not a collective shuffle")

    def capacity_for(self, cfg, n_pairs: int) -> int:
        """Per-partition slot capacity for a job with ``n_pairs`` map-output
        pairs; the telemetry layer sizes its counters from it."""
        return phases.partition_capacity(
            n_pairs, cfg.num_reducers, cfg.capacity_factor
        )


def _stable_order(primary, keys):
    """``jnp.lexsort((keys, primary))`` along the last axis: one stable sort
    of the packed int64 (primary, key + 2**31); equal keys keep their input
    order, which is the order their values reach the reduce buckets."""
    packed = (primary.to(torch.int64) << 32) | (keys.to(torch.int64) + 2**31)
    return torch.sort(packed, dim=-1, stable=True).indices


class LexsortShuffle(ShuffleBackend):
    """Single-controller shuffle: every pair to its reducer's partition in
    (key, stream position) order.  On the card the ``shuffle_merge``
    kernels split each task row by reducer and merge the rows' sorted
    runs; on CPU and meta tensors :func:`lexsort_partition` sorts globally
    by (reducer, key) and scatters."""

    name = "lexsort"

    def partition(self, cfg, keys, values, pvalid):
        """keys/values/pvalid: (N, C) task rows read as one flat (N C,)
        stream, or on CPU and meta tensors (n,) too.  Returns (part_keys,
        part_vals, dropped) with partitions of shape (reduce_waves * W,
        cap).

        Precondition on the card: each row's valid pairs are
        non-decreasing in key.  ``plan._lexsort_shuffle_fn`` is the only
        caller, and the map's stable spill sort (``phases.run_map_task``)
        and the combine (front-packed ascending rows) guarantee it."""
        R = cfg.num_reducers
        cap = phases.partition_capacity(keys.numel(), R, cfg.capacity_factor)
        n_rows = cfg.reduce_waves * cfg.num_workers
        if keys.device.type != "cuda":
            return lexsort_partition(keys, values, pvalid, R, cap, n_rows)
        return shuffle_merge(keys, values, pvalid, R, cap, n_rows,
                             stage_range=lambda stage: span(f"mapreduce.shuffle.{stage}"))


def lexsort_partition(keys, values, pvalid, R: int, cap: int, n_rows: int | None = None):
    """The lexsort shuffle in plain PyTorch, the ``shuffle_merge`` kernels'
    contract: keys/values int32 and pvalid bool of one shape, read as one
    flat stream.  Returns (part_keys, part_vals, dropped): (n_rows, cap)
    int32 partitions (``n_rows`` defaults to R), partition r holding the
    valid pairs whose reducer is r in (key, stream position) order, cut at
    ``cap`` with a (PAD_KEY, 0) tail, and ``dropped`` the int32 count of
    the cut pairs."""
    n_rows = R if n_rows is None else n_rows
    with span("mapreduce.shuffle.sort"):
        # Combined task rows are column slices: flattening them copies.
        keys, values, pvalid = (a.reshape(-1) for a in (keys, values, pvalid))
        rid = hash_to_reducer(keys, R)
        rid = torch.where(pvalid, rid, R)  # invalid pairs -> OOB dump row
        order = _stable_order(rid, keys)  # reducer first, then key
    with span("mapreduce.shuffle.gather"):
        skeys, svals, srid = keys[order], values[order], rid[order]
    with span("mapreduce.shuffle.scatter"):
        (part_keys, part_vals), dropped = bucket_scatter(
            srid, R, n_rows, cap, (skeys, svals), (PAD_KEY, 0)
        )
    return part_keys, part_vals, dropped


class AllToAllShuffle(ShuffleBackend):
    """Per-worker partition by destination + all-to-all exchange.

    Reducer r lives on worker r % W; after the exchange each worker buckets
    its received pairs into the ``reduce_waves`` reduce slots it owns
    (local slot r // W).  The worker-local halves :meth:`pack` (before the
    exchange) and :meth:`unpack` (after it) take a leading worker axis, so
    the emulated modes run every worker in one call and put the block
    transpose the collective implements between them; :meth:`exchange`
    runs one worker's halves around ``all_to_all_single``.
    """

    name = "all_to_all"
    collective = True

    def pack(self, cfg, keys, values, pvalid):
        """Pre-exchange half: partition each worker's (B, n_local) pairs by
        destination worker.  Returns ((send_k, send_v, send_r), dropped)
        with (B, W, shuf_cap) send buffers, row i of a worker's going to
        worker i, and the (B,) counts lost to send-buffer overflow."""
        R, W = cfg.num_reducers, cfg.num_workers
        n_local = keys.shape[-1]
        # Per (src, dst) capacity: uniform share x safety factor.
        shuf_cap = phases.partition_capacity(n_local, W, cfg.capacity_factor)
        with span("mapreduce.shuffle.pack"):
            rid = torch.where(pvalid, hash_to_reducer(keys, R), R)
            dst = torch.where(pvalid, rid % W, W)
            # Destination, then reducer, then key: dst = rid % W for live
            # pairs and (W, R) for dead ones, so dst * (R + 1) + rid orders
            # both.
            order = _stable_order(dst.to(torch.int64) * (R + 1) + rid, keys)
            k, v, rid, dst = (a.gather(-1, order) for a in (keys, values, rid, dst))
            (send_k, send_v, send_r), send_dropped = bucket_scatter(
                dst, W, W, shuf_cap, (k, v, rid), (PAD_KEY, 0, R)
            )
        return (send_k, send_v, send_r), send_dropped

    def unpack(self, cfg, n_local, rk, rv, rr):
        """Post-exchange half: bucket each worker's received (B, n_recv)
        pairs into its reduce slots (local slot rid // W).  ``n_local`` is
        the per-worker map-output pair count, which sizes the bucket
        capacity alike on every worker.  Returns ((bk, bv), dropped) with
        (B, reduce_waves, red_cap) buckets and (B,) overflow counts."""
        R, W, waves_r = cfg.num_reducers, cfg.num_workers, cfg.reduce_waves
        red_cap = phases.partition_capacity(W * n_local, R, cfg.capacity_factor)
        with span("mapreduce.shuffle.unpack"):
            lslot = torch.where(rr < R, rr // W, waves_r)
            order = _stable_order(lslot, rk)
            rk, rv, lslot = (a.gather(-1, order) for a in (rk, rv, lslot))
            (bk, bv), recv_dropped = bucket_scatter(
                lslot, waves_r, waves_r, red_cap, (rk, rv), (PAD_KEY, 0)
            )
        return (bk, bv), recv_dropped

    @staticmethod
    def live_width(cfg, send_r, group=None) -> int:
        """The longest live prefix of any (src, dst) send block, across
        ``group``'s ranks when given.  :meth:`pack` front-packs each block
        (its dead slots carry reducer id R), so cutting every block there
        changes no bucket and no count, and spares the exchange and the
        unpack's sort the dead tail: at capacity factor 4 and W = 4 about
        three quarters of the slots.  One host read (and one all-reduce)."""
        import torch.distributed as dist

        width = (send_r < cfg.num_reducers).sum(-1).max()
        if group is not None:
            dist.all_reduce(width, op=dist.ReduceOp.MAX, group=group)
        return max(1, int(width))

    def exchange(self, cfg, group, keys, values, pvalid):
        """One worker's flat (n_local,) pairs through the exchange on
        ``group`` (``cfg.num_workers`` ranks, this one among them).

        Keys, values and reducer ids travel as one packed (W, 3, width)
        int32 tensor in a single ``all_to_all_single``, ``width`` the
        blocks' longest live prefix (:meth:`live_width`): row i goes to
        rank i, and the received rows stack in source order.  Returns
        (bucket_keys, bucket_vals, dropped) with (reduce_waves, red_cap)
        buckets and ``dropped`` the (2,) ``[send, recv]`` overflow counts.
        """
        import torch.distributed as dist

        n_local = keys.shape[0]
        (send_k, send_v, send_r), send_dropped = self.pack(
            cfg, keys[None], values[None], pvalid[None]
        )
        with span("mapreduce.shuffle.exchange"):
            width = self.live_width(cfg, send_r, group)
            send = torch.stack([s[0, :, :width] for s in (send_k, send_v, send_r)],
                               dim=1)
            recv = torch.empty_like(send)
            dist.all_to_all_single(recv, send, group=group)
        (bk, bv), recv_dropped = self.unpack(
            cfg, n_local,
            *(recv[:, i].reshape(1, -1) for i in range(3)),
        )
        return bk[0], bv[0], torch.cat([send_dropped, recv_dropped])


REDUCE_BACKENDS: dict[str, ReduceBackend] = {}
SHUFFLE_BACKENDS: dict[str, ShuffleBackend] = {}


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
register_shuffle_backend(AllToAllShuffle())


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
