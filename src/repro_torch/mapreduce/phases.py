"""Shared MapReduce phase primitives (counterpart of ``repro.mapreduce.phases``).

* :func:`task_setup`         — fixed per-task startup compute (JVM analogue);
* :func:`hash_to_reducer`    — Knuth multiplicative key hashing in uint32;
* :func:`segment_sum_sorted` — sorted equal-key aggregation (sum/max/first);
* :func:`run_map_task`       — setup + ``map_fn`` + local spill sort
  (the ``spill_sort`` kernel on the card, :func:`spill_sort_plain` else);
* :func:`map_phase`          — map tasks over a (waves, W) task grid;
* :func:`combine_rows`       — map-side combine of spill-sorted task rows;
* :func:`bucket_scatter`     — capacity-bounded partition scatter that
  counts its overflow in ``dropped``;
* :func:`reduce_wave`        — a wave of reduce tasks into its output rows;
* :func:`reduce_local`       — one worker's reduce slots, one at a time.

Every function works on a batch of tasks written out as the leading
dimension, where the reference ``vmap``s a one-task function.  Values are
int32 throughout and equal the reference's bit for bit.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.spill_sort import spill_sort
from repro_torch.mapreduce.spans import span

PAD_KEY = 2**31 - 1  # int32 max: sorts to the end
INT32_MIN = -(2**31)

#: bytes per (key, value) pair moving between phases: two int32s.
PAIR_BYTES = 8

#: reduce ops safe to pre-aggregate map-side (commutative + associative);
#: ``first`` depends on delivery order, so the plan rejects it with the
#: combiner on.
COMBINABLE_OPS = ("sum", "max")

_KNUTH = 2654435761
_MASK32 = 0xFFFFFFFF


def task_setup(dim: int, rounds: int, seed_val: torch.Tensor) -> torch.Tensor:
    """Fixed per-task startup compute for a batch of tasks.

    seed_val: (B,) integer tensor, one seed per task.  Runs a short chain of
    batched (dim x dim) matmuls seeded by the task's data, so the work
    cannot be skipped; the (B,) float32 result is about 1e-17 and casts to
    int32 0, so adding it keeps the values exact.
    """
    dev = seed_val.device
    x = torch.full(
        (seed_val.shape[0], dim, dim), 1e-3, dtype=torch.float32, device=dev
    ) + seed_val.to(torch.float32)[:, None, None] * 1e-9
    w = torch.eye(dim, dtype=torch.float32, device=dev) * 0.999
    for _ in range(rounds):
        x = torch.tanh(torch.matmul(x, w))
    return x.sum(dim=(1, 2)) * 1e-20


def hash_to_reducer(keys: torch.Tensor, num_reducers: int) -> torch.Tensor:
    """Knuth multiplicative hash in uint32, then mod R (int32 result).

    Computed in int64 on the key's low 32 bits, so negative keys wrap as
    ``astype(uint32)`` wraps them.  The product is split into 16-bit halves
    so that it never leaves int64's range.
    """
    k = keys.to(torch.int64) & _MASK32
    lo, hi = k & 0xFFFF, k >> 16
    h = (lo * _KNUTH + (((hi * _KNUTH) & 0xFFFF) << 16)) & _MASK32
    h = h ^ (h >> 16)
    return (h % num_reducers).to(torch.int32)


def run_heads(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """First occurrence of each equal-key run of (N, C) sorted rows."""
    first = valid.clone()
    first[:, 1:] &= keys[:, 1:] != keys[:, :-1]
    return first


def segment_ids(first: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Run index of every live slot; dead slots go to the last column."""
    C = first.shape[1]
    seg = torch.cumsum(first, dim=1, dtype=torch.int64) - 1
    return torch.where(valid, seg, C - 1)


def segment_sum_sorted(keys, values, valid, reduce_op: str = "sum"):
    """Aggregate values of equal adjacent keys in (N, C) key-sorted rows.

    Returns (out_keys, out_vals, first): each run's aggregate at its first
    occurrence, (PAD_KEY, 0) elsewhere.  Aggregation is a scatter into a
    flat (N*C,) buffer with ``index_add_`` / ``index_reduce_``.
    """
    N, C = keys.shape
    first = run_heads(keys, valid)
    seg = segment_ids(first, valid)
    flat = (seg + torch.arange(N, device=keys.device)[:, None] * C).reshape(-1)
    if reduce_op == "sum":
        agg = torch.zeros(N * C, dtype=values.dtype, device=keys.device)
        agg.index_add_(0, flat, torch.where(valid, values, 0).reshape(-1))
    elif reduce_op == "max":
        agg = torch.full(
            (N * C,), INT32_MIN, dtype=values.dtype, device=keys.device
        )
        agg.index_reduce_(
            0, flat, torch.where(valid, values, INT32_MIN).reshape(-1),
            "amax",
        )
    elif reduce_op == "first":
        # The stable sorts upstream put each run's earliest delivered value
        # at its first-occurrence slot, so the aggregate is that value.
        agg = torch.zeros(N * C, dtype=values.dtype, device=keys.device)
        agg.index_add_(0, flat, torch.where(first, values, 0).reshape(-1))
    else:
        raise ValueError(reduce_op)
    out_keys = torch.where(first, keys, PAD_KEY)
    out_vals = torch.where(first, agg[flat].reshape(N, C), 0)
    return out_keys, out_vals, first


def spill_sort_plain(keys, values, pvalid, addend, out=None):
    """The map's local spill sort in plain PyTorch, the ``spill_sort``
    kernel's contract: (N, C) rows sorted stably by their masked key
    (PAD_KEY where not valid), which ``first`` relies on, as
    ``jnp.argsort`` does; keys, values and pvalid gathered through the
    order, and ``addend`` (N,) int32 added to every value.  ``out``, an
    optional (keys, values, pvalid) triple of the rows' shape, receives
    the result and is returned."""
    _, order = torch.sort(
        torch.where(pvalid, keys, PAD_KEY), dim=1, stable=True
    )
    keys = keys.gather(1, order)
    values = values.gather(1, order)
    pvalid = pvalid.gather(1, order)
    values = values + addend[:, None]
    if out is None:
        return keys, values, pvalid
    for o, x in zip(out, (keys, values, pvalid)):
        o.copy_(x)
    return tuple(out)


def run_map_task(app, cfg, tokens, valid, out=None, sort_passes=None):
    """A batch of map tasks: startup + ``map_fn`` + local spill sort.

    tokens/valid: (W, S).  Returns keys/values/pvalid of shape (W, P), in
    ``out`` when given (rows of the map's accumulators).  Each task's
    startup value (0 as an int32) is added to its values by the sort.  On
    the card the sort is the ``spill_sort`` kernel, which adds the radix
    passes it ran to ``sort_passes`` (an int32 device scalar) when given;
    CPU and meta tensors take :func:`spill_sort_plain`.
    """
    setup = task_setup(cfg.setup_dim, cfg.setup_rounds, tokens.sum(dim=1))
    keys, values, pvalid = app.map_fn(tokens, valid)
    addend = setup.to(torch.int32)  # keep setup live
    with span("mapreduce.map.spill_sort"):
        if keys.device.type == "cuda":
            return spill_sort(keys, values, pvalid, addend, out, sort_passes)
        return spill_sort_plain(keys, values, pvalid, addend, out)


def map_phase(app, cfg, splits, split_valid):
    """Map tasks in waves of W workers, one wave after another.

    splits/split_valid: (waves, W, S).  Returns keys/values/valid of shape
    (waves, W, P).
    """
    outs = []
    for i, (t, m) in enumerate(zip(splits, split_valid)):
        with span("mapreduce.map.wave", i):
            outs.append(run_map_task(app, cfg, t, m))
    return tuple(torch.stack(x) for x in zip(*outs))


def partition_capacity(n_pairs: int, n_buckets: int, factor: float) -> int:
    """Capacity per partition: uniform share x safety factor, clamped."""
    cap = max(1, int(math.ceil(n_pairs / max(n_buckets, 1) * factor)))
    return min(cap, n_pairs)


def combine_capacity(n_pairs: int, key_space: int) -> int:
    """Static per-task combined-row width: at most ``min(n_pairs,
    key_space)`` distinct keys, so truncating there is lossless."""
    return max(1, min(int(n_pairs), int(key_space)))


def combine_rows(backend, keys, values, pvalid, reduce_op: str, cap: int):
    """Map-side combine over (N, P) spill-sorted task rows.

    Dead slots are masked to (PAD_KEY, 0) first; the backend's ``combine``
    front-packs each row's aggregates in ascending key order, and the
    ``[:cap]`` truncation then drops only dead tail slots.  Returns
    (ck, cv, cvalid) of shape (N, cap).
    """
    km = torch.where(pvalid, keys, PAD_KEY)
    vm = torch.where(pvalid, values, 0)
    ck, cv = backend.combine(km, vm, reduce_op)
    ck, cv = ck[:, :cap], cv[:, :cap]
    return ck, cv, ck != PAD_KEY


def bucket_scatter(ids, n_buckets, n_rows, cap, arrays, fills):
    """Capacity-bounded scatter into fixed (n_rows, cap) partitions.

    ids: (n,) integer, **sorted ascending**, or (B, n) with each row sorted
    (B independent scatters, as the reference ``vmap``s one); ids >=
    n_buckets mark invalid entries.  Each of the parallel ``arrays`` is
    scattered to ``out[id, position-within-bucket]`` over a buffer filled
    with its ``fills`` entry.  Returns (list of (n_rows, cap) tensors,
    dropped), or (B, n_rows, cap) tensors and a (B,) ``dropped``,
    ``dropped`` counting valid entries lost to capacity overflow.
    """
    if ids.dim() == 1:
        outs, dropped = bucket_scatter(
            ids[None], n_buckets, n_rows, cap, [a[None] for a in arrays], fills
        )
        return [o[0] for o in outs], dropped[0]
    dev = ids.device
    B, n = ids.shape
    ids = ids.to(torch.int64)
    start = torch.searchsorted(
        ids, torch.arange(n_buckets + 1, device=dev).expand(B, -1).contiguous(),
        side="left",
    )
    pos = torch.arange(n, device=dev) - start.gather(1, ids.clamp(0, n_buckets))
    valid = ids < n_buckets
    dropped = ((pos >= cap) & valid).sum(dim=1).to(torch.int32)
    # Entries that land nowhere go to a spare row n_rows, cut off below: the
    # reference's ``mode="drop"`` without the host sync a boolean mask costs.
    row = torch.where(valid & (pos < cap), ids, n_rows)
    col = pos.clamp(0, cap - 1)
    batch = torch.arange(B, device=dev)[:, None]
    outs = []
    for arr, fill in zip(arrays, fills):
        buf = torch.full((B, n_rows + 1, cap), fill, dtype=arr.dtype, device=dev)
        buf[batch, row, col] = arr
        outs.append(buf[:, :n_rows])
    return outs, dropped


def reduce_wave(cfg, backend, reduce_op, keys, values, out_keys, out_vals):
    """One wave of n reduce tasks, reduced straight into their output rows.

    keys/values: the wave's (n, cap) partition rows, each key-sorted with a
    PAD_KEY tail; out_keys/out_vals: the (n, cap) rows of the reduce
    outputs it fills.  Each task's startup (:func:`task_setup`) is seeded
    by its row's exact int64 key sum, PAD tail included (the backend's
    ``key_sums``), and its int32 value (0) is the ``addend`` of the
    backend's one :meth:`~repro_torch.mapreduce.backends.ReduceBackend.reduce`
    call, which writes the rows.
    """
    setup = task_setup(cfg.setup_dim, cfg.setup_rounds, backend.key_sums(keys))
    backend.reduce(keys, values, reduce_op, addend=setup.to(torch.int32),
                   out=(out_keys, out_vals))


def reduce_local(app, cfg, part_keys, part_vals, backend):
    """One worker's reduce slots run one at a time, as a worker runs its
    waves: one wave of one task a slot.

    part_keys/part_vals: (slots, cap).  Returns out_keys/out_vals of the
    same shape.
    """
    out_keys, out_vals = torch.empty_like(part_keys), torch.empty_like(part_vals)
    for i in range(part_keys.shape[0]):
        with span("mapreduce.reduce.wave", i):
            reduce_wave(cfg, backend, app.reduce_op, part_keys[i:i + 1],
                        part_vals[i:i + 1], out_keys[i:i + 1], out_vals[i:i + 1])
    return out_keys, out_vals
