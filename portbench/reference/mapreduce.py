"""A MapReduce job's output worked out by counting (see the package doc).

Two layouts: the lexsort shuffle's (one controller, every pair to its
reducer's partition) and the all-to-all shuffle's (W workers, each pair
packed for its reducer's worker, exchanged, then bucketed there), chosen
by :attr:`JobShape.shuffle`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

PAD_KEY = 2**31 - 1
RECORD_WIDTH = 3
_KNUTH = 2654435761
_MASK32 = 0xFFFFFFFF


def hash_to_reducer(keys: torch.Tensor, n_reducers: int) -> torch.Tensor:
    """Knuth's multiplicative hash of the key's low 32 bits, its high half
    folded in by xor, mod R.  The multiplier is split in 16-bit halves, so
    no product leaves int64."""
    k = keys.to(torch.int64) & _MASK32
    h = (k * (_KNUTH & 0xFFFF) + (((k * (_KNUTH >> 16)) & 0xFFFF) << 16)) & _MASK32
    h ^= h >> 16
    return h % n_reducers


def partition_capacity(n_pairs: int, n_buckets: int, factor: float) -> int:
    """Slots per partition: the uniform share times the factor, rounded
    up, at least 1 and at most ``n_pairs``."""
    cap = max(1, int(math.ceil(n_pairs / max(n_buckets, 1) * factor)))
    return min(cap, n_pairs)


@dataclasses.dataclass(frozen=True)
class JobShape:
    """What the reference needs to know of one job."""

    app: str                 # "wordcount" | "exim"
    tokens: int
    mappers: int
    reducers: int
    combiner: bool
    capacity_factor: float
    key_space: int           # the app's key space: the combine's row width
    shuffle: str = "lexsort"  # "lexsort" | "all_to_all"
    workers: int = 1         # W: the all-to-all layout's workers

    @property
    def split(self) -> int:
        return math.ceil(self.tokens / self.mappers)

    @property
    def width(self) -> int:
        """Pairs a map task hands the shuffle: one a token or record
        slot, or with the combiner its distinct keys, cut at the key
        space."""
        return max(1, min(self.split, self.key_space)) if self.combiner else self.split


@dataclasses.dataclass
class Expected:
    """The output a job must give: ``(rows, cols)`` slots, the live ones at
    flat positions ``pos`` (ascending) with ``keys`` and ``vals``, and the
    pairs the capacities drop."""

    rows: int
    cols: int
    pos: np.ndarray
    keys: np.ndarray
    vals: np.ndarray
    dropped: int


@dataclasses.dataclass
class Output:
    """A job's output as the harness reads it back: the same fields as
    :class:`Expected`, plus the dead slots whose value is not 0."""

    rows: int
    cols: int
    pos: np.ndarray
    keys: np.ndarray
    vals: np.ndarray
    dropped: int
    dead_nonzero: int


def task_pairs(corpus: torch.Tensor, app: str, split: int, t: int):
    """Map task ``t``'s pairs in emit order: (keys, values, valid)."""
    n = corpus.shape[0]
    lo, hi = t * split, min(n, (t + 1) * split)
    seg = torch.zeros(split, dtype=torch.int64, device=corpus.device)
    if hi > lo:
        seg[: hi - lo] = corpus[lo:hi]
    live = torch.arange(split, device=corpus.device) < max(0, hi - lo)
    if app == "wordcount":
        return seg, torch.ones_like(seg), live
    if app == "exim":
        n_rec = split // RECORD_WIDTH
        rec = seg[: n_rec * RECORD_WIDTH].reshape(n_rec, RECORD_WIDTH)
        ok = live[: n_rec * RECORD_WIDTH].reshape(n_rec, RECORD_WIDTH).all(1)
        return rec[:, 0], rec[:, 2], ok
    raise ValueError(f"unknown app {app!r}")


def _entries(corpus, job: JobShape):
    """One row per (task, key) that a task emits, in (task, key) order:
    the task, the key, the task's pairs of it and their exact sum, int64."""
    rows = []
    for t in range(job.mappers):
        k, v, ok = task_pairs(corpus, job.app, job.split, t)
        key, inv, count = torch.unique(k[ok], return_inverse=True, return_counts=True)
        total = torch.zeros(len(key), dtype=torch.int64, device=key.device)
        total.index_add_(0, inv, v[ok])
        rows.append((torch.full_like(key, t), key, count, total))
    return [torch.cat(x) for x in zip(*rows)]


def _prefix(corpus, job: JobShape, t: int, key: int, n: int) -> int:
    """The sum of the first ``n`` values of ``key`` in task ``t``."""
    k, v, ok = task_pairs(corpus, job.app, job.split, t)
    return int(v[ok & (k == key)][:n].sum())


def wrap(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Exact int64 sums as a ``bits``-wide two's-complement sum wraps them."""
    half = 1 << (bits - 1)
    return torch.remainder(v + half, 2 * half) - half


def _first(x: torch.Tensor) -> torch.Tensor:
    """Where a run of equal values starts."""
    first = torch.ones_like(x, dtype=torch.bool)
    first[1:] = x[1:] != x[:-1]
    return first


def _units(corpus, job: JobShape):
    """What each map task hands the shuffle, one row per (task, key) in
    (task, key) order: the task, the key, the exact int64 sum of its
    values, and the pairs it makes (its count; with the combiner one,
    or none past the combined row's ``width``)."""
    task, key, count, total = _entries(corpus, job)
    if not job.combiner:
        return task, key, total, count
    # A task's combined row holds its distinct keys ascending, cut at
    # ``width``: one pair per (task, key), its value the task's sum.
    per_task = torch.bincount(task, minlength=job.mappers)
    starts = torch.cumsum(per_task, 0) - per_task
    rank = torch.arange(len(task), device=task.device) - starts[task]
    return task, key, total, (rank < job.width).to(torch.int64)


def _lexorder(*cols) -> torch.Tensor:
    """The order that sorts rows by ``cols``, the first the most
    significant, ties kept in place."""
    order = torch.arange(len(cols[0]), device=cols[0].device)
    for c in reversed(cols):
        order = order[torch.sort(c[order], stable=True).indices]
    return order


def _cut(first: torch.Tensor, n: torch.Tensor, cap: int):
    """Rows in slot order, runs of them sharing a buffer of ``cap``
    slots (``first`` marks where each run starts), row i holding ``n[i]``
    pairs: each row's first slot in its buffer, and the pairs the buffer
    keeps."""
    before = torch.cumsum(n, 0) - n
    start = before - torch.cummax(torch.where(first, before, 0), 0).values
    return start, torch.minimum(torch.clamp(cap - start, min=0), n)


def _layout(corpus, job: JobShape, rows, cap: int, dropped: int) -> Expected:
    """The (R, cap) output from rows in (reducer, key, ...) slot order:
    (task, key, reducer, exact sum, pairs made, first slot, pairs kept).
    Each key's value is the sum of its rows' kept pairs; a row that a cut
    kept in part (only without the combiner) gives its first pairs'
    sum."""
    task, key, rid, total, n, start, kept = rows
    part = torch.where((kept == n) & (kept > 0), total, 0)
    for i in torch.nonzero((kept > 0) & (kept < n)).flatten().tolist():
        part[i] = _prefix(corpus, job, int(task[i]), int(key[i]), int(kept[i]))
    head = _first(key)
    group = torch.cumsum(head, 0) - 1
    n_keys = int(head.sum())
    sums = torch.zeros(n_keys, dtype=torch.int64, device=key.device)
    sums.index_add_(0, group, part)
    live = torch.zeros_like(sums).index_add_(0, group, kept) > 0
    # (reducer, key) order is slot order, so ``pos`` ascends.
    pos = (rid[head] * cap + start[head])[live]
    return Expected(rows=job.reducers, cols=cap, pos=pos.cpu().numpy(),
                    keys=key[head][live].cpu().numpy(),
                    vals=wrap(sums[live], 32).cpu().numpy(), dropped=dropped)


def _check_keys(corpus, job: JobShape) -> None:
    if int(corpus.min()) < 0:
        raise ValueError("the reference orders keys as int64: keys >= 0")
    if job.shuffle not in ("lexsort", "all_to_all"):
        raise ValueError(f"no reference for the {job.shuffle!r} shuffle")


def _lexsort(corpus, job: JobShape) -> Expected:
    # Each reducer's partition holds its keys ascending, equal keys in
    # task order, cut at ``cap``.
    task, key, total, n = _units(corpus, job)
    cap = partition_capacity(job.mappers * job.width, job.reducers, job.capacity_factor)
    rid = hash_to_reducer(key, job.reducers)
    o = _lexorder(rid, key, task)
    task, key, rid, total, n = (x[o] for x in (task, key, rid, total, n))
    start, kept = _cut(_first(rid), n, cap)
    return _layout(corpus, job, (task, key, rid, total, n, start, kept), cap,
                   int(n.sum() - kept.sum()))


def _all_to_all(corpus, job: JobShape):
    """The all-to-all layout's rows in (reducer, key, source, task) slot
    order, its receive capacity, and the (W, W) pairs each worker sends
    each worker.

    Worker w runs map tasks w, w + W, ... and streams their rows in task
    order, ``n_local`` pairs.  It packs them for worker ``reducer % W``,
    each (source, destination) block in (reducer, key, stream) order cut
    at ``partition_capacity(n_local, W, f)``.  Reducer r lives on worker
    r % W at local slot r // W, which buckets what it receives in (key,
    source, stream) order, cut at ``partition_capacity(W n_local, R, f)``.
    """
    M, R, W = job.mappers, job.reducers, job.workers
    task, key, total, n = _units(corpus, job)
    n_local = math.ceil(M / W) * job.width
    send_cap = partition_capacity(n_local, W, job.capacity_factor)
    recv_cap = partition_capacity(W * n_local, R, job.capacity_factor)
    rid = hash_to_reducer(key, R)
    src, dst = task % W, rid % W
    o = _lexorder(src, dst, rid, key, task)
    task, key, rid, total, n, src, dst = (
        x[o] for x in (task, key, rid, total, n, src, dst))
    _, sent = _cut(_first(src * W + dst), n, send_cap)
    matrix = torch.zeros(W * W, dtype=torch.int64, device=key.device)
    matrix = matrix.index_add_(0, src * W + dst, sent).reshape(W, W)
    o = _lexorder(rid, key, src, task)
    task, key, rid, total, n, sent = (x[o] for x in (task, key, rid, total, n, sent))
    start, kept = _cut(_first(rid), sent, recv_cap)
    return (task, key, rid, total, n, start, kept), recv_cap, matrix.cpu().numpy()


def expected(corpus: torch.Tensor, job: JobShape) -> Expected:
    """The job's output, slot for slot, its values summed in int32 as the
    configurations state."""
    _check_keys(corpus, job)
    if job.shuffle == "lexsort":
        return _lexsort(corpus, job)
    rows, cap, _ = _all_to_all(corpus, job)
    n, kept = rows[4], rows[6]
    return _layout(corpus, job, rows, cap, int(n.sum() - kept.sum()))


def sent_pairs(corpus: torch.Tensor, job: JobShape) -> np.ndarray:
    """All-to-all: the (W, W) live pairs worker i sends worker j after the
    send cut, from the corpus and the hash."""
    _check_keys(corpus, job)
    if job.shuffle != "all_to_all":
        raise ValueError("only the all-to-all shuffle sends pairs between workers")
    return _all_to_all(corpus, job)[2]


def mismatches(want: Expected, got: Output) -> int:
    """Slots that differ (a slot live on one side only, or with another
    key or value), dead slots holding a value, and dropped pairs counted
    otherwise."""
    if (got.rows, got.cols) != (want.rows, want.cols):
        return max(1, len(want.pos), len(got.pos))
    if np.array_equal(want.pos, got.pos):
        n = int(np.count_nonzero((want.keys != got.keys) | (want.vals != got.vals)))
    else:
        common, iw, ig = np.intersect1d(want.pos, got.pos, assume_unique=True,
                                        return_indices=True)
        n = len(want.pos) + len(got.pos) - 2 * len(common)
        n += int(np.count_nonzero((want.keys[iw] != got.keys[ig])
                                  | (want.vals[iw] != got.vals[ig])))
    n += int(got.dead_nonzero)
    n += abs(int(got.dropped) - int(want.dropped))
    return n
