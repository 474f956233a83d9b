"""A MapReduce job's output worked out by counting (see the package doc)."""

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
    """What the reference needs to know of one job (lexsort shuffle)."""

    app: str                 # "wordcount" | "exim"
    tokens: int
    mappers: int
    reducers: int
    combiner: bool
    capacity_factor: float
    key_space: int           # the app's key space: the combine's row width

    @property
    def split(self) -> int:
        return math.ceil(self.tokens / self.mappers)


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


def expected(corpus: torch.Tensor, job: JobShape) -> Expected:
    """The job's output, slot for slot, its values summed in int32 as the
    configurations state."""
    if int(corpus.min()) < 0:
        raise ValueError("the reference orders keys as int64: keys >= 0")
    M, R = job.mappers, job.reducers
    if R * M >= 2**32:
        raise ValueError("(reducer, key, task) must pack into one int64")
    task, key, count, total = _entries(corpus, job)
    width = job.split  # one pair per token or record slot
    if job.combiner:
        width = max(1, min(width, job.key_space))
        # A task's combined row holds its distinct keys ascending, cut at
        # ``width``: one entry per (task, key), its value the task's sum.
        starts = torch.cumsum(torch.bincount(task, minlength=M), 0)
        starts = starts - torch.bincount(task, minlength=M)
        rank = torch.arange(len(task), device=task.device) - starts[task]
        entries = (rank < width).to(torch.int64)
    else:
        entries = count
    cap = partition_capacity(M * width, R, job.capacity_factor)

    # Each reducer's bucket holds its keys ascending, equal keys in task
    # order, cut at ``cap``: an entry's first slot is the running sum of
    # the entries before it in (reducer, key, task) order, from its
    # reducer's first.
    rid = hash_to_reducer(key, R)
    order = torch.argsort((rid * 2**31 + key) * M + task)
    task, key, rid, total, entries = (x[order] for x in (task, key, rid, total, entries))
    before = torch.cumsum(entries, 0) - entries
    base = torch.cummax(torch.where(_first(rid), before, 0), 0).values
    start = before - base
    kept = torch.minimum(torch.clamp(cap - start, min=0), entries)
    dropped = int(entries.sum() - kept.sum())

    # Each key's value: the sums of its tasks' kept entries; a task whose
    # run the capacity cut (only without the combiner) gives its prefix.
    part = torch.where((kept == entries) & (kept > 0), total, 0)
    for i in torch.nonzero((kept > 0) & (kept < entries)).flatten().tolist():
        part[i] = _prefix(corpus, job, int(task[i]), int(key[i]), int(kept[i]))
    head = _first(key)
    group = torch.cumsum(head, 0) - 1
    n_keys = int(head.sum())
    sums = torch.zeros(n_keys, dtype=torch.int64, device=key.device).index_add_(0, group, part)
    live = torch.zeros_like(sums).index_add_(0, group, kept) > 0
    # (reducer, key) order is slot order, so ``pos`` ascends.
    pos = (rid[head] * cap + start[head])[live]
    return Expected(rows=R, cols=cap, pos=pos.cpu().numpy(),
                    keys=key[head][live].cpu().numpy(),
                    vals=wrap(sums[live], 32).cpu().numpy(), dropped=dropped)


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
