"""Execution plan and its modes (counterpart of ``repro.mapreduce.plan``).

:class:`ExecutionPlan` lowers one ``(MapReduceApp, JobConfig, input_len)``
into wave steppers over task-major buffers:

* ``prep(tokens)``                      → ``(splits (M, S), valid (M, S))``
* ``map_step(W)(splits, valid, bk, bv, bp, start)`` → the ``(M, P)``
  accumulators with one wave of W map tasks written in;
* ``combine_step()(bk, bv, bp)``        → compacted ``(M, Pc)`` task rows
  (only when ``cfg.combiner``), ``Pc = min(P, key_space)``;
* ``shuffle_step(W)(bk, bv, bp)``       → ``(pk, pv, dropped, ok, ov)`` with
  ``(R, cap)`` partitions and the reduce phase's output buffers; the
  ``lexsort`` backend uses the W-independent ``cap =
  partition_capacity(M·Pc, R, f)``, the ``all_to_all`` backend the layout
  of a real W-worker run (its pack and unpack halves over a worker axis,
  the collective replaced by the block transpose it implements);
* ``reduce_step(W)(pk, pv, ok, ov, start)`` → the ``(R, cap)`` outputs with
  one wave of W reduce tasks reduced straight into their rows.

Every mode derives from them:

* :meth:`fused`     — the whole pipeline as one call;
* :meth:`pipelined` — map and reduce waves grouped D at a time (overlap
  depth D) into blocks of ``W·D`` tasks; map group g's compute issued
  after group g-1's commit (prologue / steady state / epilogue), each
  reduce group written into its output rows in turn; bit-exact against
  fused by construction;
* :meth:`traced`    — the phases fenced one by one (``torch.cuda.
  synchronize`` on the card) and wall-clocked, with counters read from
  the phase outputs, feeding a :class:`repro_torch.telemetry.PhaseRecorder`;
* :meth:`sharded`   — one worker per rank of a ``torch.distributed``
  process group, the shuffle a literal ``all_to_all_single``;
* :meth:`resumable` — the raw steppers driven one wave boundary at a time
  by :class:`repro_torch.elastic.ResumableJob`.

The per-grant steppers (:meth:`map_stepper` and the rest) are built once
per canonical grant and cached, as the reference caches its jitted ones;
here the cache holds the built closures, since the port has no ``jit``.
The waves are Python loops where the reference uses ``fori_loop``, and
the steppers write each wave into the accumulators in place, where the
reference's functional update copies.  The fused, pipelined and traced
modes start from uninitialised accumulators, whose every row a wave
writes before anything reads it; the buffers a resumable job can observe
between steps (:meth:`initial_map_buffers`, the shuffle stepper's output
buffers) hold PAD_KEY / 0 / False, as the reference's do.  A final
partial map wave (or wave group) clamps its window back onto rows already
done, as ``dynamic_slice_in_dim`` does, and rewrites them with identical
values; a reduce wave covers only the tasks that exist, since its rows'
values do not depend on the rows around them.
On one CUDA stream the pipelined mode runs map commit g-1 and compute g
in order; its gain in the reference comes from XLA overlapping the two.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.mapreduce import backends as _backends
from repro_torch.mapreduce import phases
from repro_torch.mapreduce.phases import PAD_KEY, run_map_task
from repro_torch.mapreduce.spans import span

__all__ = ["ExecutionPlan"]

# Parallelism ceiling recorded with every process-CPU-clock sample: the
# runtime may use every host core inside one fenced phase, so the trace's
# CPU conservation law is cpu_s <= wall_s * cpu_workers.
_NCPU = float(os.cpu_count() or 1)


def _pad_rows(arr, n_extra: int, fill):
    """Append ``n_extra`` fill-rows so a W-row window fits when W > rows."""
    if n_extra == 0:
        return arr
    pad = torch.full(
        (n_extra,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
        device=arr.device,
    )
    return torch.cat([arr, pad], dim=0)


def _fenced(dev: torch.device, fn, *args):
    """(fn(*args), wall s, process CPU s), ended by ``torch.cuda.synchronize``
    on the card so that the wall covers the device work."""
    t0, c0 = time.perf_counter(), time.process_time()
    out = fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0, time.process_time() - c0


def _spanned(name: str, fn):
    """``fn`` inside a :func:`~repro_torch.mapreduce.spans.span` of
    ``name``."""

    def run(*args):
        with span(name):
            return fn(*args)

    return run


def _window(start: int, rows: int, W: int) -> int:
    """``jax.lax.dynamic_slice_in_dim``'s start: clamped so the W-row window
    stays inside ``rows``.  A final partial wave (or wave group) thus
    shifts back onto rows already processed, which recompute
    bit-identically (tasks are deterministic and row-independent)."""
    return max(0, min(start, rows - W))


class ExecutionPlan:
    """One (app, config, input size) on one device, lowered once.

    ``cfg.num_workers`` is the default grant (the one :meth:`fused`,
    :meth:`traced` and :meth:`meta` use); steppers are built per grant on
    demand and cached under canonical keys.
    """

    def __init__(self, app, cfg, input_len: int, device="cuda"):
        self.app = app
        self.cfg = cfg
        self.input_len = int(input_len)
        self.device = resolve_device(device)
        self.reduce_backend = _backends.get_reduce_backend(cfg.reduce_backend)
        if app.reduce_op not in self.reduce_backend.supported_ops:
            raise ValueError(
                f"reduce backend {self.reduce_backend.name!r} supports "
                f"{self.reduce_backend.supported_ops}, but app "
                f"{app.name!r} needs {app.reduce_op!r}"
            )
        self.shuffle = _backends.get_shuffle_backend(cfg.shuffle_backend)
        self.combiner = bool(cfg.combiner)
        if self.combiner and app.reduce_op not in phases.COMBINABLE_OPS:
            raise ValueError(
                f"combiner requires a commutative+associative reduce op "
                f"{phases.COMBINABLE_OPS}, but app {app.name!r} uses "
                f"{app.reduce_op!r}"
            )
        self.M = cfg.num_mappers
        self.R = cfg.num_reducers
        self.S = math.ceil(self.input_len / self.M)
        self.P = self.S * app.pairs_per_token
        #: combined per-task row width (static distinct-key bound)
        self.combine_cap = phases.combine_capacity(self.P, app.key_space)
        #: column width of the task rows entering the shuffle barrier
        self.shuffle_width = self.combine_cap if self.combiner else self.P
        #: W-independent lexsort partition capacity, sized from the
        #: combined stream when the combiner is on
        self.lex_capacity = phases.partition_capacity(
            self.M * self.shuffle_width, self.R, cfg.capacity_factor
        )
        # Per-grant stepper caches.  Keys are canonical, as the reference's:
        # any grant W >= M (or R) builds the same stepper as W == M, and
        # every key carries the combiner flag.
        self._prep = None
        self._map: dict[tuple[int, bool], callable] = {}
        self._combine: dict[bool, callable] = {}  # W-independent: one entry
        self._shuffle: dict[tuple[int, bool], callable] = {}
        self._reduce: dict[tuple[int, int, bool], callable] = {}
        self._pipelined: dict[tuple[int, int, bool], callable] = {}
        self._cache_hits = 0
        self._cache_misses = 0

    # ------------------------------------------------------------- metadata

    def partition_cap(self, workers: int | None = None) -> int:
        """Partition capacity the shuffle barrier allocates at a grant
        (lexsort: canonical, W-free; all_to_all: the W-shaped layout)."""
        if not self.shuffle.collective:
            return self.lex_capacity
        W = self.cfg.num_workers if workers is None else int(workers)
        n_local = math.ceil(self.M / W) * self.shuffle_width
        return phases.partition_capacity(
            W * n_local, self.R, self.cfg.capacity_factor
        )

    def meta(self, workers: int | None = None) -> dict:
        """Static shape facts telemetry and the cost estimator need."""
        W = self.cfg.num_workers if workers is None else int(workers)
        return {
            "input_len": self.input_len,
            "mappers": self.M,
            "reducers": self.R,
            "workers": W,
            "split_size": self.S,
            "map_waves": math.ceil(self.M / W),
            "reduce_waves": math.ceil(self.R / W),
            "n_pairs": self.M * self.P,
            "combiner": self.combiner,
            "combine_capacity": self.combine_cap,
            "shuffle_width": self.shuffle_width,
            "partition_capacity": self.partition_cap(W),
            "r_pad": self.R,
            "overlap_depth": self.cfg.overlap_depth,
        }

    # ------------------------------------------------- raw stepper builders

    def _prep_fn(self):
        M, S, input_len, dev = self.M, self.S, self.input_len, self.device

        def prep(tokens):
            tokens = torch.as_tensor(tokens, device=dev)
            if tuple(tokens.shape) != (input_len,):
                raise ValueError(
                    f"expected ({input_len},), got {tuple(tokens.shape)}"
                )
            padded = torch.zeros(M * S, dtype=torch.int32, device=dev)
            padded[:input_len] = tokens
            valid = (torch.arange(M * S, device=dev) < input_len).reshape(M, S)
            return padded.reshape(M, S), valid

        return prep

    def initial_map_buffers(self, fill: bool = True):
        """The (M, P) map accumulators: PAD_KEY / 0 / False, or left
        uninitialised with ``fill=False`` where the waves' windows write
        every row before anything reads it (fused, pipelined, traced)."""
        M, P, dev = self.M, self.P, self.device
        if not fill:
            return tuple(torch.empty((M, P), dtype=dt, device=dev)
                         for dt in (torch.int32, torch.int32, torch.bool))
        return (
            torch.full((M, P), PAD_KEY, dtype=torch.int32, device=dev),
            torch.zeros((M, P), dtype=torch.int32, device=dev),
            torch.zeros((M, P), dtype=torch.bool, device=dev),
        )

    def initial_reduce_buffers(self, cap: int, fill: bool = True):
        """The (R, cap) reduce outputs, filled or not as
        :meth:`initial_map_buffers`."""
        R, dev = self.R, self.device
        if not fill:
            return tuple(torch.empty((R, cap), dtype=torch.int32, device=dev)
                         for _ in range(2))
        return (
            torch.full((R, cap), PAD_KEY, dtype=torch.int32, device=dev),
            torch.zeros((R, cap), dtype=torch.int32, device=dev),
        )

    # The wave step is split at its data-dependency boundary: ``compute``
    # reads only the immutable inputs (splits / partitions) and returns a
    # task block; ``commit`` writes the block into the accumulators.
    # compute then commit at one start is the serial step; the pipelined
    # mode issues group g's compute after group g-1's commit.  Both clamp
    # the start to the same window, so the split changes the schedule,
    # never the values.

    def _map_compute_fn(self, W: int, sort_passes=None):
        app, cfg, M = self.app, self.cfg, self.M
        W = min(W, M)

        def compute(splits, svalid, start):
            s = _window(start, M, W)
            return run_map_task(app, cfg, splits[s:s + W], svalid[s:s + W],
                                sort_passes=sort_passes)

        return compute

    def _map_commit_fn(self, W: int):
        M = self.M
        W = min(W, M)

        def commit(bufs, blk, start):
            s = _window(start, M, W)
            for buf, b in zip(bufs, blk):
                buf[s:s + W] = b
            return bufs

        return commit

    def _map_step_fn(self, W: int, sort_passes=None):
        """Map wave stepper: the min(W, M) tasks at ``start`` (clamped)
        computed, their spill sort writing straight into their rows of the
        (M, P) accumulators.  ``sort_passes``: see
        :func:`~repro_torch.mapreduce.phases.run_map_task`."""
        app, cfg, M = self.app, self.cfg, self.M
        W = min(W, M)

        def step(splits, svalid, bk, bv, bp, start):
            s = _window(start, M, W)
            rows = slice(s, s + W)
            run_map_task(app, cfg, splits[rows], svalid[rows],
                         out=(bk[rows], bv[rows], bp[rows]), sort_passes=sort_passes)
            return bk, bv, bp

        return step

    def _combine_step_fn(self):
        """Map-side combine barrier: aggregate + compact every task row in
        one batched backend call, whatever the grant."""
        backend, op = self.reduce_backend, self.app.reduce_op
        cap = self.combine_cap

        def step(bk, bv, bp):
            return phases.combine_rows(backend, bk, bv, bp, op, cap)

        return step

    def _lexsort_shuffle_fn(self):
        """Single-controller shuffle at the W-independent capacity: a W=1
        view of the config makes ``reduce_waves * W`` exactly R rows."""
        cfg_w1 = dataclasses.replace(self.cfg, num_workers=1)
        shuffle = self.shuffle

        def step(bk, bv, bp):
            return shuffle.partition(cfg_w1, bk, bv, bp)

        return step

    def _a2a_shuffle_fn(self, W: int):
        """The collective shuffle on one controller: pack and unpack over a
        worker axis, the block transpose in place of ``all_to_all``.  The
        per-worker computation and capacity layout are those of a real
        W-worker :meth:`sharded` run at the grant held at the barrier."""
        cfg_w = dataclasses.replace(self.cfg, num_workers=W)
        shuffle, M, R = self.shuffle, self.M, self.R
        waves_m, waves_r = cfg_w.map_waves, cfg_w.reduce_waves

        def step(bk, bv, bp):
            # The column width comes from the input: the combiner hands
            # this barrier compacted (M, Pc) rows, and the per-worker
            # stream (hence the exchange's capacity) shrinks with them.
            Pb = bk.shape[1]
            n_local = waves_m * Pb

            # Worker-major local streams: worker w owns tasks w, w+W, ...
            def per_worker(buf, fill):
                padded = _pad_rows(buf, waves_m * W - M, fill)
                return padded.reshape(waves_m, W, Pb).transpose(0, 1) \
                    .reshape(W, n_local)

            send, sdrop = shuffle.pack(
                cfg_w, per_worker(bk, PAD_KEY), per_worker(bv, 0),
                per_worker(bp, False),
            )
            # all_to_all: worker w's received row j is worker j's send row
            # w, a block transpose of the (W, W, width) send blocks cut to
            # their longest live prefix.
            with span("mapreduce.shuffle.exchange"):
                width = shuffle.live_width(cfg_w, send[2])
                recv = tuple(s[..., :width].transpose(0, 1).reshape(W, -1)
                             for s in send)
            (bk2, bv2), rdrop = shuffle.unpack(cfg_w, n_local, *recv)
            # (W, waves_r, cap) -> reducer-indexed (R, cap): reducer r
            # lives on worker r % W at local slot r // W.
            cap = bk2.shape[-1]
            pk = bk2.transpose(0, 1).reshape(waves_r * W, cap)[:R]
            pv = bv2.transpose(0, 1).reshape(waves_r * W, cap)[:R]
            return pk, pv, (sdrop.sum() + rdrop.sum()).to(torch.int32)

        return step

    def _partition_fn(self, W: int):
        """The shuffle barrier at a grant: ``(pk, pv, dropped)``."""
        if self.shuffle.collective:
            return self._a2a_shuffle_fn(W)
        return self._lexsort_shuffle_fn()

    def _shuffle_step_fn(self, W: int):
        """The shuffle barrier with the reduce phase's filled output
        buffers, the reference's stepper contract."""
        partition = self._partition_fn(W)
        init_out = self.initial_reduce_buffers

        def step(bk, bv, bp):
            pk, pv, dropped = partition(bk, bv, bp)
            return (pk, pv, dropped, *init_out(pk.shape[1]))

        return step

    def _reduce_step_fn(self, W: int):
        """Reduce wave stepper: the tasks [start, start + W) that exist,
        reduced straight into their rows of the output buffers (one
        backend call; no padding row, no window shifted back onto rows
        already done, no copy)."""
        cfg, R, op = self.cfg, self.R, self.app.reduce_op
        backend = self.reduce_backend

        def step(pk, pv, ok_buf, ov_buf, start):
            rows = slice(start, min(start + W, R))
            phases.reduce_wave(cfg, backend, op, pk[rows], pv[rows],
                               ok_buf[rows], ov_buf[rows])
            return ok_buf, ov_buf

        return step

    @staticmethod
    def _software_pipeline(compute, commit, groups: int, stride: int, init_bufs):
        """Prologue / steady state / epilogue over ``groups`` map wave groups.

        Iteration g of the steady state commits group g-1's block and
        computes group g's; the commit order (0, 1, ..., G-1) and every
        clamped window are the serial loop's, so the outputs are bit-exact.
        The prologue and each iteration lie in a ``mapreduce.map.wave`` span.
        """

        def run(*inputs):
            bufs = init_bufs()
            with span("mapreduce.map.wave", 0):
                blk = compute(*inputs, 0)
            for g in range(1, groups):
                with span("mapreduce.map.wave", g):
                    bufs = commit(bufs, blk, (g - 1) * stride)
                    blk = compute(*inputs, g * stride)
            return commit(bufs, blk, (groups - 1) * stride)

        return run

    # ------------------------------------------------- phase compositions

    def phase_fns(self, workers: int | None = None, sort_passes=None) -> dict:
        """The pipeline as phase functions at one grant: a wave loop each
        for map and reduce, plus the combine and shuffle barriers.
        ``sort_passes``: see :func:`~repro_torch.mapreduce.phases.run_map_task`."""
        W = self.cfg.num_workers if workers is None else int(workers)
        prep = self._prep_fn()
        map_step = self._map_step_fn(W, sort_passes)
        shuffle_step = self._partition_fn(W if self.shuffle.collective else 1)
        map_waves = math.ceil(self.M / W)
        init_map = self.initial_map_buffers

        def phase_map(tokens):
            with span("mapreduce.map"):
                splits, valid = prep(tokens)
                bufs = init_map(fill=False)
                for i in range(map_waves):
                    with span("mapreduce.map.wave", i):
                        bufs = map_step(splits, valid, *bufs, i * W)
                return bufs

        fns = {"map": phase_map}
        if self.combiner:
            fns["combine"] = _spanned("mapreduce.combine", self._combine_step_fn())
        fns["shuffle"] = _spanned("mapreduce.shuffle", shuffle_step)
        fns["reduce"] = self._reduce_phase_fn(W)
        return fns

    def _reduce_phase_fn(self, W: int):
        """The reduce phase: its waves of W tasks one after another, each
        written into the output rows by :meth:`_reduce_step_fn`."""
        reduce_step = self._reduce_step_fn(W)
        waves = math.ceil(self.R / W)
        init_red = self.initial_reduce_buffers

        def phase_reduce(pk, pv):
            with span("mapreduce.reduce"):
                bufs = init_red(pk.shape[1], fill=False)
                for i in range(waves):
                    with span("mapreduce.reduce.wave", i):
                        bufs = reduce_step(pk, pv, *bufs, i * W)
                return bufs

        return phase_reduce

    def pipelined_phase_fns(self, workers: int | None = None,
                            depth: int | None = None, sort_passes=None) -> dict:
        """The phase functions with map and reduce waves grouped D at a
        time (overlap depth D) into blocks of ``min(W·D, M)`` (or R) tasks,
        the map groups software-pipelined.  The shuffle is the barrier
        between the two phases and is the serial mode's.  ``depth=1`` is
        :meth:`phase_fns`."""
        W = self.cfg.num_workers if workers is None else int(workers)
        D = self.cfg.overlap_depth if depth is None else int(depth)
        if D < 1:
            raise ValueError(f"overlap depth must be >= 1, got {D}")
        if D == 1:
            return self.phase_fns(W, sort_passes)
        Weff_m = min(W * D, self.M)
        prep = self._prep_fn()
        map_pipe = self._software_pipeline(
            self._map_compute_fn(Weff_m, sort_passes), self._map_commit_fn(Weff_m),
            math.ceil(self.M / Weff_m), Weff_m,
            lambda: self.initial_map_buffers(fill=False),
        )

        def phase_map(tokens):
            with span("mapreduce.map"):
                return map_pipe(*prep(tokens))

        fns = {"map": phase_map}
        if self.combiner:
            # Pure per-row work on the committed map buffers, ahead of the
            # shuffle barrier: no commit state of its own.
            fns["combine"] = _spanned("mapreduce.combine", self._combine_step_fn())
        fns["shuffle"] = _spanned(
            "mapreduce.shuffle",
            self._partition_fn(W if self.shuffle.collective else 1))
        # A reduce wave group writes its output rows itself: there is no
        # commit to overlap, so the groups of W·D tasks run one by one.
        fns["reduce"] = self._reduce_phase_fn(W * D)
        return fns

    # ---------------------------------------------- steppers (per grant)

    def _cached(self, cache: dict, key, build):
        if key in cache:
            self._cache_hits += 1
        else:
            self._cache_misses += 1
            cache[key] = build()
        return cache[key]

    def prep(self):
        if self._prep is None:
            self._prep = self._prep_fn()
        return self._prep

    def map_stepper(self, W: int):
        # A grant wider than the task count covers the same M-row window,
        # so every W >= M is one stepper: the key is min(W, M).
        key = (min(int(W), self.M), self.combiner)
        return self._cached(self._map, key, lambda: self._map_step_fn(key[0]))

    def combine_stepper(self):
        return self._cached(self._combine, self.combiner, self._combine_step_fn)

    def shuffle_stepper(self, W: int):
        key = (int(W) if self.shuffle.collective else 1, self.combiner)
        return self._cached(self._shuffle, key,
                            lambda: self._shuffle_step_fn(key[0]))

    def reduce_stepper(self, W: int, cap: int):
        key = (min(int(W), self.R), int(cap), self.combiner)
        return self._cached(self._reduce, key,
                            lambda: self._reduce_step_fn(key[0]))

    def cache_info(self) -> dict:
        """Stepper-cache occupancy and hit/miss counters (equivalent grants
        share keys), with the reference's keys."""
        return {
            "map_entries": len(self._map),
            "combine_entries": len(self._combine),
            "shuffle_entries": len(self._shuffle),
            "reduce_entries": len(self._reduce),
            "pipelined_entries": len(self._pipelined),
            "hits": self._cache_hits,
            "misses": self._cache_misses,
        }

    # ---------------------------------------------------------------- modes

    def _span_args(self, workers: int | None = None) -> str:
        """The ``mapreduce.job`` span's args: the setting of the job."""
        W = self.cfg.num_workers if workers is None else int(workers)
        return f"app={self.app.name} M={self.M} R={self.R} W={W}"

    @staticmethod
    def _compose(fns: dict, args: str):
        def job(tokens):
            with span("mapreduce.job", args):
                bufs = fns["map"](tokens)
                if "combine" in fns:
                    bufs = fns["combine"](*bufs)
                pk, pv, dropped = fns["shuffle"](*bufs)
                ok, ov = fns["reduce"](pk, pv)
                return ok, ov, dropped

        return job

    def fused(self, workers: int | None = None):
        """Mode ``fused``: the whole pipeline as one call.  Returns
        ``job(tokens) -> (out_keys (R, cap), out_vals (R, cap), dropped ())``
        on the plan's device.  It queues its work without synchronising,
        but for the one value the all-to-all shuffle reads on the host
        (``AllToAllShuffle.live_width``)."""
        return self._compose(self.phase_fns(workers), self._span_args(workers))

    def pipelined(self, workers: int | None = None,
                  depth: int | None = None):
        """Mode ``pipelined``: :meth:`fused` with map and reduce waves
        software-pipelined at overlap depth D (default
        ``cfg.overlap_depth``; see :meth:`pipelined_phase_fns`).  Outputs
        are bit-exact against :meth:`fused`; jobs are cached per
        ``(W, D)`` grant."""
        W = self.cfg.num_workers if workers is None else int(workers)
        D = self.cfg.overlap_depth if depth is None else int(depth)
        if D < 1:
            raise ValueError(f"overlap depth must be >= 1, got {D}")
        return self._cached(
            self._pipelined, (W, D, self.combiner),
            lambda: self._compose(self.pipelined_phase_fns(W, D),
                                  self._span_args(W)),
        )

    def traced(self, recorder, workers: int | None = None,
               depth: int | None = None):
        """Mode ``traced``: the phases fenced one by one and wall-clocked,
        feeding a :class:`repro_torch.telemetry.PhaseRecorder`.  Same
        outputs as :meth:`fused`; every counter is read from the phase
        outputs, so the conservation laws are checked invariants.

        Each phase ends in ``torch.cuda.synchronize`` on the card, so its
        wall time (``time.perf_counter``) covers its device work; the
        process CPU clock is sampled at the same fences.  At overlap depth
        D > 1 the map and reduce phases run pipelined and the trace gains
        a ``pipeline`` phase carrying the residual wall time (total minus
        the fenced phases) with ``overlap_depth`` / ``overlap_s``.
        """
        D = self.cfg.overlap_depth if depth is None else int(depth)
        app, cfg, dev = self.app, self.cfg, self.device
        # The spill sort kernel's radix passes, summed over the map's task
        # rows (the card only; the plain sort on the CPU counts none).
        passes = torch.zeros((), dtype=torch.int32, device=dev) if dev.type == "cuda" else None
        fns = self.pipelined_phase_fns(workers, D, sort_passes=passes)
        m = self.meta(workers)
        pair_bytes = phases.PAIR_BYTES
        args = self._span_args(workers)

        fenced = functools.partial(_fenced, dev)

        def job(tokens):
            trace = recorder.start_job(app.name, cfg, m["input_len"])
            try:
                with span("mapreduce.job", args):
                    return run(tokens, trace)
            except Exception:
                # A failed run leaves no partial trace behind.
                if trace in recorder.traces:
                    recorder.traces.remove(trace)
                raise

        def run(tokens, trace):
            t_job = time.perf_counter()

            if passes is not None:
                passes.zero_()
            (bk, bv, bp), dt, cpu = fenced(fns["map"], tokens)
            pairs_emitted = int(bp.sum().item())
            sorted_by = {} if passes is None else {"sort_passes": int(passes.item())}
            trace.record_phase(
                "map", dt,
                tasks=m["mappers"], waves=m["map_waves"],
                records_in=m["input_len"],
                pairs_emitted=pairs_emitted, pairs_capacity=m["n_pairs"],
                **sorted_by,
                cpu_s=cpu, cpu_workers=_NCPU,
            )

            shuffle_pairs_in = pairs_emitted
            if "combine" in fns:
                (bk, bv, bp), dt, cpu = fenced(fns["combine"], bk, bv, bp)
                shuffle_pairs_in = int(bp.sum().item())
                trace.record_phase(
                    "combine", dt,
                    tasks=m["mappers"],
                    pairs_in=pairs_emitted, pairs_out=shuffle_pairs_in,
                    bytes_in=pairs_emitted * pair_bytes,
                    bytes_out=shuffle_pairs_in * pair_bytes,
                    combine_capacity=m["combine_capacity"],
                    cpu_s=cpu, cpu_workers=_NCPU,
                    # Combining is map-local work: it moves no fabric bytes.
                    net_bytes=0.0,
                )

            (pk, pv, dropped), dt, cpu = fenced(fns["shuffle"], bk, bv, bp)
            n_dropped = int(dropped)
            pairs_out = int((pk != PAD_KEY).sum().item())
            trace.record_phase(
                "shuffle", dt,
                pairs_in=shuffle_pairs_in, pairs_out=pairs_out,
                pairs_dropped=n_dropped,
                bytes_in=shuffle_pairs_in * pair_bytes,
                bytes_out=pairs_out * pair_bytes,
                bytes_dropped=n_dropped * pair_bytes,
                partitions=m["reducers"],
                partition_capacity=int(pk.shape[1]),
                cpu_s=cpu, cpu_workers=_NCPU,
                # Every pair entering the shuffle crosses the fabric,
                # dropped ones included.
                net_bytes=shuffle_pairs_in * pair_bytes,
                net_s=dt,
            )

            (ok, ov), dt, cpu = fenced(fns["reduce"], pk, pv)
            segments = int((ok != PAD_KEY).sum().item())
            trace.record_phase(
                "reduce", dt,
                tasks=m["reducers"], waves=m["reduce_waves"],
                segments_out=segments,
                segment_slots=m["reducers"] * int(pk.shape[1]),
                cpu_s=cpu, cpu_workers=_NCPU,
            )

            total = time.perf_counter() - t_job
            if D > 1:
                # The overlap happens inside the fenced map and reduce
                # phases, so this phase carries only the cross-phase
                # residual; it moves no fabric bytes.
                trace.record_phase(
                    "pipeline", max(0.0, total - trace.phase_time_sum()),
                    overlap_depth=D, overlap_s=0.0, net_bytes=0.0,
                )
            trace.finish(total)
            return ok, ov, dropped

        return job

    def resumable(self, recorder=None):
        """Mode ``resumable``: a :class:`repro_torch.elastic.ResumableJob`
        whose wave steppers are this plan's (the cursor and regrant
        bookkeeping live in the elastic layer)."""
        from repro_torch.elastic.resumable import ResumableJob

        return ResumableJob.from_plan(self, recorder=recorder)

    # ------------------------------------------------------------- sharded

    def sharded(self, group=None, counters: bool = False, recorder=None):
        """Mode ``sharded``: this process is one worker of a
        ``torch.distributed`` process group (default: the world group), W
        = its size, and the shuffle a literal ``all_to_all_single``
        (NCCL on CUDA tensors, gloo on CPU ones).  Rank w runs map tasks
        w, w+W, ... and owns reducers w, w+W, ...; semantics match every
        other mode.

        Every rank's job returns the whole reducer-major ``(R, cap)``
        output (an all-gather of the ranks' reduce slots) and ``dropped``
        summed over ranks.  With ``counters=True`` it also returns
        ``stats``: ``dropped_send``, ``dropped_recv`` and the (W, 2)
        ``dropped_per_worker``.  With a recorder each phase is fenced and
        wall-clocked on this rank, with counters summed across ranks.
        """
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "the sharded mode needs an initialised torch.distributed "
                "process group (torch.distributed.init_process_group)"
            )
        if group is None:
            group = dist.group.WORLD
        W = dist.get_world_size(group)
        rank = dist.get_rank(group)
        cfg, app = self.cfg, self.app
        if cfg.num_workers != W:
            raise ValueError(
                f"cfg.num_workers={cfg.num_workers} != process group size {W}"
            )
        shuffle = self.shuffle
        if not shuffle.collective:
            # The sharded path's structural shuffle is the collective.
            shuffle = _backends.SHUFFLE_BACKENDS["all_to_all"]
        reduce_backend, reduce_op = self.reduce_backend, app.reduce_op
        M, R, S, P = self.M, self.R, self.S, self.P
        input_len, dev = self.input_len, self.device
        waves_m, waves_r = cfg.map_waves, cfg.reduce_waves
        n_local = waves_m * P
        combiner, combine_cap = self.combiner, self.combine_cap
        args = self._span_args(W)

        def w_map(tokens):
            tokens = torch.as_tensor(tokens, device=dev)
            if tuple(tokens.shape) != (input_len,):
                raise ValueError(
                    f"expected ({input_len},), got {tuple(tokens.shape)}"
                )
            with span("mapreduce.map"):
                padded = torch.zeros(waves_m * W * S, dtype=torch.int32, device=dev)
                padded[:input_len] = tokens
                valid = torch.arange(waves_m * W * S, device=dev) < input_len
                # This rank's tasks: rank, rank + W, ... as (waves, 1, S).
                splits = padded.reshape(waves_m, W, S)[:, rank:rank + 1]
                vsplit = valid.reshape(waves_m, W, S)[:, rank:rank + 1]
                return tuple(a.reshape(n_local) for a in
                             phases.map_phase(app, cfg, splits, vsplit))

        def w_combine(k, v, pv):
            # Rank-local combine before any byte crosses the group: the
            # stream (and the exchange built on it) shrinks to waves_m*Pc.
            with span("mapreduce.combine"):
                return tuple(a.reshape(-1) for a in phases.combine_rows(
                    reduce_backend, k.reshape(waves_m, P), v.reshape(waves_m, P),
                    pv.reshape(waves_m, P), reduce_op, combine_cap,
                ))

        def w_shuffle(k, v, pv):
            with span("mapreduce.shuffle"):
                return shuffle.exchange(cfg, group, k, v, pv)

        def w_reduce(bk, bv):
            with span("mapreduce.reduce"):
                return phases.reduce_local(app, cfg, bk, bv, reduce_backend)

        def gather(t):
            parts = [torch.empty_like(t) for _ in range(W)]
            dist.all_gather(parts, t.contiguous(), group=group)
            return torch.stack(parts)

        def global_sum(n: int) -> int:
            t = torch.tensor(n, dtype=torch.int64, device=dev)
            dist.all_reduce(t, group=group)
            return int(t.item())

        def finish(ok, ov, dropped):
            # (W, waves_r, cap) -> (R, cap) indexed by reducer id: reducer
            # r lives on worker r % W at local slot r // W.
            with span("mapreduce.gather"):
                out = gather(torch.stack([ok, ov]))
                cap = ok.shape[-1]
                ok, ov = out.permute(1, 2, 0, 3).reshape(2, waves_r * W, cap)[:, :R]
                per_worker = gather(dropped)
                total = per_worker.sum().to(torch.int32)
            if not counters:
                return ok, ov, total
            pw = per_worker.cpu().numpy()
            return ok, ov, total, {
                "dropped_send": int(pw[:, 0].sum()),
                "dropped_recv": int(pw[:, 1].sum()),
                "dropped_per_worker": pw,
            }

        if recorder is None:
            def job(tokens):
                with span("mapreduce.job", args):
                    k, v, pv = w_map(tokens)
                    if combiner:
                        k, v, pv = w_combine(k, v, pv)
                    bk, bv, dropped = w_shuffle(k, v, pv)
                    # Each stage's inputs die before the next allocates:
                    # the output gather is the job's peak, near a card's
                    # capacity at 2^29 tokens on four ranks.
                    del k, v, pv
                    ok, ov = w_reduce(bk, bv)
                    del bk, bv
                    return finish(ok, ov, dropped)

            return job

        pair_bytes = phases.PAIR_BYTES

        fenced = functools.partial(_fenced, dev)

        def traced_job(tokens):
            trace = recorder.start_job(app.name, cfg, input_len)
            try:
                with span("mapreduce.job", args):
                    return run(tokens, trace)
            except Exception:
                if trace in recorder.traces:
                    recorder.traces.remove(trace)
                raise

        # Each phase's window ends when every rank of the group has
        # finished it, as the reference's ``block_until_ready`` on arrays
        # sharded over all workers does: the counter collective (or the
        # output all-gather) that follows a phase runs inside its window,
        # so a wait for a slower peer counts in that phase and the time
        # outside all phases is only this rank's own host work.
        def map_counted(tokens):
            k, v, pv = w_map(tokens)
            return (k, v, pv), global_sum(int(pv.sum().item()))

        def combine_counted(k, v, pv):
            k, v, pv = w_combine(k, v, pv)
            return (k, v, pv), global_sum(int(pv.sum().item()))

        def shuffle_counted(k, v, pv):
            bk, bv, dropped = w_shuffle(k, v, pv)
            per_worker = gather(dropped).cpu().numpy()
            pairs_out = global_sum(int((bk != PAD_KEY).sum().item()))
            return (bk, bv, dropped), per_worker, pairs_out

        def reduce_finished(parts, dropped):
            ok, ov = w_reduce(*parts)
            parts.clear()  # the partitions die before the gather allocates
            return finish(ok, ov, dropped)

        def run(tokens, trace):
            t_job = time.perf_counter()

            ((k, v, pv), pairs_emitted), dt, cpu = fenced(map_counted, tokens)
            trace.record_phase(
                "map", dt,
                tasks=M, waves=waves_m, workers=W, records_in=input_len,
                pairs_emitted=pairs_emitted, pairs_capacity=W * n_local,
                cpu_s=cpu, cpu_workers=_NCPU,
            )

            shuffle_pairs_in = pairs_emitted
            if combiner:
                ((k, v, pv), shuffle_pairs_in), dt, cpu = fenced(
                    combine_counted, k, v, pv)
                trace.record_phase(
                    "combine", dt,
                    tasks=M, workers=W,
                    pairs_in=pairs_emitted, pairs_out=shuffle_pairs_in,
                    bytes_in=pairs_emitted * pair_bytes,
                    bytes_out=shuffle_pairs_in * pair_bytes,
                    combine_capacity=combine_cap,
                    cpu_s=cpu, cpu_workers=_NCPU,
                    net_bytes=0.0,
                )

            ((bk, bv, dropped), per_worker, pairs_out), dt, cpu = fenced(
                shuffle_counted, k, v, pv)
            del k, v, pv
            cap = int(bk.shape[-1])
            n_dropped = int(per_worker.sum())
            trace.record_phase(
                "shuffle", dt,
                pairs_in=shuffle_pairs_in, pairs_out=pairs_out,
                pairs_dropped=n_dropped,
                bytes_in=shuffle_pairs_in * pair_bytes,
                bytes_out=pairs_out * pair_bytes,
                bytes_dropped=n_dropped * pair_bytes,
                partitions=R, workers=W,
                partition_capacity=cap,
                dropped_send=int(per_worker[:, 0].sum()),
                dropped_recv=int(per_worker[:, 1].sum()),
                cpu_s=cpu, cpu_workers=_NCPU,
                net_bytes=shuffle_pairs_in * pair_bytes,
                net_s=dt,
            )

            parts = [bk, bv]
            del bk, bv
            out, dt, cpu = fenced(reduce_finished, parts, dropped)
            trace.record_phase(
                "reduce", dt,
                tasks=R, waves=waves_r, workers=W,
                segments_out=int((out[0] != PAD_KEY).sum().item()),
                segment_slots=W * waves_r * cap,
                cpu_s=cpu, cpu_workers=_NCPU,
            )
            trace.finish(time.perf_counter() - t_job)
            return out

        return traced_job
