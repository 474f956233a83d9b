"""Execution plan and its modes (counterpart of ``repro.mapreduce.plan``).

:class:`ExecutionPlan` lowers one ``(MapReduceApp, JobConfig, input_len)``
into wave steppers over task-major buffers:

* ``prep(tokens)``                      → ``(splits (M, S), valid (M, S))``
* ``map_step(W)(splits, valid, bk, bv, bp, start)`` → the ``(M, P)``
  accumulators with one wave of W map tasks written in;
* ``combine_step()(bk, bv, bp)``        → compacted ``(M, Pc)`` task rows
  (only when ``cfg.combiner``), ``Pc = min(P, key_space)``;
* ``shuffle_step(W)(bk, bv, bp)``       → ``(pk, pv, dropped, ok, ov)`` with
  ``(R, cap)`` partitions, ``cap = partition_capacity(M·Pc, R, f)``, and
  the reduce phase's output buffers;
* ``reduce_step(W)(pk, pv, ok, ov, start)`` → the ``(R, cap)`` outputs with
  one wave of W reduce tasks written in.

Every mode derives from them:

* :meth:`fused`     — the whole pipeline as one call;
* :meth:`pipelined` — map and reduce waves software-pipelined at overlap
  depth D: waves grouped D at a time into blocks of ``W·D`` tasks, group
  g's compute issued after group g-1's commit (prologue / steady state /
  epilogue), bit-exact against fused by construction;
* :meth:`traced`    — the phases fenced one by one (``torch.cuda.
  synchronize`` on the card) and wall-clocked, with counters read from
  the phase outputs, feeding a :class:`repro_torch.telemetry.PhaseRecorder`.

The per-grant steppers (:meth:`map_stepper` and the rest) are built once
per canonical grant and cached, as the reference caches its jitted ones;
here the cache holds the built closures, since the port has no ``jit``.
The waves are Python loops where the reference uses ``fori_loop``, and
the steppers write each wave into the accumulators in place, where the
reference's functional update copies.  A final partial wave (or wave
group) clamps its window back onto rows already done, as
``dynamic_slice_in_dim`` does, and rewrites them with identical values.
On one CUDA stream the pipelined mode runs commit g-1 and compute g in
order; its gain in the reference comes from XLA overlapping the two.
The sharded and resumable modes are ported by later slices (ROADMAP.md,
queue 1, items 6 and 7).
"""

from __future__ import annotations

import dataclasses
import math
import os
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.mapreduce import backends as _backends
from repro_torch.mapreduce import phases
from repro_torch.mapreduce.phases import PAD_KEY, run_map_task

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
        (lexsort: canonical, W-free)."""
        return self.lex_capacity

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

    # The accumulators start uninitialised: the waves' windows cover every
    # row, so each row is written before it is read.
    def initial_map_buffers(self):
        M, P, dev = self.M, self.P, self.device
        return (
            torch.empty((M, P), dtype=torch.int32, device=dev),
            torch.empty((M, P), dtype=torch.int32, device=dev),
            torch.empty((M, P), dtype=torch.bool, device=dev),
        )

    def initial_reduce_buffers(self, cap: int):
        R, dev = self.R, self.device
        return (
            torch.empty((R, cap), dtype=torch.int32, device=dev),
            torch.empty((R, cap), dtype=torch.int32, device=dev),
        )

    # The wave step is split at its data-dependency boundary: ``compute``
    # reads only the immutable inputs (splits / partitions) and returns a
    # task block; ``commit`` writes the block into the accumulators.
    # compute then commit at one start is the serial step; the pipelined
    # mode issues group g's compute after group g-1's commit.  Both clamp
    # the start to the same window, so the split changes the schedule,
    # never the values.

    def _map_compute_fn(self, W: int):
        app, cfg, M = self.app, self.cfg, self.M
        pad = max(0, W - M)

        def compute(splits, svalid, start):
            s = _window(start, M + pad, W)
            tok = _pad_rows(splits, pad, 0)[s:s + W]
            val = _pad_rows(svalid, pad, False)[s:s + W]
            return run_map_task(app, cfg, tok, val)

        return compute

    def _map_commit_fn(self, W: int):
        M = self.M
        pad = max(0, W - M)

        def commit(bufs, blk, start):
            s = _window(start, M + pad, W)
            n = min(W, M - s)
            for buf, b in zip(bufs, blk):
                buf[s:s + n] = b[:n]
            return bufs

        return commit

    def _reduce_compute_fn(self, W: int):
        cfg, R, op = self.cfg, self.R, self.app.reduce_op
        backend = self.reduce_backend
        pad = max(0, W - R)

        def compute(pk, pv, start):
            s = _window(start, R + pad, W)
            kblk = _pad_rows(pk, pad, PAD_KEY)[s:s + W]
            vblk = _pad_rows(pv, pad, 0)[s:s + W]
            ok, ov = backend.reduce(kblk, vblk, op)
            return ok, phases._masked_setup(cfg, kblk, ok, ov)

        return compute

    def _reduce_commit_fn(self, W: int):
        R = self.R
        pad = max(0, W - R)

        def commit(bufs, blk, start):
            s = _window(start, R + pad, W)
            n = min(W, R - s)
            for buf, b in zip(bufs, blk):
                buf[s:s + n] = b[:n]
            return bufs

        return commit

    def _map_step_fn(self, W: int):
        """Map wave stepper: the W tasks at ``start`` (clamped) computed and
        written into the (M, P) accumulators."""
        compute, commit = self._map_compute_fn(W), self._map_commit_fn(W)

        def step(splits, svalid, bk, bv, bp, start):
            return commit((bk, bv, bp), compute(splits, svalid, start), start)

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
            return shuffle.partition(
                cfg_w1, bk.reshape(-1), bv.reshape(-1), bp.reshape(-1)
            )

        return step

    def _shuffle_step_fn(self, W: int):
        """The shuffle barrier with the reduce phase's output buffers, the
        reference's stepper contract."""
        partition = self._lexsort_shuffle_fn()
        init_out = self.initial_reduce_buffers

        def step(bk, bv, bp):
            pk, pv, dropped = partition(bk, bv, bp)
            return (pk, pv, dropped, *init_out(pk.shape[1]))

        return step

    def _reduce_step_fn(self, W: int):
        """Reduce wave stepper, the same clamped window as the map stepper:
        reduce backends are row-independent, so a shifted final wave
        rewrites identical rows."""
        compute, commit = self._reduce_compute_fn(W), self._reduce_commit_fn(W)

        def step(pk, pv, ok_buf, ov_buf, start):
            return commit((ok_buf, ov_buf), compute(pk, pv, start), start)

        return step

    @staticmethod
    def _software_pipeline(compute, commit, groups: int, stride: int,
                           init_bufs):
        """Prologue / steady state / epilogue over ``groups`` wave groups.

        Iteration g of the steady state commits group g-1's block and
        computes group g's; the commit order (0, 1, ..., G-1) and every
        clamped window are the serial loop's, so the outputs are bit-exact.
        """

        def run(*inputs):
            bufs = init_bufs()
            blk = compute(*inputs, 0)
            for g in range(1, groups):
                bufs = commit(bufs, blk, (g - 1) * stride)
                blk = compute(*inputs, g * stride)
            return commit(bufs, blk, (groups - 1) * stride)

        return run

    # ------------------------------------------------- phase compositions

    def phase_fns(self, workers: int | None = None) -> dict:
        """The pipeline as phase functions at one grant: a wave loop each
        for map and reduce, plus the combine and shuffle barriers."""
        W = self.cfg.num_workers if workers is None else int(workers)
        prep = self._prep_fn()
        map_step = self._map_step_fn(W)
        shuffle_step = self._lexsort_shuffle_fn()
        reduce_step = self._reduce_step_fn(W)
        map_waves = math.ceil(self.M / W)
        red_waves = math.ceil(self.R / W)
        init_map = self.initial_map_buffers
        init_red = self.initial_reduce_buffers

        def phase_map(tokens):
            splits, valid = prep(tokens)
            bufs = init_map()
            for i in range(map_waves):
                bufs = map_step(splits, valid, *bufs, i * W)
            return bufs

        def phase_reduce(pk, pv):
            bufs = init_red(pk.shape[1])
            for i in range(red_waves):
                bufs = reduce_step(pk, pv, *bufs, i * W)
            return bufs

        fns = {"map": phase_map}
        if self.combiner:
            fns["combine"] = self._combine_step_fn()
        fns["shuffle"] = shuffle_step
        fns["reduce"] = phase_reduce
        return fns

    def pipelined_phase_fns(self, workers: int | None = None,
                            depth: int | None = None) -> dict:
        """The phase functions with map and reduce waves software-pipelined
        at overlap depth D: waves grouped D at a time into blocks of
        ``min(W·D, M)`` (or R) tasks.  The shuffle is the barrier between
        the two pipelines and is the serial mode's.  ``depth=1`` is
        :meth:`phase_fns`."""
        W = self.cfg.num_workers if workers is None else int(workers)
        D = self.cfg.overlap_depth if depth is None else int(depth)
        if D < 1:
            raise ValueError(f"overlap depth must be >= 1, got {D}")
        if D == 1:
            return self.phase_fns(W)
        Weff_m = min(W * D, self.M)
        Weff_r = min(W * D, self.R)
        prep = self._prep_fn()
        map_pipe = self._software_pipeline(
            self._map_compute_fn(Weff_m), self._map_commit_fn(Weff_m),
            math.ceil(self.M / Weff_m), Weff_m, self.initial_map_buffers,
        )
        red_compute = self._reduce_compute_fn(Weff_r)
        red_commit = self._reduce_commit_fn(Weff_r)
        groups_r = math.ceil(self.R / Weff_r)
        init_red = self.initial_reduce_buffers

        def phase_map(tokens):
            return map_pipe(*prep(tokens))

        def phase_reduce(pk, pv):
            pipe = self._software_pipeline(
                red_compute, red_commit, groups_r, Weff_r,
                lambda: init_red(pk.shape[1]),
            )
            return pipe(pk, pv)

        fns = {"map": phase_map}
        if self.combiner:
            # Pure per-row work on the committed map buffers, ahead of the
            # shuffle barrier: no commit state of its own.
            fns["combine"] = self._combine_step_fn()
        fns["shuffle"] = self._lexsort_shuffle_fn()
        fns["reduce"] = phase_reduce
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

    @staticmethod
    def _compose(fns: dict):
        def job(tokens):
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
        on the plan's device.  It queues its work without synchronising."""
        return self._compose(self.phase_fns(workers))

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
            lambda: self._compose(self.pipelined_phase_fns(W, D)),
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
        fns = self.pipelined_phase_fns(workers, D)
        m = self.meta(workers)
        pair_bytes = phases.PAIR_BYTES
        app, cfg, dev = self.app, self.cfg, self.device

        def fenced(fn, *args):
            t0, c0 = time.perf_counter(), time.process_time()
            out = fn(*args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return out, time.perf_counter() - t0, time.process_time() - c0

        def job(tokens):
            trace = recorder.start_job(app.name, cfg, m["input_len"])
            try:
                return run(tokens, trace)
            except Exception:
                # A failed run leaves no partial trace behind.
                if trace in recorder.traces:
                    recorder.traces.remove(trace)
                raise

        def run(tokens, trace):
            t_job = time.perf_counter()

            (bk, bv, bp), dt, cpu = fenced(fns["map"], tokens)
            pairs_emitted = int(bp.sum().item())
            trace.record_phase(
                "map", dt,
                tasks=m["mappers"], waves=m["map_waves"],
                records_in=m["input_len"],
                pairs_emitted=pairs_emitted, pairs_capacity=m["n_pairs"],
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
