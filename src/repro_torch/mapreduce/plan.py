"""Execution plan, fused mode (counterpart of ``repro.mapreduce.plan``).

:class:`ExecutionPlan` lowers one ``(MapReduceApp, JobConfig, input_len)``
into wave steppers over task-major buffers:

* ``prep(tokens)``                      → ``(splits (M, S), valid (M, S))``
* ``map_step(splits, valid, bk, bv, bp, start)`` → the ``(M, P)``
  accumulators with one wave of W map tasks written in;
* ``combine_step(bk, bv, bp)``          → compacted ``(M, Pc)`` task rows
  (only when ``cfg.combiner``), ``Pc = min(P, key_space)``;
* ``shuffle_step(bk, bv, bp)``          → ``(pk, pv, dropped)`` with
  ``(R, cap)`` partitions, ``cap = partition_capacity(M·Pc, R, f)``;
* ``reduce_step(pk, pv, ok, ov, start)`` → the ``(R, cap)`` outputs with
  one wave of W reduce tasks written in.

:meth:`ExecutionPlan.fused` runs them in order; the waves are Python loops
where the reference uses ``fori_loop``.  The steppers write each wave into
the accumulators in place, where the reference's functional update copies.
The traced, pipelined, sharded and resumable modes are ported by later
slices (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device
from repro_torch.mapreduce import backends as _backends
from repro_torch.mapreduce import phases
from repro_torch.mapreduce.phases import PAD_KEY, run_map_task

__all__ = ["ExecutionPlan"]


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
    stays inside ``rows``.  A final partial wave thus shifts back onto rows
    already processed, which recompute bit-identically (tasks are
    deterministic and row-independent)."""
    return max(0, min(start, rows - W))


class ExecutionPlan:
    """One (app, config, input size) on one device, lowered once."""

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

    def _map_step_fn(self, W: int):
        """Map wave stepper.  ``splits``/``svalid`` come padded to at least
        W rows (see :meth:`phase_fns`); the accumulators hold exactly M."""
        app, cfg, M = self.app, self.cfg, self.M

        def step(splits, svalid, bk, bv, bp, start):
            s = _window(start, splits.shape[0], W)
            k, v, pv = run_map_task(
                app, cfg, splits[s:s + W], svalid[s:s + W]
            )
            n = min(W, M - s)
            bk[s:s + n], bv[s:s + n], bp[s:s + n] = k[:n], v[:n], pv[:n]
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
            return shuffle.partition(
                cfg_w1, bk.reshape(-1), bv.reshape(-1), bp.reshape(-1)
            )

        return step

    def _reduce_step_fn(self, W: int):
        """Reduce wave stepper; ``pk``/``pv`` come padded to at least W rows.
        Same clamped window as the map stepper: reduce backends are
        row-independent, so a shifted final wave rewrites identical rows."""
        cfg, R, op = self.cfg, self.R, self.app.reduce_op
        backend = self.reduce_backend

        def step(pk, pv, ok_buf, ov_buf, start):
            s = _window(start, pk.shape[0], W)
            kblk, vblk = pk[s:s + W], pv[s:s + W]
            ok, ov = backend.reduce(kblk, vblk, op)
            ov = phases._masked_setup(cfg, kblk, ok, ov)
            n = min(W, R - s)
            ok_buf[s:s + n], ov_buf[s:s + n] = ok[:n], ov[:n]
            return ok_buf, ov_buf

        return step

    # ------------------------------------------------- phase compositions

    def phase_fns(self) -> dict:
        """The pipeline as phase functions at W = ``cfg.num_workers``: a wave
        loop each for map and reduce, plus the combine and shuffle barriers."""
        W = self.cfg.num_workers
        prep = self._prep_fn()
        map_step = self._map_step_fn(W)
        shuffle_step = self._lexsort_shuffle_fn()
        reduce_step = self._reduce_step_fn(W)
        map_waves = math.ceil(self.M / W)
        red_waves = math.ceil(self.R / W)
        pad_m, pad_r = max(0, W - self.M), max(0, W - self.R)
        init_map = self.initial_map_buffers
        init_red = self.initial_reduce_buffers

        def phase_map(tokens):
            splits, valid = prep(tokens)
            splits = _pad_rows(splits, pad_m, 0)
            valid = _pad_rows(valid, pad_m, False)
            bufs = init_map()
            for i in range(map_waves):
                bufs = map_step(splits, valid, *bufs, i * W)
            return bufs

        def phase_reduce(pk, pv):
            bufs = init_red(pk.shape[1])
            pk = _pad_rows(pk, pad_r, PAD_KEY)
            pv = _pad_rows(pv, pad_r, 0)
            for i in range(red_waves):
                bufs = reduce_step(pk, pv, *bufs, i * W)
            return bufs

        fns = {"map": phase_map}
        if self.combiner:
            fns["combine"] = self._combine_step_fn()
        fns["shuffle"] = shuffle_step
        fns["reduce"] = phase_reduce
        return fns

    # ---------------------------------------------------------------- modes

    def fused(self):
        """Mode ``fused``: the whole pipeline as one call.  Returns
        ``job(tokens) -> (out_keys (R, cap), out_vals (R, cap), dropped ())``
        on the plan's device.  It queues its work without synchronising."""
        fns = self.phase_fns()

        def job(tokens):
            bufs = fns["map"](tokens)
            if "combine" in fns:
                bufs = fns["combine"](*bufs)
            pk, pv, dropped = fns["shuffle"](*bufs)
            ok, ov = fns["reduce"](pk, pv)
            return ok, ov, dropped

        return job
