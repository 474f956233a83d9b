"""Resumable execution: the plan's wave steppers + cursor bookkeeping
(counterpart of ``repro.elastic.resumable``).

:class:`ResumableJob` drives the canonical wave steppers of
:class:`repro_torch.mapreduce.plan.ExecutionPlan`, the ones every other
mode derives from, one wave-boundary step at a time, so a job can stop at
any boundary, snapshot, re-plan its remaining waves under another worker
grant W', and resume bit-identically:

* **map** — one step runs the next W map tasks into the (M, P) task-major
  accumulators; a task's output depends only on its split and the config;
* **combine** — combiner jobs run one W-independent barrier step that
  aggregates and compacts every task row;
* **shuffle** — one barrier step: ``lexsort`` partitions at the canonical
  W-independent capacity (identical overflow accounting under any grant
  history); ``all_to_all`` runs its pack and unpack halves over a worker
  axis around the block transpose, the capacity layout of a real
  W-worker run at the grant held when the barrier executes;
* **reduce** — one step reduces the next W partitions into (R, cap)
  outputs.

A state is a value: the plan's steppers write in place, so each map and
reduce step writes into copies of the accumulators and leaves the state
it was given as it was (the reference's functional updates copy too).
With the ``lexsort`` shuffle the outputs are bit-exact under any sequence
of regrants; with ``all_to_all`` a regrant before the barrier changes the
partition layout but not, with capacity headroom, the collected results.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.elastic.snapshot import ElasticState, JobCursor
from repro_torch.mapreduce import phases
from repro_torch.mapreduce.phases import PAD_KEY
from repro_torch.mapreduce.plan import _NCPU, ExecutionPlan

__all__ = ["ResumableJob", "run_resumable"]


class ResumableJob:
    """One :class:`ExecutionPlan` driven one wave-boundary step at a time.

    ``cfg.num_workers`` is only the initial grant; the live grant rides in
    the cursor and per-grant steppers come from the plan's caches.  The
    optional ``recorder`` (the :class:`repro_torch.telemetry.PhaseRecorder`
    protocol) makes every :meth:`run` call emit one segment trace covering
    exactly the steps that call executed.
    """

    def __init__(self, app, cfg, input_len: int, recorder=None,
                 plan: ExecutionPlan | None = None, device="cuda"):
        self.plan = plan if plan is not None else ExecutionPlan(
            app, cfg, input_len, device=device
        )
        self.app = self.plan.app
        self.cfg = self.plan.cfg
        self.input_len = self.plan.input_len
        self.device = self.plan.device
        self.recorder = recorder
        self.M = self.plan.M
        self.R = self.plan.R
        self.S = self.plan.S
        self.P = self.plan.P

    @classmethod
    def from_plan(cls, plan: ExecutionPlan, recorder=None) -> "ResumableJob":
        """The resumable mode of an existing plan (stepper caches shared
        with every other mode derived from it)."""
        return cls(plan.app, plan.cfg, plan.input_len, recorder=recorder,
                   plan=plan)

    # ------------------------------------------------------------ lifecycle

    def initial_state(self) -> ElasticState:
        cfg = self.cfg
        cursor = JobCursor(
            app=self.app.name, input_len=self.input_len,
            mappers=self.M, reducers=self.R, workers=cfg.num_workers,
            combiner=cfg.combiner, capacity_factor=cfg.capacity_factor,
            setup_rounds=cfg.setup_rounds, setup_dim=cfg.setup_dim,
            reduce_backend=cfg.reduce_backend,
            shuffle_backend=cfg.shuffle_backend,
        )
        bk, bv, bp = self.plan.initial_map_buffers()
        arrays = {"map_keys": bk, "map_vals": bv, "map_valid": bp}
        return ElasticState(cursor=cursor, arrays=arrays)

    def check_cursor(self, cursor: JobCursor) -> None:
        """A cursor must belong to this job (identity fields match)."""
        mine = self.initial_state().cursor
        for f in ("app", "input_len", "mappers", "reducers", "combiner",
                  "capacity_factor", "setup_rounds", "setup_dim",
                  "reduce_backend", "shuffle_backend"):
            if getattr(cursor, f) != getattr(mine, f):
                raise ValueError(
                    f"cursor field {f}={getattr(cursor, f)!r} does not "
                    f"match this job ({getattr(mine, f)!r})"
                )

    def regrant(self, state: ElasticState, workers: int) -> ElasticState:
        """Re-plan the remaining waves under a new grant: a pure cursor
        update, legal at any wave boundary (states exist only there)."""
        if workers < 1:
            raise ValueError("workers must be >= 1")
        return ElasticState(
            cursor=dataclasses.replace(state.cursor, workers=workers),
            arrays=state.arrays,
        )

    # ------------------------------------------------------------- stepping

    def step(self, state: ElasticState, tokens) -> ElasticState:
        """Execute exactly one wave-boundary step (map wave, combine or
        shuffle barrier, reduce wave) under the cursor's current grant."""
        c = state.cursor
        if c.done:
            raise ValueError("job already complete")
        W = c.workers
        plan = self.plan
        arrays = dict(state.arrays)
        if not c.map_done:
            splits, svalid = plan.prep()(tokens)
            bk, bv, bp = plan.map_stepper(W)(
                splits, svalid,
                arrays["map_keys"].clone(), arrays["map_vals"].clone(),
                arrays["map_valid"].clone(), c.map_tasks_done,
            )
            arrays.update(map_keys=bk, map_vals=bv, map_valid=bp)
            cursor = dataclasses.replace(
                c,
                map_tasks_done=min(self.M, c.map_tasks_done + W),
                waves_executed=c.waves_executed + 1,
            )
        elif plan.combiner and not c.combined and not c.shuffled:
            ck, cv, cp = plan.combine_stepper()(
                arrays["map_keys"], arrays["map_vals"], arrays["map_valid"]
            )
            arrays.update(map_keys=ck, map_vals=cv, map_valid=cp)
            cursor = dataclasses.replace(
                c, combined=True, waves_executed=c.waves_executed + 1
            )
        elif not c.shuffled:
            pk, pv, dropped, ok, ov = plan.shuffle_stepper(W)(
                arrays["map_keys"], arrays["map_vals"], arrays["map_valid"]
            )
            # The map accumulators are absorbed into the partitions;
            # dropping them shrinks every post-shuffle snapshot.
            arrays = {
                "part_keys": pk, "part_vals": pv,
                "out_keys": ok, "out_vals": ov,
            }
            cursor = dataclasses.replace(
                c, shuffled=True, partition_cap=int(pk.shape[1]),
                dropped=int(dropped),
                waves_executed=c.waves_executed + 1,
            )
        else:
            ok, ov = plan.reduce_stepper(W, c.partition_cap)(
                arrays["part_keys"], arrays["part_vals"],
                arrays["out_keys"].clone(), arrays["out_vals"].clone(),
                c.reduce_tasks_done,
            )
            arrays.update(out_keys=ok, out_vals=ov)
            cursor = dataclasses.replace(
                c,
                reduce_tasks_done=min(self.R, c.reduce_tasks_done + W),
                waves_executed=c.waves_executed + 1,
            )
        return ElasticState(cursor=cursor, arrays=arrays)

    def run(self, tokens, state: ElasticState | None = None,
            preempt_after: int | None = None) -> ElasticState:
        """Run from ``state`` (or fresh) until done, or until
        ``preempt_after`` steps have executed in this call, leaving a
        wave-boundary state ready to snapshot, regrant and resume.  Each
        step ends in ``torch.cuda.synchronize`` on the card."""
        if state is None:
            state = self.initial_state()
        else:
            self.check_cursor(state.cursor)
        trace = None
        if self.recorder is not None:
            trace = self.recorder.start_job(
                self.app.name, self.cfg, self.input_len
            )
        executed = 0
        t_run = time.perf_counter()
        try:
            while not state.cursor.done and (
                preempt_after is None or executed < preempt_after
            ):
                before = state
                t0, c0 = time.perf_counter(), time.process_time()
                state = self.step(state, tokens)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                cpu = time.process_time() - c0
                dt = time.perf_counter() - t0
                executed += 1
                if trace is not None:
                    self._record_step(trace, before, state, dt, cpu)
        except Exception:
            if trace is not None and trace in self.recorder.traces:
                self.recorder.traces.remove(trace)
            raise
        if trace is not None:
            trace.finish(time.perf_counter() - t_run)
        return state

    def result(self, state: ElasticState):
        """(out_keys (R, cap), out_vals (R, cap), dropped) of a done job."""
        if not state.cursor.done:
            raise ValueError(
                f"job not complete: {state.cursor.steps_remaining()} "
                "steps remain"
            )
        return (
            state.arrays["out_keys"],
            state.arrays["out_vals"],
            torch.tensor(state.cursor.dropped, dtype=torch.int32,
                         device=self.device),
        )

    # ----------------------------------------------------------- telemetry

    def _record_step(self, trace, before: ElasticState, after: ElasticState,
                     wall_s: float, cpu_s: float = 0.0) -> None:
        """One trace phase entry per executed step, counters measured from
        the buffers (the combine's ``pairs_in`` from the pre-step ones)."""
        b, a = before.cursor, after.cursor
        pair_bytes = phases.PAIR_BYTES
        if b.map_tasks_done != a.map_tasks_done:
            lo, hi = b.map_tasks_done, a.map_tasks_done
            trace.record_phase(
                "map", wall_s,
                tasks=hi - lo, waves=1, workers=b.workers,
                pairs_emitted=int(after.arrays["map_valid"][lo:hi].sum()),
                records_in=min(self.input_len, hi * self.S)
                - min(self.input_len, lo * self.S),
                cpu_s=cpu_s, cpu_workers=_NCPU,
            )
        elif b.combined != a.combined:
            pairs_in = int(before.arrays["map_valid"].sum())
            pairs_out = int(after.arrays["map_valid"].sum())
            trace.record_phase(
                "combine", wall_s,
                tasks=self.M, waves=1, workers=b.workers,
                pairs_in=pairs_in, pairs_out=pairs_out,
                bytes_in=pairs_in * pair_bytes,
                bytes_out=pairs_out * pair_bytes,
                combine_capacity=self.plan.combine_cap,
                cpu_s=cpu_s, cpu_workers=_NCPU,
                net_bytes=0.0,  # combining is local: no fabric traffic
            )
        elif b.shuffled != a.shuffled:
            pairs_out = int((after.arrays["part_keys"] != PAD_KEY).sum())
            n_dropped = a.dropped
            pairs_in = pairs_out + n_dropped
            trace.record_phase(
                "shuffle", wall_s,
                pairs_in=pairs_in, pairs_out=pairs_out,
                pairs_dropped=n_dropped,
                bytes_in=pairs_in * pair_bytes,
                bytes_out=pairs_out * pair_bytes,
                bytes_dropped=n_dropped * pair_bytes,
                partitions=self.R, workers=b.workers,
                partition_capacity=a.partition_cap,
                cpu_s=cpu_s, cpu_workers=_NCPU,
                net_bytes=pairs_in * pair_bytes,
                net_s=wall_s,
            )
        else:
            lo, hi = b.reduce_tasks_done, a.reduce_tasks_done
            seg = after.arrays["out_keys"][lo:hi]
            trace.record_phase(
                "reduce", wall_s,
                tasks=hi - lo, waves=1, workers=b.workers,
                segments_out=int((seg != PAD_KEY).sum()),
                cpu_s=cpu_s, cpu_workers=_NCPU,
            )


def run_resumable(job: ResumableJob, tokens,
                  state: ElasticState | None = None,
                  preempt_after: int | None = None) -> ElasticState:
    """Run ``job`` from ``state`` (or fresh), preempting after
    ``preempt_after`` wave-boundary steps: :meth:`ResumableJob.run`."""
    return job.run(tokens, state=state, preempt_after=preempt_after)
