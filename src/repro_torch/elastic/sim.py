"""Elastic cluster simulation: preempt / resume / regrant events
(counterpart of ``repro.elastic.sim``).

:class:`ElasticCluster` extends the event-driven simulator with the one
capability the base :class:`~repro_torch.cluster.cluster.Cluster` lacks: a
dispatched job's worker grant is no longer frozen.  A policy may answer a
scheduling event with a :class:`Regrant` action; the simulator applies it
at the job's **next wave boundary** (a job cannot stop mid-wave), charges
the configured snapshot + restore overhead, requantizes the remaining
tasks into waves of the new grant through the oracle's
``remaining_segments``, and reschedules the job's completion.

Mechanics and invariants:

* jobs run as a schedule of wave-boundary segments (from
  ``oracle.remaining_segments``); progress is tracked in task space
  (:class:`~repro_torch.elastic.regrant.WorkProgress`) and advanced lazily;
* a **shrink** releases ``W - W'`` workers at the boundary; a **grow**
  reserves ``W' - W`` from the free pool at request time (so concurrent
  decisions cannot oversubscribe) and applies at the boundary;
* worker conservation — ``free + Σ granted + Σ reserved == total`` — is
  asserted after every mutation, every job completes exactly once, and a
  job's recorded segments tile its [start, finish] interval exactly
  (checkpoint/restore gaps are the only holes, and they are charged to
  ``JobRecord.overhead_s``);
* completed jobs carry a synthesized per-phase :class:`JobTrace` whose
  map/shuffle/reduce walls are summed across *all* executed segments,
  with preemption overhead recorded as a separate ``regrant`` phase — so
  the online per-phase refit loop keeps fitting on interrupted runs;
* a policy that never regrants reproduces the base simulator's schedule
  decision-for-decision (segment walls sum to the same oracle times
  modulo float associativity) — tested in ``tests/test_elastic.py``.

Beyond in-place regrants, two capabilities ride on the same machinery:

* **suspend-to-disk** — ``Regrant(job_id, workers=0)`` snapshots the job
  at its next boundary, releases its *whole* grant, and parks it in a
  suspended queue (:meth:`ElasticCluster.suspended_jobs`); a later
  ``Regrant(job_id, W>=1)`` restores it and re-plans the remaining waves
  under the new grant.  Suspended wall time is accounted as its own
  ``suspended`` trace phase so phase walls still tile the turnaround;
* **measured-overhead scheduling** — when the oracle exposes
  ``regrant_overhead`` (the EngineOracle: a real ``save_snapshot`` /
  ``load_snapshot`` round-trip on the live engine), every preemption is
  charged the *measured* walls instead of the configured estimates, and
  the pair is fed to the policy's ``observe_overhead`` hook so its
  :class:`~repro_torch.elastic.regrant.RegrantCostModel` EWMA tracks real
  checkpoint costs.

Policies discover elastic support via ``cluster.supports_elastic`` and
inspect in-flight work through :meth:`ElasticCluster.running_jobs`, which
exposes only scheduler-observable facts (grants, wave progress, pending
regrants) — never oracle truth about future segment durations.
"""

from __future__ import annotations

import dataclasses
import heapq
import math

from repro_torch.cluster.cluster import (
    Cluster,
    Dispatch,
    JobRecord,
    Reject,
    TraceResult,
    _JobSource,
)
from repro_torch.cluster.workload import JobSpec
from repro_torch.elastic.regrant import WorkProgress


@dataclasses.dataclass(frozen=True)
class Regrant:
    """Policy action: change a running job's grant to ``workers`` at its
    next wave boundary (shrink frees the difference there; grow reserves
    it from the free pool now).

    ``workers=0`` **suspends to disk**: at the boundary the job is
    snapshotted, its whole grant is released, and it leaves the running
    set for the suspended queue (``ElasticCluster.suspended_jobs``).  A
    later ``Regrant(job_id, W>=1)`` addressed at a suspended job restores
    the snapshot and re-plans the remaining waves under the new grant —
    the engine side of this is ``save_snapshot``/``load_snapshot`` +
    ``ResumableJob.regrant``, which the simulator prices.
    """

    job_id: int
    workers: int
    reason: str = ""

    def __post_init__(self):
        if self.workers < 0:
            raise ValueError(f"bad regrant {self}")


@dataclasses.dataclass(frozen=True)
class RunningView:
    """Scheduler-observable state of one running job."""

    job_id: int
    spec: JobSpec
    plan: object                 # the admission Plan (M, R fixed for life)
    workers: int                 # current grant
    pending_workers: int | None  # grant a pending regrant will apply
    shrunk_from: int | None      # pre-shrink grant, if currently shrunk
    progress: WorkProgress
    started: float

    @property
    def steps_remaining(self) -> int:
        return self.progress.steps_remaining(self.workers)


@dataclasses.dataclass(frozen=True)
class SuspendedView:
    """Scheduler-observable state of one suspended-to-disk job."""

    job_id: int
    spec: JobSpec
    plan: object                 # the admission Plan (M, R fixed for life)
    workers_before: int          # grant held when the suspend applied
    progress: WorkProgress
    suspended_at: float


@dataclasses.dataclass
class _Running:
    spec: JobSpec
    rec: JobRecord
    workers: int
    #: remaining wave-boundary segments [(kind, duration), ...]
    segments: list
    seg_start: float             # absolute start time of segments[0]
    m_done: int = 0
    combined: bool = False       # combine barrier passed (combiner jobs)
    shuffled: bool = False
    r_done: int = 0
    pending: tuple[int, float] | None = None   # (new_W, boundary time)
    reserved: int = 0            # grow workers held from the free pool
    shrunk_from: int | None = None
    epoch: int = 0               # invalidates stale heap events
    phase_wall: dict = dataclasses.field(default_factory=dict)
    # Suspend-to-disk bookkeeping (set while the job sits in _suspended).
    suspended_at: float | None = None
    workers_at_suspend: int = 0
    save_charged: float = 0.0    # snapshot wall charged at suspend time
    pending_restore_s: float = 0.0

    def progress(self) -> WorkProgress:
        return WorkProgress(
            mappers=self.rec.plan.mappers,
            reducers=self.rec.plan.reducers,
            map_tasks_done=self.m_done,
            shuffled=self.shuffled,
            reduce_tasks_done=self.r_done,
            combine_steps=(
                1 if getattr(self.rec.plan, "combiner", False) else 0
            ),
            combined=self.combined,
        )

    def advance(self, t: float) -> None:
        """Consume segments ending at or before ``t`` (progress + walls)."""
        M = self.rec.plan.mappers
        R = self.rec.plan.reducers
        while self.segments:
            kind, dur = self.segments[0]
            start = self.seg_start
            end = start + dur
            if end > t:
                break
            self.segments.pop(0)
            self.seg_start = end
            self.phase_wall[kind] = self.phase_wall.get(kind, 0.0) + dur
            # Wave log for the span exporter: each consumed segment is one
            # executed wave; boundaries reuse the exact event-time floats,
            # so waves tile their execution segment with no slack.
            if self.rec.waves is not None:
                self.rec.waves.append([start, end, kind, self.workers])
            if kind == "map":
                self.m_done = min(M, self.m_done + self.workers)
            elif kind == "combine":
                self.combined = True
            elif kind == "shuffle":
                self.shuffled = True
            else:
                self.r_done = min(R, self.r_done + self.workers)

    def finish_time(self) -> float:
        t = self.seg_start
        for _, dur in self.segments:
            t += dur
        return t

    def next_boundary(self) -> float:
        return self.seg_start + self.segments[0][1]


class ElasticCluster(Cluster):
    """The event-driven simulator, with regrantable worker grants."""

    supports_elastic = True

    def __init__(
        self,
        total_workers: int,
        oracle,
        *,
        snapshot_overhead_s: float = 0.02,
        restore_overhead_s: float = 0.02,
        metrics=None,
    ):
        super().__init__(total_workers, oracle, metrics=metrics)
        if not hasattr(oracle, "remaining_segments"):
            raise TypeError(
                f"{type(oracle).__name__} cannot price partial execution; "
                "ElasticCluster needs oracle.remaining_segments"
            )
        if snapshot_overhead_s < 0 or restore_overhead_s < 0:
            raise ValueError("overheads must be >= 0")
        self.snapshot_overhead_s = float(snapshot_overhead_s)
        self.restore_overhead_s = float(restore_overhead_s)
        #: measured-overhead scheduling: an oracle exposing
        #: ``regrant_overhead`` (EngineOracle: a real save/load snapshot
        #: round-trip) prices each preemption with *measured* walls; the
        #: configured costs above are the fallback (AnalyticOracle).
        self._measure_overhead = getattr(oracle, "regrant_overhead", None)

    def _regrant_overheads(self, rj: "_Running") -> tuple[float, float]:
        """(save_s, restore_s) for preempting ``rj`` now — measured from
        the engine when the oracle can, configured otherwise."""
        if self._measure_overhead is None:
            return self.snapshot_overhead_s, self.restore_overhead_s
        rec = rj.rec
        save_s, restore_s = self._measure_overhead(
            rj.spec.app, rec.plan.backend, rj.spec.size,
            rec.plan.mappers, rec.plan.reducers,
            map_tasks_done=rj.m_done, shuffled=rj.shuffled,
            reduce_tasks_done=rj.r_done,
            **self._combine_kwargs(rec.plan),
        )
        return float(save_s), float(restore_s)

    @staticmethod
    def _combine_kwargs(plan, rj: "_Running | None" = None) -> dict:
        """Combiner kwargs for oracle calls — only when the plan turns
        the combiner on, so combiner-unaware oracles keep working."""
        if not getattr(plan, "combiner", False):
            return {}
        extra = {"combiner": True}
        if rj is not None:
            extra["combined"] = rj.combined
        return extra

    @staticmethod
    def _notify_overhead(policy, save_s: float, restore_s: float) -> None:
        """Feed one (snapshot, restore) wall pair to the policy's cost
        model (``observe_overhead`` is optional — see
        :meth:`repro_torch.elastic.regrant.RegrantCostModel.record_overhead`)."""
        hook = getattr(policy, "observe_overhead", None)
        if hook is not None:
            hook(save_s, restore_s)

    # ------------------------------------------------------------- queries

    def suspended_jobs(self, now: float | None = None,
                       ) -> tuple[SuspendedView, ...]:
        """Jobs currently suspended to disk (grant 0), oldest first."""
        views = [
            SuspendedView(
                job_id=rj.spec.job_id,
                spec=rj.spec,
                plan=rj.rec.plan,
                workers_before=rj.workers_at_suspend,
                progress=rj.progress(),
                suspended_at=rj.suspended_at,
            )
            for rj in self._suspended.values()
        ]
        return tuple(sorted(views, key=lambda v: v.suspended_at))

    def running_jobs(self, now: float) -> tuple[RunningView, ...]:
        views = []
        for rj in self._running.values():
            rj.advance(now)
            views.append(RunningView(
                job_id=rj.spec.job_id,
                spec=rj.spec,
                plan=rj.rec.plan,
                workers=rj.workers,
                pending_workers=rj.pending[0] if rj.pending else None,
                shrunk_from=rj.shrunk_from,
                progress=rj.progress(),
                started=rj.rec.start,
            ))
        return tuple(views)

    # ----------------------------------------------------------- invariant

    def _check_conservation(self) -> None:
        granted = sum(rj.workers for rj in self._running.values())
        reserved = sum(rj.reserved for rj in self._running.values())
        if self._free < 0 or (
            self._free + granted + reserved != self.total_workers
        ):
            raise AssertionError(
                f"worker accounting broken: free={self._free} "
                f"granted={granted} reserved={reserved} "
                f"total={self.total_workers}"
            )

    # ------------------------------------------------------------ the loop

    def run(self, jobs: list[JobSpec], policy) -> TraceResult:
        jobs = sorted(jobs, key=lambda j: (j.arrival, j.job_id))
        if len({j.job_id for j in jobs}) != len(jobs):
            raise ValueError("duplicate job_id in trace")
        return self._run(jobs, policy, sorted({j.app for j in jobs}))

    def _run(
        self, jobs, policy, apps, *, health_every=None, on_health=None
    ) -> TraceResult:
        source = _JobSource(jobs)
        records: dict[int, JobRecord] = {}
        order: list[int] = []
        pending: list[JobSpec] = []
        self._running: dict[int, _Running] = {}
        self._suspended: dict[int, _Running] = {}
        self._free = self.total_workers
        #: event heap: (time, seq, kind, job_id, epoch)
        self._events: list[tuple[float, int, str, int, int]] = []
        self._seq = 0
        policy.prepare(self, apps)
        first = source.peek()
        now = first.arrival if first is not None else 0.0
        next_health = (
            now + health_every if health_every is not None else None
        )
        stalled = False  # nothing scheduled, but suspended/pending remain
        if self.metrics is not None:
            self.metrics.on_run_start(now)

        while (
            source.peek() is not None or pending
            or self._running or self._suspended
        ):
            nxt = source.peek()
            next_arrival = nxt.arrival if nxt is not None else math.inf
            next_event = self._events[0][0] if self._events else math.inf
            if (
                (pending or self._suspended) and not self._running
                and next_arrival == math.inf and next_event == math.inf
            ):
                # No arrival or event will ever come.  Give the policy
                # one last pass at the current time (it may resume a
                # suspended job or dispatch into the now-free pool);
                # a second stalled pass means it never will.
                if stalled:
                    stuck = sorted(
                        [j.job_id for j in pending]
                        + list(self._suspended)
                    )
                    raise RuntimeError(
                        f"policy {policy.name!r} stranded jobs {stuck}: "
                        f"no dispatch at free={self._free}/"
                        f"{self.total_workers} workers"
                        + (
                            f" ({sorted(self._suspended)} suspended to "
                            "disk and never resumed)"
                            if self._suspended else ""
                        )
                    )
                stalled = True
            else:
                stalled = False
                now = min(next_arrival, next_event)

            while (nxt := source.peek()) is not None and nxt.arrival <= now:
                job = source.pop()
                records[job.job_id] = JobRecord(spec=job)
                order.append(job.job_id)
                pending.append(job)
                if self.metrics is not None:
                    self.metrics.on_arrival(job.arrival, job)
            while self._events and self._events[0][0] <= now:
                t, _, kind, job_id, epoch = heapq.heappop(self._events)
                rj = self._running.get(job_id)
                if rj is None or rj.epoch != epoch:
                    continue    # stale (superseded by a regrant)
                if kind == "finish":
                    self._complete(rj, t, policy)
                else:
                    self._apply_regrant(rj, t, policy)

            while pending:
                decision = policy.select(tuple(pending), self._free, now)
                if decision is None:
                    break
                if isinstance(decision, Reject):
                    rec = records[decision.job.job_id]
                    rec.admitted = False
                    rec.reject_reason = decision.reason
                    rec.reject_time = now
                    pending.remove(decision.job)
                    if self.metrics is not None:
                        self.metrics.on_reject(now, rec)
                    continue
                if isinstance(decision, Regrant):
                    self._request_regrant(decision, now)
                    continue
                if not isinstance(decision, Dispatch):
                    raise TypeError(
                        f"policy returned {type(decision).__name__}; "
                        "expected Dispatch, Reject, Regrant, or None"
                    )
                job, plan = decision.job, decision.plan
                if job not in pending:
                    raise ValueError(
                        f"policy dispatched job {job.job_id} not in queue"
                    )
                if plan.workers > self._free:
                    raise ValueError(
                        f"plan for job {job.job_id} wants {plan.workers} "
                        f"workers but only {self._free} are free"
                    )
                pending.remove(job)
                self._dispatch(records[job.job_id], job, plan, now)

            # The dispatch loop above only runs while jobs are queued,
            # but elastic moves are also warranted on an *empty* queue —
            # canonically a regrow right after the last queued job left.
            # Elastic-aware policies expose them via ``idle``.
            idle = getattr(policy, "idle", None)
            if idle is not None:
                while True:
                    action = idle(self._free, now)
                    if action is None:
                        break
                    if not isinstance(action, Regrant):
                        raise TypeError(
                            f"policy idle() returned "
                            f"{type(action).__name__}; expected Regrant "
                            "or None"
                        )
                    self._request_regrant(action, now)
            if self.metrics is not None:
                self.metrics.sample(
                    now, len(pending), self.total_workers - self._free,
                    len(self._suspended),
                )
            if next_health is not None and now >= next_health:
                if on_health is not None:
                    on_health(
                        now,
                        self._health_snapshot(
                            now, pending, self._free, len(self._suspended)
                        ),
                    )
                while next_health <= now:
                    next_health += health_every

        if self._free != self.total_workers:
            raise AssertionError("worker accounting leaked")
        return TraceResult(
            policy=policy.name,
            total_workers=self.total_workers,
            records=[records[job_id] for job_id in order],
        )

    # ------------------------------------------------------------- actions

    def _push(self, t: float, kind: str, job_id: int, epoch: int) -> None:
        self._seq += 1
        heapq.heappush(self._events, (t, self._seq, kind, job_id, epoch))

    def _dispatch(self, rec: JobRecord, job: JobSpec, plan, now: float,
                  ) -> None:
        rec.plan = plan
        rec.start = now
        rec.segments = [[now, None, plan.workers]]
        rec.waves = []
        rec.gaps = []
        segments = [
            list(seg) for seg in self.oracle.remaining_segments(
                job.app, plan.backend, job.size,
                plan.mappers, plan.reducers, plan.workers,
                job_id=job.job_id,
                **self._combine_kwargs(plan),
            )
        ]
        rj = _Running(
            spec=job, rec=rec, workers=plan.workers,
            segments=segments, seg_start=now,
        )
        self._running[job.job_id] = rj
        self._free -= plan.workers
        self._push(rj.finish_time(), "finish", job.job_id, rj.epoch)
        if self.metrics is not None:
            self.metrics.on_dispatch(now, rec)
        self._check_conservation()

    def _request_regrant(self, action: Regrant, now: float) -> None:
        rj = self._running.get(action.job_id)
        if rj is None:
            srj = self._suspended.get(action.job_id)
            if srj is not None:
                self._resume(srj, action, now)
                return
            raise ValueError(
                f"regrant for job {action.job_id}, which is not running"
            )
        if rj.pending is not None:
            raise ValueError(
                f"job {action.job_id} already has a pending regrant"
            )
        if action.workers == rj.workers:
            raise ValueError(
                f"regrant to the current grant ({rj.workers}) is a no-op"
            )
        rj.advance(now)
        if len(rj.segments) <= 1:
            raise ValueError(
                f"job {action.job_id} is in its final wave; a regrant "
                "could never take effect (check steps_remaining first)"
            )
        delta = action.workers - rj.workers
        if delta > 0:
            if delta > self._free:
                raise ValueError(
                    f"grow of job {action.job_id} wants {delta} more "
                    f"workers but only {self._free} are free"
                )
            self._free -= delta
            rj.reserved = delta
        boundary = rj.next_boundary()
        rj.pending = (action.workers, boundary)
        self._push(boundary, "regrant", action.job_id, rj.epoch)
        self._check_conservation()

    def _apply_regrant(self, rj: _Running, t: float, policy) -> None:
        rj.advance(t)
        new_w, _ = rj.pending
        rj.pending = None
        old_w = rj.workers
        save_s, restore_s = self._regrant_overheads(rj)
        self._notify_overhead(policy, save_s, restore_s)
        if new_w == 0:
            self._suspend(rj, t, old_w, save_s, restore_s)
            return
        overhead = save_s + restore_s
        resume_t = t + overhead
        if new_w < old_w:
            self._free += old_w - new_w
            rj.shrunk_from = (
                rj.shrunk_from if rj.shrunk_from is not None else old_w
            )
        else:
            rj.reserved = 0
            if rj.shrunk_from is not None and new_w >= rj.shrunk_from:
                rj.shrunk_from = None
        rj.workers = new_w
        rj.epoch += 1
        rec = rj.rec
        rec.segments[-1][1] = t
        rec.segments.append([resume_t, None, new_w])
        if rec.gaps is not None and resume_t > t:
            # The snapshot/restore hole between segments: workers held
            # (the post-regrant grant) but no waves execute.
            rec.gaps.append([t, resume_t, "regrant", new_w])
        rec.n_regrants += 1
        rec.overhead_s += overhead
        rj.phase_wall["regrant"] = (
            rj.phase_wall.get("regrant", 0.0) + overhead
        )
        if self.metrics is not None:
            self.metrics.on_regrant(
                t, "shrink" if new_w < old_w else "grow", overhead
            )
        rj.segments = [
            list(seg) for seg in self.oracle.remaining_segments(
                rj.spec.app, rec.plan.backend, rj.spec.size,
                rec.plan.mappers, rec.plan.reducers, new_w,
                map_tasks_done=rj.m_done, shuffled=rj.shuffled,
                reduce_tasks_done=rj.r_done,
                job_id=rj.spec.job_id,
                **self._combine_kwargs(rec.plan, rj),
            )
        ]
        if not rj.segments:
            raise AssertionError(
                "regrant applied at a boundary with no remaining work"
            )
        rj.seg_start = resume_t
        self._push(rj.finish_time(), "finish", rj.spec.job_id, rj.epoch)
        self._check_conservation()

    # ------------------------------------------------- suspend-to-disk

    def _suspend(self, rj: _Running, t: float, old_w: int,
                 save_s: float, restore_s: float) -> None:
        """Apply a grant-0 regrant at a boundary: snapshot (charge
        ``save_s``), release the whole grant, move the job to the
        suspended queue.  No segments are scheduled until a resume
        re-plans the remaining waves."""
        del self._running[rj.spec.job_id]
        self._free += old_w
        rec = rj.rec
        rec.segments[-1][1] = t
        rec.n_regrants += 1
        rec.n_suspends += 1
        rec.overhead_s += save_s
        rj.phase_wall["regrant"] = (
            rj.phase_wall.get("regrant", 0.0) + save_s
        )
        rj.epoch += 1            # invalidate the stale finish event
        rj.workers = 0
        rj.reserved = 0
        rj.suspended_at = t
        rj.workers_at_suspend = old_w
        rj.save_charged = save_s
        rj.pending_restore_s = restore_s
        rj.segments = []
        self._suspended[rj.spec.job_id] = rj
        if self.metrics is not None:
            self.metrics.on_regrant(t, "suspend", save_s)
            self.metrics.on_suspend(t, save_s)
        self._check_conservation()

    def _resume(self, rj: _Running, action: Regrant, now: float) -> None:
        """Restore a suspended job under ``action.workers`` (charge the
        restore wall), re-plan its remaining waves, reschedule."""
        W = action.workers
        if W < 1:
            raise ValueError(
                f"job {action.job_id} is already suspended; resume it "
                "with workers >= 1"
            )
        if W > self._free:
            raise ValueError(
                f"resume of job {action.job_id} wants {W} workers but "
                f"only {self._free} are free"
            )
        restore_s = rj.pending_restore_s
        resume_t = now + restore_s
        del self._suspended[rj.spec.job_id]
        self._free -= W
        rec = rj.rec
        rec.n_regrants += 1
        rec.overhead_s += restore_s
        rec.segments.append([resume_t, None, W])
        if rec.gaps is not None:
            # Tile the suspend hole: snapshot (no workers), disk wait
            # (no workers), restore (the resume grant) — contiguous with
            # the surrounding execution segments.
            save_end = min(now, rj.suspended_at + rj.save_charged)
            if save_end > rj.suspended_at:
                rec.gaps.append(
                    [rj.suspended_at, save_end, "regrant", 0]
                )
            if now > save_end:
                rec.gaps.append([save_end, now, "suspended", 0])
            if resume_t > now:
                rec.gaps.append([now, resume_t, "regrant", W])
        rj.phase_wall["regrant"] = (
            rj.phase_wall.get("regrant", 0.0) + restore_s
        )
        # Disk-queued wall: the gap between suspend and resume that is
        # not checkpoint overhead (keeps phase walls tiling the
        # turnaround for the synthesized trace).
        rj.phase_wall["suspended"] = rj.phase_wall.get(
            "suspended", 0.0
        ) + max(0.0, now - rj.suspended_at - rj.save_charged)
        if rj.shrunk_from is None and W < rj.workers_at_suspend:
            rj.shrunk_from = rj.workers_at_suspend
        elif rj.shrunk_from is not None and W >= rj.shrunk_from:
            rj.shrunk_from = None
        rj.workers = W
        rj.suspended_at = None
        rj.save_charged = 0.0
        rj.pending_restore_s = 0.0
        rj.epoch += 1
        rj.segments = [
            list(seg) for seg in self.oracle.remaining_segments(
                rj.spec.app, rec.plan.backend, rj.spec.size,
                rec.plan.mappers, rec.plan.reducers, W,
                map_tasks_done=rj.m_done, shuffled=rj.shuffled,
                reduce_tasks_done=rj.r_done,
                job_id=rj.spec.job_id,
                **self._combine_kwargs(rec.plan, rj),
            )
        ]
        if not rj.segments:
            raise AssertionError(
                "resume applied with no remaining work"
            )
        rj.seg_start = resume_t
        self._running[rj.spec.job_id] = rj
        self._push(rj.finish_time(), "finish", rj.spec.job_id, rj.epoch)
        if self.metrics is not None:
            self.metrics.on_regrant(now, "resume", restore_s)
            self.metrics.on_resume(now, restore_s)
        self._check_conservation()

    def _complete(self, rj: _Running, t: float, policy) -> None:
        rj.advance(t)
        if rj.segments or not rj.progress().done:
            raise AssertionError(
                f"job {rj.spec.job_id} completed with work remaining"
            )
        del self._running[rj.spec.job_id]
        self._free += rj.workers
        rec = rj.rec
        rec.finish = t
        rec.true_time = t - rec.start
        rec.segments[-1][1] = t
        rec.trace = self._synthesize_trace(rj)
        if self.metrics is not None:
            self.metrics.on_finish(t, rec)
        policy.observe(rec)
        self._check_conservation()

    # ----------------------------------------------------------- telemetry

    def _synthesize_trace(self, rj: _Running):
        """Segment-summed per-phase trace of one (possibly interrupted)
        job, in the engine's JobTrace shape — preemption overhead is its
        own ``regrant`` phase so phase walls still sum to the turnaround."""
        from repro_torch.telemetry.trace import JobTrace

        rec = rj.rec
        trace = JobTrace(
            app=rj.spec.app,
            config={
                "num_mappers": rec.plan.mappers,
                "num_reducers": rec.plan.reducers,
                "num_workers": rec.plan.workers,
                "final_workers": rj.workers,
                "reduce_backend": rec.plan.backend,
                "input_len": int(rj.spec.size),
                "n_regrants": rec.n_regrants,
                "segments": [list(s) for s in rec.segments],
            },
        )
        counters = {
            "map": {"tasks": rec.plan.mappers},
            "combine": {"tasks": rec.plan.mappers},
            "shuffle": {"partitions": rec.plan.reducers},
            "reduce": {"tasks": rec.plan.reducers},
            "regrant": {"events": rec.n_regrants},
            "suspended": {"events": rec.n_suspends},
        }
        for kind in (
            "map", "combine", "shuffle", "reduce", "regrant", "suspended"
        ):
            wall = rj.phase_wall.get(kind)
            if wall:
                trace.record_phase(kind, wall, **counters[kind])
        trace.finish(rec.true_time)
        return trace
